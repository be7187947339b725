"""The resident planners' programs (ROADMAP B9) on the CUDA card against
their CPU runs.

This file imports no JAX, so the card's machine runs it
(``python -m pytest --noconftest -m gpu tests/test_torch_planner_card.py``).
Every test needs the card and skips without one:

- ``_quota_program`` on seeded tenants and quotas, bit-equal;
- ``_without_program`` with padding rows and two victims on one node,
  ``_overlay_ct_program`` and ``_overlay_mask_program``, bit-equal;
- ``_plan_mask_program``: masks bit-equal, scores within ``ATOL``
  (``tests/test_torch_ops.py``'s tolerance), with and without the
  descheduler's ``REPLACEMENT_FILTERS``;
- ``with_hypothetical`` on the card's tensors equals the host path;
- ``chip_smoke.planner_parity_phase``: the four planners' plans on the card
  equal the CPU's, resident equal to cold on each.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from kubernetes_tpu_torch.descheduler.planner import REPLACEMENT_FILTERS
from kubernetes_tpu_torch.encode import overlay
from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
from kubernetes_tpu_torch.testing.workloads import relational_mix

pytestmark = pytest.mark.gpu

ATOL = 1e-4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _cluster(seed=3):
    nodes, bound, pending, ns_labels = relational_mix(pods=40, nodes=24,
                                                      seed=seed)
    enc = SnapshotEncoder()
    enc.set_namespaces(ns_labels)
    ct, meta = enc.encode_cluster(nodes, bound, pending_pods=pending,
                                  pending_slots=False)
    return enc, ct, meta, nodes, bound, pending


def _templates(nodes, k=3):
    import dataclasses
    out = []
    for i in range(k):
        n = nodes[i]
        md = dataclasses.replace(n.metadata, name=f"tmpl-{i}",
                                 labels=dict(n.metadata.labels))
        out.append(dataclasses.replace(n, metadata=md))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_quota_program_on_the_card(seed):
    _card()
    rng = np.random.default_rng(seed)
    V, T = [(4, 1), (64, 4), (256, 8), (1024, 16)][seed]
    vt = torch.from_numpy(rng.integers(-1, T, V).astype(np.int32))
    q = torch.from_numpy(rng.integers(-1, 5, T).astype(np.int32))
    want = overlay._quota_program(vt, q)
    got = overlay._quota_program(vt.cuda(), q.cuda())
    assert torch.equal(got.cpu(), want)


def test_without_program_on_the_card():
    _card()
    enc, ct, _meta, _nodes, bound, _pending = _cluster()
    keys = chip_smoke._two_on_one_node(enc, bound)
    st = enc._patch
    B, E = 8, ct.epod_valid.shape[0]
    N, R = ct.requested.shape
    slot_rows = np.full(B, E, np.int32)
    node_rows = np.full(B, N, np.int32)
    req_delta = np.zeros((B, R), np.int32)
    for i, k in enumerate(keys):
        slot_rows[i] = st.slot_of[k]
        node_rows[i] = st.slot_node[k]
        req_delta[i] = st.slot_req[k]
    req_delta[5] = 7
    outs = [overlay._without_program(
        ct.to(d), *(torch.from_numpy(a).to(d)
                    for a in (slot_rows, node_rows, req_delta)))
        for d in ("cuda", "cpu")]
    for f in ("requested", "epod_valid"):
        assert torch.equal(getattr(outs[0], f).cpu(), getattr(outs[1], f))


def test_overlay_programs_on_the_card():
    _card()
    enc, ct, meta, nodes, _bound, pending = _cluster()
    planes = overlay._template_planes(enc, meta.resources, ct,
                                      _templates(nodes))
    pb = enc.encode_pods(pending, meta)
    cts = [overlay._overlay_ct_program(ct.to(d), overlay._planes_to(planes,
                                                                   d))
           for d in ("cuda", "cpu")]
    for f in overlay._NODE_AXIS_FIELDS + ("label_value_num", "image_sizes"):
        a, b = getattr(cts[0], f).cpu(), getattr(cts[1], f)
        assert a.dtype == b.dtype and torch.equal(a.nan_to_num(-7),
                                                  b.nan_to_num(-7)), f
    masks = [overlay._overlay_mask_program(
        ct.to(d), overlay._planes_to(planes, d), pb.to(d))
        for d in ("cuda", "cpu")]
    assert torch.equal(masks[0].cpu(), masks[1])


@pytest.mark.parametrize("enabled", [None, REPLACEMENT_FILTERS],
                         ids=["all", "replacement"])
def test_plan_mask_program_on_the_card(enabled):
    _card()
    enc, ct, meta, _nodes, _bound, pending = _cluster()
    pb = enc.encode_pods(pending, meta)
    lvn, isz = overlay._fresh_tables(enc, ct.label_value_num.shape[0],
                                     ct.image_sizes.shape[0])
    outs = [overlay._plan_mask_program(
        ct.to(d), pb.to(d), torch.from_numpy(lvn).to(d),
        torch.from_numpy(isz).to(d), enabled, True)
        for d in ("cuda", "cpu")]
    (gm, gs), (wm, ws) = outs
    assert torch.equal(gm.cpu(), wm)
    gs, ws = gs.cpu().numpy(), ws.numpy()
    np.testing.assert_array_equal(np.isfinite(gs), np.isfinite(ws))
    fin = np.isfinite(ws)
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=0, atol=ATOL)


def test_with_hypothetical_on_the_card():
    _card()
    enc, ct, meta, nodes, _bound, _pending = _cluster()
    tmpl = _templates(nodes)
    got, rows = enc.with_hypothetical(ct.to("cuda"), meta, tmpl)
    assert got.node_valid.is_cuda
    host, host_rows = enc.with_hypothetical(ct, meta, tmpl)
    assert rows == host_rows
    n = ct.node_valid.shape[0] + len(tmpl)
    for f in overlay._NODE_AXIS_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).cpu().numpy()[:n],
                                      np.asarray(getattr(host, f))[:n],
                                      err_msg=f)


def test_planner_parity_card_vs_cpu():
    _card()
    out = chip_smoke.planner_parity_phase(devices=("cuda", "cpu"))
    assert out["seeds"] == [0, 1, 2]
