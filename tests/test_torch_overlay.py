"""The port's planner programs (ROADMAP B9, ``encode/overlay.py``) against
the JAX package's jitted ones, on the CPU.

The JAX package encodes one cluster (``relational_mix``) and
``from_reference`` carries the encoding across, so both packages' programs
see the same arrays:

- ``_quota_program`` / ``tenant_quota_mask`` on seeded tenants and quotas
  (-1 tenants, -1 quotas, padding), bit-equal;
- ``_without_program`` with out-of-range padding rows and two victims on
  one node (both must subtract), bit-equal; ``without_pods`` through the
  host path, the tensor path and the reference's;
- ``_overlay_ct_program`` (every node-axis field appended) and
  ``_overlay_mask_program``, masks bit-equal; ``_template_planes`` equal;
  ``with_hypothetical`` on the host, on tensors, and with a template
  that overflows a bucket (the host path answers, tensors raise);
- ``_plan_mask_program`` with and without scores, with every filter and
  with the descheduler's ``REPLACEMENT_FILTERS``, on an encoding with
  nominees (the program zeroes ``nom_valid``): masks bit-equal, scores
  within ``ATOL`` (``tests/test_torch_ops.py``'s tolerance, rtol 0);
- the ``CompileCounter``: first-seen shapes and ``nvcc`` builds inside an
  armed window, nothing outside it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from kubernetes_tpu.api.types import Node as RefNode, Pod as RefPod
from kubernetes_tpu.descheduler.planner import (
    REPLACEMENT_FILTERS as REF_REPLACEMENT)
from kubernetes_tpu.encode import overlay as ref_overlay
from kubernetes_tpu.encode.snapshot import SnapshotEncoder as RefEncoder
from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.descheduler.planner import REPLACEMENT_FILTERS
from kubernetes_tpu_torch.encode import overlay
from kubernetes_tpu_torch.encode.convert import from_reference
from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
from kubernetes_tpu_torch.ops import kernels
from kubernetes_tpu_torch.testing.workloads import relational_mix

# tests/test_torch_ops.py's score tolerance (fp32 summation order only)
ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _flat(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _flat(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return np.asarray(x)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _assert_fields_equal(port_ct, ref_ct, fields=None):
    names = fields or [f.name for f in dataclasses.fields(port_ct)]
    for name in names:
        a, b = getattr(port_ct, name), getattr(ref_ct, name)
        if dataclasses.is_dataclass(a):
            _assert_fields_equal(a, b)
            continue
        a, b = _np(a), np.asarray(b)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.fixture(scope="module")
def cluster():
    nodes, bound, pending, ns_labels = relational_mix(pods=40, nodes=24,
                                                      seed=3)
    node_dicts = [n.to_dict() for n in nodes]
    bound_dicts = [p.to_dict() for p in bound]
    pend_dicts = [p.to_dict() for p in pending]

    def encode(enc_cls, node_cls, pod_cls):
        enc = enc_cls()
        enc.set_namespaces(ns_labels)
        ns = [node_cls.from_dict(d) for d in node_dicts]
        bs = [pod_cls.from_dict(d) for d in bound_dicts]
        ps = [pod_cls.from_dict(d) for d in pend_dicts]
        ct, meta = enc.encode_cluster(ns, bs, pending_pods=ps,
                                      pending_slots=False)
        return enc, ct, meta, ns, bs, ps

    ref = encode(RefEncoder, RefNode, RefPod)
    port = encode(SnapshotEncoder, Node, Pod)
    return {"ref": ref, "port": port, "node_dicts": node_dicts,
            "bound_dicts": bound_dicts}


def _templates(node_dicts, node_cls, k=3):
    """Template nodes carrying only label keys the cluster's nodes carry
    (the resident bucket keeps them), plus a taint."""
    out = []
    for i in range(k):
        d = dict(node_dicts[i])
        md = dict(d["metadata"])
        md["name"] = f"tmpl-{i}"
        md["labels"] = dict(md.get("labels") or {})
        d["metadata"] = md
        spec = dict(d.get("spec") or {})
        if i == 1:
            spec["taints"] = [{"key": "dedicated", "value": "infra",
                               "effect": "NoSchedule"}]
        d["spec"] = spec
        out.append(node_cls.from_dict(d))
    return out


# ---------------------------------------------------------------- quota

@pytest.mark.parametrize("seed", range(6))
def test_quota_program_bit_equal(seed):
    rng = np.random.default_rng(seed)
    V = [1, 4, 16, 64, 128, 256][seed]
    T = [1, 2, 4, 4, 8, 16][seed]
    vt = rng.integers(-1, T, V).astype(np.int32)
    q = rng.integers(-1, 5, T).astype(np.int32)
    want = np.asarray(ref_overlay._quota_program(vt, q))
    got = overlay._quota_program(torch.from_numpy(vt), torch.from_numpy(q))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    ids = list(vt[:V - 1 if V > 1 else V])
    quotas = list(q[:max(T - 1, 1)])
    np.testing.assert_array_equal(
        overlay.tenant_quota_mask(ids, quotas, device="cpu"),
        ref_overlay.tenant_quota_mask(ids, quotas))


def test_tenant_quota_mask_ranks():
    allowed = overlay.tenant_quota_mask([0, 0, 1, -1, 0], [2, 1],
                                        device="cpu")
    assert allowed.tolist() == [True, True, True, True, False]
    assert overlay.tenant_quota_mask([0, 0, 0], [-1],
                                     device="cpu").tolist() == [True] * 3


# --------------------------------------------------------- without_pods

def test_without_program_padding_and_shared_node(cluster):
    renc, rct, _meta, _ns, rbs, _ps = cluster["ref"]
    keys = chip_smoke._two_on_one_node(renc, rbs)
    st = renc._patch
    assert st.slot_node[keys[0]] == st.slot_node[keys[1]]
    B = 8   # 3 victims, 5 padding rows with out-of-range indices
    E = rct.epod_valid.shape[0]
    N, R = rct.requested.shape
    slot_rows = np.full(B, E, np.int32)
    node_rows = np.full(B, N, np.int32)
    req_delta = np.zeros((B, R), np.int32)
    for i, k in enumerate(keys):
        slot_rows[i] = st.slot_of[k]
        node_rows[i] = st.slot_node[k]
        req_delta[i] = st.slot_req[k]
    req_delta[5] = 7       # a padding row's delta must never land
    want = ref_overlay._without_program(rct, slot_rows, node_rows, req_delta)
    pct = from_reference(_flat(rct), "cpu")
    before = pct.requested.clone()
    got = overlay._without_program(pct, torch.from_numpy(slot_rows),
                                   torch.from_numpy(node_rows),
                                   torch.from_numpy(req_delta))
    _assert_fields_equal(got, want, ["requested", "epod_valid"])
    # the resident tensors are never written
    assert torch.equal(pct.requested, before)
    # both victims on the shared node subtract
    row = st.slot_node[keys[0]]
    np.testing.assert_array_equal(
        got.requested[row].numpy(),
        rct.requested[row] - st.slot_req[keys[0]] - st.slot_req[keys[1]])


def test_without_pods_host_and_tensor_paths(cluster):
    renc, rct, rmeta, _ns, rbs, _ps = cluster["ref"]
    penc, pct, pmeta, _ns2, pbs, _ps2 = cluster["port"]
    keys = chip_smoke._two_on_one_node(renc, rbs)
    assert keys == chip_smoke._two_on_one_node(penc, pbs)
    want = renc.without_pods(rct, rmeta, keys)
    host = penc.without_pods(pct, pmeta, keys)
    _assert_fields_equal(host, want, ["requested", "epod_valid"])
    on_tensors = penc.without_pods(pct.to("cpu"), pmeta, keys)
    assert isinstance(on_tensors.requested, torch.Tensor)
    _assert_fields_equal(on_tensors, want, ["requested", "epod_valid"])
    # outside the patch state, both refuse
    assert penc.without_pods(pct, pmeta, ["default/nobody"]) is None
    assert renc.without_pods(rct, rmeta, ["default/nobody"]) is None


# ------------------------------------------------------------- overlays

def test_template_planes_and_overlay_ct(cluster):
    renc, rct, rmeta, *_ = cluster["ref"]
    penc, pct, pmeta, *_ = cluster["port"]
    rt = _templates(cluster["node_dicts"], RefNode)
    pt = _templates(cluster["node_dicts"], Node)
    rplanes = ref_overlay._template_planes(renc, rmeta.resources, rct, rt)
    pplanes = overlay._template_planes(penc, pmeta.resources, pct, pt)
    assert rplanes is not None and set(rplanes) == set(pplanes)
    for k in rplanes:
        np.testing.assert_array_equal(pplanes[k], rplanes[k], err_msg=k)
    want = ref_overlay._overlay_ct_program(rct, rplanes)
    tct = from_reference(_flat(rct), "cpu")
    got = overlay._overlay_ct_program(tct, overlay._planes_to(pplanes, "cpu"))
    _assert_fields_equal(got, want)


def test_overlay_mask_program_bit_equal(cluster):
    renc, rct, rmeta, _ns, _bs, rps = cluster["ref"]
    penc, pct, pmeta, _ns2, _bs2, pps = cluster["port"]
    rplanes = ref_overlay._template_planes(
        renc, rmeta.resources, rct, _templates(cluster["node_dicts"], RefNode))
    pplanes = overlay._template_planes(
        penc, pmeta.resources, pct, _templates(cluster["node_dicts"], Node))
    rpb = renc.encode_pods(rps, rmeta)
    ppb = penc.encode_pods(pps, pmeta)
    want = np.asarray(ref_overlay._overlay_mask_program(rct, rplanes, rpb))
    got = overlay._overlay_mask_program(
        from_reference(_flat(rct), "cpu"), overlay._planes_to(pplanes, "cpu"),
        ppb.to("cpu"))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[:len(rps)].any() and not want[:len(rps)].all()


@pytest.mark.parametrize("where", ["host", "tensors", "overflow"])
def test_with_hypothetical(cluster, where):
    """The port's ``with_hypothetical`` equals the reference's host path on
    numpy and on torch tensors (the resident branch). A template that
    brings a label key past the bucket is answered by the host path, and
    on tensors raises instead of copying them to the host."""
    nodes = cluster["node_dicts"]
    bound = cluster["bound_dicts"]

    def fresh(enc_cls, node_cls, pod_cls):
        enc = enc_cls()
        ct, meta = enc.encode_cluster([node_cls.from_dict(d) for d in nodes],
                                      [pod_cls.from_dict(d) for d in bound])
        return enc, ct, meta

    renc, rct, rmeta = fresh(RefEncoder, RefNode, RefPod)
    penc, pct, pmeta = fresh(SnapshotEncoder, Node, Pod)
    rt = _templates(nodes, RefNode)
    pt = _templates(nodes, Node)
    if where == "overflow":
        extra = {f"brand-new-key-{i}": "x" for i in range(64)}
        rt[0].metadata.labels.update(extra)
        pt[0].metadata.labels.update(extra)
    if where == "overflow":
        with pytest.raises(ValueError, match="overflows a bucket"):
            penc.with_hypothetical(pct.to("cpu"), pmeta, pt)
    want, rrows = renc.with_hypothetical(rct, rmeta, rt)
    src = pct if where != "tensors" else pct.to("cpu")
    got, prows = penc.with_hypothetical(src, pmeta, pt)
    assert prows == rrows
    if where == "tensors":
        assert isinstance(got.node_valid, torch.Tensor)
        # the resident branch keeps the node bucket and appends K rows
        N = pct.node_valid.shape[0]
        KB = got.node_valid.shape[0] - N
        for f in overlay._NODE_AXIS_FIELDS:
            np.testing.assert_array_equal(_np(getattr(got, f))[:N + len(pt)],
                                          np.asarray(getattr(want, f))[
                                              :N + len(pt)], err_msg=f)
        assert KB >= len(pt)
    else:
        assert isinstance(got.node_valid, np.ndarray)
        _assert_fields_equal(got, want)
    assert penc.with_hypothetical(pct, pmeta, []) == (pct, [])


# ------------------------------------------------------------ plan mask

@pytest.mark.parametrize("enabled", ["all", "replacement"])
@pytest.mark.parametrize("want_scores", [False, True])
def test_plan_mask_program(cluster, enabled, want_scores):
    renc, rct, rmeta, _ns, _bs, rps = cluster["ref"]
    penc, _pct, pmeta, _ns2, _bs2, pps = cluster["port"]
    rng = np.random.default_rng(1)
    M, R = 4, rct.allocatable.shape[1]
    nom = dict(nom_node=rng.integers(0, 8, M).astype(np.int32),
               nom_prio=rng.choice([0, 5, 10], M).astype(np.int32),
               nom_req=(rct.allocatable[:M] // 2).astype(np.int32),
               nom_valid=np.array([True, True, False, True]))
    rct = rct.replace(**nom)
    rpb = renc.encode_pods(rps, rmeta)
    ppb = penc.encode_pods(pps, pmeta)
    V = rct.label_value_num.shape[0]
    IMG = rct.image_sizes.shape[0]
    rlvn, risz = ref_overlay._fresh_tables(renc, V, IMG)
    plvn, pisz = overlay._fresh_tables(penc, V, IMG)
    np.testing.assert_array_equal(plvn, rlvn)
    np.testing.assert_array_equal(pisz, risz)
    ref_en = None if enabled == "all" else REF_REPLACEMENT
    port_en = None if enabled == "all" else REPLACEMENT_FILTERS
    assert ref_en == port_en
    want = ref_overlay._plan_mask_program(rct, rpb, rlvn, risz, ref_en,
                                          want_scores)
    got = overlay._plan_mask_program(
        from_reference(_flat(rct), "cpu"), ppb.to("cpu"),
        torch.from_numpy(plvn), torch.from_numpy(pisz), port_en,
        want_scores)
    if want_scores:
        (wm, ws), (gm, gs) = want, got
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
        ws, gs = np.asarray(ws), gs.numpy()
        np.testing.assert_array_equal(np.isfinite(gs), np.isfinite(ws))
        fin = np.isfinite(ws)
        np.testing.assert_allclose(gs[fin], ws[fin], rtol=0, atol=ATOL)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------- counting

def test_compile_counter_counts_first_seen_shapes_and_builds(monkeypatch):
    cc = overlay.CompileCounter()
    vt = torch.full((512,), -1, dtype=torch.int32)
    q = torch.full((32,), -1, dtype=torch.int32)
    overlay._quota_program(vt, q)          # unarmed: never counted
    cc.arm()
    overlay._quota_program(vt, q)          # seen before: no event
    assert cc.take() == 0
    overlay._quota_program(vt[:256], q)    # a new bucket: one event
    overlay._quota_program(vt[:256], q)
    assert cc.take() == 1
    monkeypatch.setattr(kernels, "BUILDS", kernels.BUILDS + 2)
    assert cc.take() == 3
    cc.disarm()
    overlay._quota_program(vt[:128], q)    # disarmed: not counted
    assert cc.take() == 3
