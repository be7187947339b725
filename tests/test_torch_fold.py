"""The resident drain's scatters at their edges: the fold and the patch.

The reference scatters with ``mode="drop"``: a destination past the end
is ignored. On CUDA an out-of-range index is a device assert, so the port
filters those rows itself. These tests hold the port's fold and churn
patch to a plain numpy model of the reference's semantics at the edges
(no winner, every pod a winner, a fold that runs past the end, a patch
touching the last node row and rows outside every table), on the CPU and,
marked ``gpu``, on the card, where the result must equal the CPU's bit for
bit. This file imports no JAX, so the card's machine runs it
(``python -m pytest --noconftest -m gpu tests/test_torch_fold.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
from kubernetes_tpu_torch.models import gang
from kubernetes_tpu_torch.testing.workloads import relational_mix
from kubernetes_tpu_torch.testing.wrappers import make_pod

B, P = 2, 8


def _flat(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _flat(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return x.cpu().numpy().copy()


def _equal(a, b, path=""):
    if isinstance(a, dict):
        for k in a:
            _equal(a[k], b[k], f"{path}.{k}")
        return
    assert a.dtype == b.dtype and a.shape == b.shape, path
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), path


def _inputs(case):
    """(host cluster, host batches, meta) of a small relational cluster;
    ``case`` picks the batches: ``none`` of the pods valid, ``all`` small
    enough to fit, or (``mixed``, ``past_end``) the workload's pods
    interleaved with pods too large for any node."""
    nodes, bound, pending, ns_labels = relational_mix(pods=B * P + 8,
                                                      nodes=16, seed=5)
    enc = SnapshotEncoder()
    enc.set_namespaces(ns_labels)
    if case == "all":
        pods = [make_pod(f"s{i}").label("app", f"a{i % 3}")
                .req({"cpu": "10m"}).obj() for i in range(B * P)]
    else:
        big = [make_pod(f"big{i}").req({"cpu": "999"}).obj()
               for i in range(B * P // 2)]
        pods = [q for pair in zip(pending, big) for q in pair]
    pods = [Pod.from_dict(p.to_dict()) for p in pods]
    ct, meta = enc.encode_cluster([Node.from_dict(n.to_dict()) for n in nodes],
                                  [Pod.from_dict(p.to_dict()) for p in bound],
                                  pending_pods=pods)
    pbs = [enc.encode_pods(pods[i * P:(i + 1) * P], meta, min_p=P)
           for i in range(B)]
    if case == "none":
        pbs = [pb.replace(pod_valid=np.zeros_like(pb.pod_valid)) for pb in pbs]
    return ct, pbs, meta


def _fold(case, device):
    ct, pbs, meta = _inputs(case)
    ctx, e0, fill = gang.build_drain_context(ct, pbs, nom_bucket=4,
                                             device=device)
    if case == "past_end":
        # a fill two slots short of the end: the third winner on lands past
        # it and is dropped, as the reference's scatter drops it
        fill = int(ctx.epod_valid.shape[0]) - 2
    before = _flat(ctx)
    stack = gang.stack_batches(gang.unify_batches(pbs))
    a, rounds, out, new_fill = gang.drain_step(
        ctx, stack, torch.tensor(fill, dtype=torch.int32, device=device),
        e0=e0, topo_keys=meta.topo_keys)
    return before, stack, e0, fill, a, rounds, out, new_fill


def _check_fold(before, stack, e0, fill, a, out, new_fill):
    after = _flat(out)
    E = before["epod_valid"].shape[0]
    flat = a.cpu().numpy().reshape(-1)
    winners = np.nonzero(flat >= 0)[0]
    dest = fill + np.arange(len(winners))
    keep = dest < E
    assert int(new_fill) == fill + len(winners)
    assert new_fill.dtype == torch.int32 and a.dtype == torch.int32
    labels = stack.pod_labels.reshape(B * P, -1)
    K = after["epod_labels"].shape[1]
    for w, d in zip(winners[keep], dest[keep]):
        if d < e0:
            assert after["epod_valid"][d]
        assert after["epod_node"][d] == flat[w]
        row = np.full(K, -1, np.int32)
        row[:labels.shape[1]] = labels[w]
        assert np.array_equal(after["epod_labels"][d], row)
    assert not after["epod_valid"][e0:].any()
    assert not after["ea_valid"][e0:].any()
    low = min(fill, e0)
    for name in ("epod_valid", "epod_node", "epod_labels", "epod_ns"):
        # base slots below the fill are never written
        assert np.array_equal(after[name][:low], before[name][:low]), name
    untouched = np.arange(min(fill + len(winners), E), e0)
    for name in ("epod_valid", "epod_node", "epod_labels"):
        assert np.array_equal(after[name][untouched],
                              before[name][untouched]), name


@pytest.mark.parametrize("case", ["none", "all", "mixed", "past_end"])
def test_fold_packs_winners_at_the_edges(case):
    before, stack, e0, fill, a, rounds, out, new_fill = _fold(case, "cpu")
    n = int((a >= 0).sum())
    assert n == {"none": 0, "all": B * P}.get(case, n)
    if case in ("mixed", "past_end"):
        assert 0 < n < B * P
    _check_fold(before, stack, e0, fill, a, out, new_fill)


def _patch_case(ctx, rng):
    """A patch dict at the reference's write buckets, whose index rows hit
    the first and last row of each table and rows outside it (-1 pads and
    indices past the end)."""
    E = int(ctx.epod_valid.shape[0])
    N = int(ctx.node_valid.shape[0])
    M = int(ctx.nom_valid.shape[0])
    K = int(ctx.epod_labels.shape[1])
    ET = int(ctx.ea_valid.shape[1])
    AX = int(ctx.ea_sel.key.shape[2])
    AV = int(ctx.ea_sel.vals.shape[3])
    NSB = int(ctx.ea_ns_mask.shape[2])
    R = int(ctx.requested.shape[1])
    KN = int(ctx.node_labels.shape[1])
    T = int(ctx.taint_key.shape[1])
    I = int(ctx.node_images.shape[1])
    V = int(ctx.label_value_num.shape[0])

    def ints(shape, lo=-1, hi=7):
        return rng.integers(lo, hi, shape).astype(np.int32)

    def flags(shape):
        return rng.random(shape) < 0.5

    pod_slot = np.array([0, E - 1, -1, E, E + 3, 5], np.int32)
    node_row = np.array([N - 1, -1, N, 0, N + 7, 2], np.int32)
    nom_slot = np.array([M - 1, -1, M, 0], np.int32)
    MP, MN, MM = len(pod_slot), len(node_row), len(nom_slot)
    return {
        "pod_slot": pod_slot, "pod_node": ints(MP), "pod_ns": ints(MP),
        "pod_labels": ints((MP, K)), "pod_valid": flags(MP),
        "ea_topo": ints((MP, ET)), "ea_valid": flags((MP, ET)),
        "ea_ns_explicit": flags((MP, ET)),
        "ea_ns_mask": flags((MP, ET, NSB)),
        "ea_sel_key": ints((MP, ET, AX)), "ea_sel_op": ints((MP, ET, AX), 0, 5),
        "ea_sel_vals": ints((MP, ET, AX, AV)),
        "ea_sel_expr_valid": flags((MP, ET, AX)),
        "ea_sel_valid": flags((MP, ET)),
        "node_row": node_row, "n_alloc": ints((MN, R), 0, 9000),
        "n_valid": flags(MN), "n_unsched": flags(MN),
        "n_labels": ints((MN, KN)), "n_taint_key": ints((MN, T)),
        "n_taint_val": ints((MN, T)), "n_taint_effect": ints((MN, T)),
        "n_taint_valid": flags((MN, T)), "n_images": ints((MN, I)),
        "n_attach_limit": ints(MN, 0, 99),
        "n_reset": np.array([True, True, True, False, True, True]),
        "nom_slot": nom_slot, "nom_node": ints(MM), "nom_prio": ints(MM),
        "nom_req": ints((MM, R), 0, 500), "nom_valid": flags(MM),
        "req_delta": ints((N, R), -50, 50),
        "label_value_num": np.where(rng.random(V) < 0.5, np.nan,
                                    rng.random(V)).astype(np.float32),
    }


_ROWS = {"pod_slot": [("epod_node", "pod_node"), ("epod_ns", "pod_ns"),
                      ("epod_labels", "pod_labels"),
                      ("epod_valid", "pod_valid"), ("ea_topo", "ea_topo"),
                      ("ea_valid", "ea_valid"),
                      ("ea_ns_explicit", "ea_ns_explicit"),
                      ("ea_ns_mask", "ea_ns_mask")],
         "node_row": [("allocatable", "n_alloc"), ("node_valid", "n_valid"),
                      ("unschedulable", "n_unsched"),
                      ("node_labels", "n_labels"),
                      ("taint_key", "n_taint_key"),
                      ("taint_val", "n_taint_val"),
                      ("taint_effect", "n_taint_effect"),
                      ("taint_valid", "n_taint_valid"),
                      ("node_images", "n_images"),
                      ("attach_limit", "n_attach_limit")],
         "nom_slot": [("nom_node", "nom_node"), ("nom_prio", "nom_prio"),
                      ("nom_req", "nom_req"), ("nom_valid", "nom_valid")]}


def _plain_patch(ct: dict, patch: dict) -> dict:
    """The reference's ``_apply_patch`` in numpy, row by row, dropping
    every index outside its table."""
    out = {k: (dict(v) if isinstance(v, dict) else v.copy())
           for k, v in ct.items()}
    N = out["node_valid"].shape[0]
    reset = np.zeros(N, bool)
    for i, r in enumerate(patch["node_row"]):
        if 0 <= r < N:
            reset[r] = patch["n_reset"][i]
    out["requested"] = np.where(reset[:, None], 0, out["requested"]) \
        + patch["req_delta"]
    out["label_value_num"] = patch["label_value_num"].copy()
    for idx_key, table in _ROWS.items():
        for i, r in enumerate(patch[idx_key]):
            for field, key in table:
                if 0 <= r < out[field].shape[0]:
                    out[field][r] = patch[key][i]
    for f in ("key", "op", "vals", "expr_valid", "valid"):
        arr = out["ea_sel"][f].copy()
        for i, r in enumerate(patch["pod_slot"]):
            if 0 <= r < arr.shape[0]:
                arr[r] = patch[f"ea_sel_{f}"][i]
        out["ea_sel"][f] = arr
    out["attach_used"] = np.where(reset, 0, out["attach_used"])
    out["port_valid"] = np.where(reset[:, None], False, out["port_valid"])
    out["used_rwo_valid"] = np.where(reset[:, None], False,
                                     out["used_rwo_valid"])
    return out


def _patched(device, seed):
    ct, pbs, _ = _inputs("mixed")
    ctx, _, _ = gang.build_drain_context(ct, pbs, nom_bucket=4, device=device)
    patch = _patch_case(ctx, np.random.default_rng(seed))
    before = _flat(ctx)
    out = gang.apply_ctx_patch(ctx, patch)
    assert out is ctx
    return before, patch, _flat(out)


@pytest.mark.parametrize("seed", [0, 1])
def test_patch_drops_rows_outside_each_table(seed):
    before, patch, after = _patched("cpu", seed)
    _equal(_plain_patch(before, patch), after)
    # the last node row was reset and rewritten
    N = after["node_valid"].shape[0]
    assert np.array_equal(after["requested"][N - 1], patch["req_delta"][N - 1])
    assert np.array_equal(after["allocatable"][N - 1], patch["n_alloc"][0])


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["none", "all", "mixed", "past_end"])
def test_fold_on_card_equals_cpu(case):
    _needs_card()
    cpu = _fold(case, "cpu")
    card = _fold(case, "cuda")
    _check_fold(*card[:5], card[6], card[7])
    for name, a, b in (("assignments", cpu[4], card[4]),
                       ("rounds", cpu[5], card[5]),
                       ("fill", cpu[7], card[7])):
        assert torch.equal(a, b.cpu()), name
    _equal(_flat(cpu[6]), _flat(card[6]), "ctx")


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_patch_on_card_equals_cpu(seed):
    _needs_card()
    _, _, cpu = _patched("cpu", seed)
    _, _, card = _patched("cuda", seed)
    _equal(cpu, card, "ctx")
