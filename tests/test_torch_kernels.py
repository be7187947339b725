"""The port's CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so the card's machine runs its ``gpu`` tests
(``python -m pytest --noconftest -m gpu tests/test_torch_kernels.py``).
A ``gpu`` test decides inside itself whether a card is present and skips
without one. Counts are exact integers, so kernel and plain version must
be bit-equal.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.encode.snapshot import SelectorSet, SnapshotEncoder
from kubernetes_tpu_torch.models.gang import extend_cluster
from kubernetes_tpu_torch.ops import kernels, topology
from kubernetes_tpu_torch.testing.workloads import relational_mix


def _encoded(device):
    nodes, bound, pending, ns_labels = relational_mix(pods=40, nodes=24, seed=7)
    enc = SnapshotEncoder()
    enc.set_namespaces(ns_labels)
    pend = [Pod.from_dict(p.to_dict()) for p in pending]
    ct, meta = enc.encode_cluster([Node.from_dict(n.to_dict()) for n in nodes],
                                  [Pod.from_dict(p.to_dict()) for p in bound],
                                  pending_pods=pend)
    pb = enc.encode_pods(pend, meta).to(device)
    return extend_cluster(ct.to(device), pb), pb


def _term_sets(pb):
    return {"spread": (pb.sc_sel, pb.pod_ns),
            "affinity": (pb.aff_sel, pb.pod_ns, pb.aff_ns_explicit,
                         pb.aff_ns_mask),
            "anti": (pb.anti_sel, pb.pod_ns, pb.anti_ns_explicit,
                     pb.anti_ns_mask),
            "preferred": (pb.paff_sel, pb.pod_ns, pb.paff_ns_explicit,
                          pb.paff_ns_mask)}


def _random_case(seed, device):
    """Seeded random inputs reaching every branch of the selector test:
    keys out of range, pad values, ops 0..5 and one past them, pad
    expressions, nil selectors, explicit namespace sets, existing pods
    off every node or invalid."""
    rng = np.random.default_rng(seed)
    E, K, N, P, T, X, V, NSB = 700, 8, 96, 12, 3, 3, 4, 8
    ct, _ = _encoded("cpu")
    labels = rng.integers(-1, 5, (E, K)).astype(np.int32)
    ct = ct.replace(
        epod_labels=torch.from_numpy(labels),
        epod_node=torch.from_numpy(rng.integers(-2, N + 2, E).astype(np.int32)),
        epod_ns=torch.from_numpy(rng.integers(-1, NSB + 1, E).astype(np.int32)),
        epod_valid=torch.from_numpy(rng.random(E) < 0.9),
        node_valid=torch.ones(N, dtype=torch.bool))
    sel = SelectorSet(
        key=torch.from_numpy(rng.integers(-1, K + 2, (P, T, X)).astype(np.int32)),
        op=torch.from_numpy(rng.integers(0, 7, (P, T, X)).astype(np.int32)),
        vals=torch.from_numpy(rng.integers(-1, 5, (P, T, X, V)).astype(np.int32)),
        expr_valid=torch.from_numpy(rng.random((P, T, X)) < 0.7),
        valid=torch.from_numpy(rng.random((P, T)) < 0.9))
    pod_ns = torch.from_numpy(rng.integers(0, NSB, P).astype(np.int32))
    ns_explicit = torch.from_numpy(rng.random((P, T)) < 0.5)
    ns_mask = torch.from_numpy(rng.random((P, T, NSB)) < 0.5)
    return (ct.to(device), sel.to(device), pod_ns.to(device),
            ns_explicit.to(device), ns_mask.to(device))


def test_count_pn_on_cpu_takes_the_plain_version():
    ct, pb = _encoded("cpu")
    before = kernels.LAUNCHES["count_pn"]
    for args in _term_sets(pb).values():
        assert torch.equal(topology._count_pn(ct, *args),
                           topology._count_pn_plain(ct, *args))
    assert kernels.LAUNCHES["count_pn"] == before


def test_count_pn_kernel_refuses_cpu_tensors():
    ct, pb = _encoded("cpu")
    with pytest.raises(ValueError, match="not on the card"):
        topology.count_pn(ct, pb.sc_sel, pb.pod_ns)


def test_random_case_exercises_every_branch():
    """The random inputs the card's test uses are not degenerate: some
    pairs count, and the plain version agrees with a per-pair loop."""
    ct, sel, pod_ns, ns_explicit, ns_mask = _random_case(0, "cpu")
    got = topology._count_pn_plain(ct, sel, pod_ns, ns_explicit, ns_mask)
    assert 0 < int(got.sum()) < int(ct.epod_valid.sum()) * sel.valid.numel()
    want = np.zeros(tuple(got.shape), np.float32)
    lab, node, ens = (ct.epod_labels.numpy(), ct.epod_node.numpy(),
                      ct.epod_ns.numpy())
    K, NSB, N = lab.shape[1], ns_mask.shape[2], want.shape[2]
    for p, t in np.ndindex(*sel.valid.shape):
        if not sel.valid[p, t]:
            continue
        for e in np.flatnonzero(ct.epod_valid.numpy()):
            if not 0 <= node[e] < N:
                continue
            if ns_explicit[p, t]:
                if not (0 <= ens[e] < NSB and ns_mask[p, t, ens[e]]):
                    continue
            elif ens[e] != pod_ns[p]:
                continue
            ok = True
            for x in range(sel.key.shape[2]):
                if not sel.expr_valid[p, t, x]:
                    continue
                k = int(sel.key[p, t, x])
                v = lab[e, k] if 0 <= k < K else -1
                in_set = any(int(s) >= 0 and int(s) == v
                             for s in sel.vals[p, t, x])
                ok = {0: v >= 0 and in_set, 1: v < 0 or not in_set,
                      2: v >= 0, 3: v < 0}.get(int(sel.op[p, t, x]), False)
                if not ok:
                    break
            if ok:
                want[p, t, node[e]] += 1
    assert np.array_equal(got.numpy(), want)


@pytest.mark.gpu
def test_count_pn_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ct, pb = _encoded("cuda")
    cases = {name: (ct, args) for name, args in _term_sets(pb).items()}
    for seed in range(3):
        ct_r, *args = _random_case(seed, "cuda")
        cases[f"random{seed}"] = (ct_r, tuple(args))
    for name, (c, args) in cases.items():
        before = kernels.LAUNCHES["count_pn"]
        got = topology.count_pn(c, *args)
        want = topology._count_pn_plain(c, *args)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["count_pn"] == before + 1, name
        assert torch.equal(got, want), name
