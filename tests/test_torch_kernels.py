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
from kubernetes_tpu_torch.models import schedule_step
from kubernetes_tpu_torch.models.gang import extend_cluster
from kubernetes_tpu_torch.ops import kernels, topology
from kubernetes_tpu_torch.testing.workloads import (relational_mix,
                                                    required_terms_mix)


def _encoded(device, workload=relational_mix, with_meta=False):
    nodes, bound, pending, ns_labels = workload(pods=40, nodes=24, seed=7)
    enc = SnapshotEncoder()
    enc.set_namespaces(ns_labels)
    pend = [Pod.from_dict(p.to_dict()) for p in pending]
    ct, meta = enc.encode_cluster([Node.from_dict(n.to_dict()) for n in nodes],
                                  [Pod.from_dict(p.to_dict()) for p in bound],
                                  pending_pods=pend)
    pb = enc.encode_pods(pend, meta).to(device)
    ct = extend_cluster(ct.to(device), pb)
    return (ct, pb, meta) if with_meta else (ct, pb)


def _term_sets(pb):
    return {"spread": (pb.sc_sel, pb.pod_ns),
            "affinity": (pb.aff_sel, pb.pod_ns, pb.aff_ns_explicit,
                         pb.aff_ns_mask),
            "anti": (pb.anti_sel, pb.pod_ns, pb.anti_ns_explicit,
                     pb.anti_ns_mask),
            "preferred": (pb.paff_sel, pb.pod_ns, pb.paff_ns_explicit,
                          pb.paff_ns_mask)}


def _random_case(seed, device, *, E=700, K=8, N=96, P=12, T=3, X=3, V=4,
                 NSB=8, nodes=None, valid_share=0.9):
    """Seeded random inputs reaching every branch of the selector test:
    keys out of range, pad values, ops 0..5 and one past them, pad
    expressions, nil selectors, explicit namespace sets, existing pods
    off every node or invalid. ``nodes``: the range [lo, hi) the existing
    pods' node ids are drawn from (default: two past each end of [0, N))."""
    rng = np.random.default_rng(seed)
    lo, hi = nodes or (-2, N + 2)
    ct, _ = _encoded("cpu")
    labels = rng.integers(-1, 5, (E, K)).astype(np.int32)
    ct = ct.replace(
        epod_labels=torch.from_numpy(labels),
        epod_node=torch.from_numpy(rng.integers(lo, hi, E).astype(np.int32)),
        epod_ns=torch.from_numpy(rng.integers(-1, NSB + 1, E).astype(np.int32)),
        epod_valid=torch.from_numpy(rng.random(E) < valid_share),
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


def test_count_pn_kernel_refuses_a_wrong_dtype():
    ct, pb = _encoded("cpu")
    with pytest.raises(ValueError, match="epod_labels is torch.int64"):
        topology.count_pn(ct.replace(epod_labels=ct.epod_labels.long()),
                          pb.sc_sel, pb.pod_ns)


# ------------------------------------------- launch geometry (CPU, no card)

_NODE_BUCKETS = [2 ** k for k in range(5, 18)]
_PTS = [1, 3, 4, 21, 255, 256, 4097, 65535, 65536, 70001, 2 ** 17]
# (X, V, NSB): the path's spread terms, the wide required terms, and
# selectors far wider than any workload's
_WIDTHS = [(1, 1, 0), (4, 4, 2), (16, 32, 4096)]


@pytest.mark.parametrize("N", _NODE_BUCKETS + [3, 6146])
def test_count_pn_geometry_fits_the_card(N):
    """Shared memory within a Hopper block's 232,448 bytes, and no grid or
    block dimension past its limit, for every node bucket and any PT."""
    for PT in _PTS:
        for X, V, NSB in _WIDTHS:
            g = topology.count_pn_geometry(PT, N, X, V, NSB)
            assert g.smem_bytes <= 232_448 == topology.SMEM_PER_BLOCK
            assert g.smem_bytes == topology._smem_layout(
                g.pt_tile, g.node_range, X, V, NSB)
            assert 1 <= g.blocks <= 2 ** 31 - 1
            assert g.threads % 32 == 0 and 32 <= g.threads <= 512
            assert g.node_range % 4 == 0 and g.node_range >= 4
            assert g.pt_tile in topology.PT_TILES
            assert g.pt_tile < 2 * PT
            # the node ranges cover N, and none is empty
            assert g.n_ranges * g.node_range >= N > (g.n_ranges - 1) * g.node_range


@pytest.mark.parametrize("PT,N", [(1, 3), (21, 96), (36, 6146), (256, 8192),
                                  (36, 16384), (7, 10000), (5, 131072),
                                  (70001, 32)])
def test_count_pn_geometry_covers_each_element_once(PT, N):
    g = topology.count_pn_geometry(PT, N, 3, 4, 8)
    hits = np.zeros((PT, N), np.int8)
    for b in range(g.blocks):
        pt0, pt1, n0, n1 = g.block_slice(b)
        assert 0 <= pt0 < pt1 <= PT and pt1 - pt0 <= g.pt_tile
        assert 0 <= n0 < n1 <= N and n1 - n0 <= g.node_range
        hits[pt0:pt1, n0:n1] += 1
    assert (hits == 1).all()


def test_count_pn_geometry_at_the_largest_shapes_tiles_both_axes():
    """PT = N = 2**17: too many elements to enumerate, so each axis is
    checked to be tiled once and the grid to walk every pair of tiles."""
    PT = N = 2 ** 17
    g = topology.count_pn_geometry(PT, N, 4, 4, 2)
    pts = [g.block_slice(i * g.n_ranges)[:2] for i in range(g.pt_tiles)]
    nds = [g.block_slice(r)[2:] for r in range(g.n_ranges)]
    assert pts[0][0] == 0 and pts[-1][1] == PT
    assert all(a[1] == b[0] for a, b in zip(pts, pts[1:]))
    assert nds[0][0] == 0 and nds[-1][1] == N
    assert all(a[1] == b[0] for a, b in zip(nds, nds[1:]))
    assert g.block_slice(g.blocks - 1) == (pts[-1][0], PT, nds[-1][0], N)
    assert g.blocks == len(pts) * len(nds) <= 2 ** 31 - 1


def test_count_pn_geometry_fills_the_card_at_the_path_shape():
    """The path's spread shape (PT=256, N=8192): enough blocks for 132 SMs,
    and each block's counters fit in its shared memory."""
    g = topology.count_pn_geometry(256, 8192, 1, 1, 0)
    assert g.blocks >= 132
    assert g.pt_tile * g.node_range * 4 < g.smem_bytes <= 232_448


def test_count_pn_geometry_refuses_a_selector_wider_than_a_block():
    with pytest.raises(ValueError, match="does not fit"):
        topology.count_pn_geometry(4, 64, 1, 1, 300_000)


def test_evaluate_counts_the_spread_terms_once(monkeypatch):
    """The spread mask and the spread score share one cnt_pn; the result is
    the same as when each counts for itself."""
    ct, pb, meta = _encoded("cpu", with_meta=True)
    assert pb.sc_valid.shape[1] > 0
    calls = []
    count = topology._count_pn

    def counting(ct_, sel, *args):
        calls.append(sel is pb.sc_sel)
        return count(ct_, sel, *args)

    monkeypatch.setattr(topology, "_count_pn", counting)
    res = schedule_step.evaluate(ct, pb, seed=3, topo_keys=meta.topo_keys)
    assert calls.count(True) == 1
    calls.clear()
    own_mask = topology.spread_mask(ct, pb, meta.topo_keys)
    own_raw = topology.spread_score_raw(ct, pb, meta.topo_keys)
    assert calls.count(True) == 2
    cnt = topology.spread_count_pn(ct, pb)
    assert torch.equal(topology.spread_mask(ct, pb, meta.topo_keys, cnt_pn=cnt),
                       own_mask)
    assert torch.equal(topology.spread_score_raw(ct, pb, meta.topo_keys,
                                                 cnt_pn=cnt), own_raw)
    assert res.assigned.any()


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


# Edge cases of the kernel's tiling: name -> _random_case keywords.
_EDGES = {
    # N not a multiple of the node range, and not of 4 (scalar stores)
    "n_ragged": dict(E=3000, N=6146, P=7, T=3),
    # several node ranges per selector
    "n_16384": dict(E=3000, N=16384, P=12, T=3),
    "n_below_4": dict(E=200, N=3, P=5, T=2),
    # PT not a multiple of the selector tile
    "pt_ragged": dict(P=7, T=3),
    # PT past the 65535 a grid's y dimension allows
    "pt_past_grid_y": dict(E=300, N=32, P=70001, T=1, X=1, V=2, NSB=4),
    "e_zero": dict(E=0),
    "all_invalid": dict(valid_share=0.0),
    # many staging tiles, and counts far above 255 on a few nodes
    "e_many_tiles": dict(E=9000, N=96, nodes=(10, 15)),
    # most existing pods off [0, N)
    "nodes_off": dict(E=2000, N=96, nodes=(-96, 192)),
    # wide selectors with explicit namespace sets
    "t_x_v_wide": dict(E=1500, N=300, P=9, T=4, X=5, V=6, NSB=40),
    # a namespace mask wide enough to need the 48 KB opt-in
    "smem_opt_in": dict(E=800, N=512, P=6, T=2, X=2, V=2, NSB=60000),
}


def _assert_kernel_equals_plain(ct, args, geometry=None, name=""):
    before = kernels.LAUNCHES["count_pn"]
    got = topology.count_pn(ct, *args, geometry=geometry)
    want = topology._count_pn_plain(ct, *args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["count_pn"] == before + 1, name
    assert got.dtype == want.dtype and got.shape == want.shape, name
    assert torch.equal(got, want), name


@pytest.mark.gpu
@pytest.mark.parametrize("edge", sorted(_EDGES))
def test_count_pn_kernel_tiling_edges_on_card(edge):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    seed = sorted(_EDGES).index(edge) + 10
    ct, *args = _random_case(seed, "cuda", **_EDGES[edge])
    _assert_kernel_equals_plain(ct, tuple(args), name=edge)
    if edge == "smem_opt_in":
        P, T = args[0].valid.shape
        g = topology.count_pn_geometry(P * T, ct.node_valid.shape[0],
                                       *args[0].vals.shape[2:],
                                       args[3].shape[2])
        assert g.smem_bytes > 48 * 1024


@pytest.mark.gpu
@pytest.mark.parametrize("pt_tile,node_range,threads",
                         [(1, 4, 32), (2, 20, 64), (8, 128, 512),
                          (4, 300, 160), (8, 36, 96)])
def test_count_pn_kernel_explicit_geometries_on_card(pt_tile, node_range,
                                                     threads):
    """Geometries the default never picks: one selector and four nodes a
    block, ragged tiles, the widest selector tile and block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ct, *args = _random_case(5, "cuda", **_EDGES["t_x_v_wide"])
    with pytest.raises(ValueError, match="pod_ns is torch.int32"):
        topology.count_pn(ct, args[0], args[1][:-1], *args[2:])
    P, T, X = args[0].key.shape
    V, NSB = args[0].vals.shape[3], args[3].shape[2]
    N = ct.node_valid.shape[0]
    g = topology.CountPnGeometry(
        P * T, N, pt_tile, node_range, threads,
        topology._smem_layout(pt_tile, node_range, X, V, NSB))
    _assert_kernel_equals_plain(ct, tuple(args), geometry=g)
    # a selector tile or a block the kernel is not built for is refused
    for odd in (dict(pt_tile=3), dict(threads=1024), dict(node_range=6)):
        kw = dict(pt_tile=pt_tile, node_range=node_range,
                  threads=threads) | odd
        bad = topology.CountPnGeometry(
            P * T, N, **kw, smem_bytes=topology._smem_layout(
                kw["pt_tile"], kw["node_range"], X, V, NSB))
        with pytest.raises(RuntimeError, match="geometry"):
            topology.count_pn(ct, *args, geometry=bad)


@pytest.mark.gpu
def test_count_pn_kernel_wide_required_terms_on_card():
    """T, X, V > 1 from encoded pods: several required (anti-)affinity
    terms of several expressions, with own, listed and selected namespace
    sets."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ct, pb = _encoded("cuda", workload=required_terms_mix)
    assert min(pb.aff_sel.vals.shape[1:]) > 1
    for name in ("affinity", "anti"):
        _assert_kernel_equals_plain(ct, _term_sets(pb)[name], name=name)
