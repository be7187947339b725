"""The port's filters, scores and relational plugins against the JAX
package's, on the same encoding.

The JAX package encodes a small cluster that reaches every path
(``relational_mix``); ``from_reference`` carries that encoding across. Masks,
counts and ``select_host`` choices must be bit-equal. Float scores may
differ by fp32 summation order only: they must agree within ATOL.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from kubernetes_tpu.api.types import Node as RefNode, Pod as RefPod
from kubernetes_tpu.encode.snapshot import (
    TENANT_KEY_ID,
    SnapshotEncoder as RefEncoder,
)
from kubernetes_tpu.ops import filters as ref_filters
from kubernetes_tpu.ops import scores as ref_scores
from kubernetes_tpu.ops import topology as ref_topology
from kubernetes_tpu_torch.encode.convert import from_reference
from kubernetes_tpu_torch.ops import filters, kernels, scores, topology
from kubernetes_tpu_torch.testing.workloads import relational_mix

# Scores are sums of a handful of fp32 terms of at most a few hundred;
# summation order may move the last bits, never more than this.
ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is faster, and the test workers
    share the machine's cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _flat(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _flat(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return np.asarray(x)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def enc():
    nodes, bound, pending, ns_labels = relational_mix(pods=40, nodes=24, seed=7)
    ref = RefEncoder()
    ref.set_namespaces(ns_labels)
    rct, meta = ref.encode_cluster(
        [RefNode.from_dict(n.to_dict()) for n in nodes],
        [RefPod.from_dict(p.to_dict()) for p in bound],
        pending_pods=[RefPod.from_dict(p.to_dict()) for p in pending])
    rpb = ref.encode_pods([RefPod.from_dict(p.to_dict()) for p in pending], meta)
    # preemption nominees, which the fit filter reserves for
    rng = np.random.default_rng(1)
    M, R = 4, rct.allocatable.shape[1]
    nom = dict(nom_node=rng.integers(0, 8, M).astype(np.int32),
               nom_prio=rng.choice([0, 5, 10], M).astype(np.int32),
               nom_req=(rct.allocatable[:M] // 2).astype(np.int32),
               nom_valid=np.array([True, True, False, True]))
    assert R >= 2
    variants = {"plain": rct, "nominated": rct.replace(**nom)}
    return {name: (c, rpb, from_reference(_flat(c), "cpu"),
                   from_reference(_flat(rpb), "cpu"), meta.topo_keys)
            for name, c in variants.items()}


@pytest.mark.parametrize("variant", ["plain", "nominated"])
@pytest.mark.parametrize("name", list(ref_filters.FILTERS) + ["run_filters"])
def test_filter_mask_bit_equal(enc, variant, name):
    rct, rpb, ct, pb, _ = enc[variant]
    if name == "run_filters":
        ref, port = ref_filters.run_filters(rct, rpb), filters.run_filters(ct, pb)
    else:
        ref = ref_filters.FILTERS[name](rct, rpb)
        port = filters.FILTERS[name](ct, pb)
    assert np.array_equal(_np(ref), _np(port))


def test_run_filters_enabled_subset(enc):
    rct, rpb, ct, pb, _ = enc["plain"]
    on = ("NodeResourcesFit", "TaintToleration")
    assert np.array_equal(_np(ref_filters.run_filters(rct, rpb, enabled=on)),
                          _np(filters.run_filters(ct, pb, enabled=on)))


def test_tenant_helpers_bit_equal(enc):
    rct, rpb, _, _, _ = enc["plain"]
    rng = np.random.default_rng(2)
    labels = np.array(rct.node_labels)
    labels[:, TENANT_KEY_ID] = rng.choice([-1, 3, 9], labels.shape[0])
    plabels = np.array(rpb.pod_labels)
    plabels[:, TENANT_KEY_ID] = rng.choice([-1, 3, 9], plabels.shape[0])
    rct, rpb = rct.replace(node_labels=labels), rpb.replace(pod_labels=plabels)
    ct, pb = from_reference(_flat(rct), "cpu"), from_reference(_flat(rpb), "cpu")
    assert np.array_equal(_np(ref_filters.tenant_local_rank(rct)),
                          _np(filters.tenant_local_rank(ct)))
    assert np.array_equal(_np(ref_filters.tenant_pair_mask(rct, rpb)),
                          _np(filters.tenant_pair_mask(ct, pb)))
    assert np.array_equal(_np(ref_filters.run_filters(rct, rpb)),
                          _np(filters.run_filters(ct, pb)))


_COUNT_TERMS = {
    "spread": lambda b: (b.sc_sel, None, None),
    "affinity": lambda b: (b.aff_sel, b.aff_ns_explicit, b.aff_ns_mask),
    "anti": lambda b: (b.anti_sel, b.anti_ns_explicit, b.anti_ns_mask),
    "preferred": lambda b: (b.paff_sel, b.paff_ns_explicit, b.paff_ns_mask),
}


@pytest.mark.parametrize("terms", list(_COUNT_TERMS))
def test_count_pn_plain_bit_equal(enc, terms):
    rct, rpb, ct, pb, _ = enc["plain"]
    ref = ref_topology._count_pn(rct, *_pick(rpb, terms))
    before = kernels.LAUNCHES["count_pn"]
    plain = topology._count_pn_plain(ct, *_pick(pb, terms))
    dispatched = topology._count_pn(ct, *_pick(pb, terms))
    assert _np(ref).sum() > 0, "the fixture must give matches to count"
    assert np.array_equal(_np(ref), _np(plain))
    assert np.array_equal(_np(plain), _np(dispatched))
    # on the CPU the wrapper takes the plain version and launches nothing
    assert kernels.LAUNCHES["count_pn"] == before


def _pick(b, terms):
    sel, explicit, mask = _COUNT_TERMS[terms](b)
    return (sel, b.pod_ns) if explicit is None else (sel, b.pod_ns, explicit, mask)


_TOPOLOGY_MASKS = ("spread_mask", "interpod_required_mask",
                   "interpod_symmetry_mask")
_TOPOLOGY_RAW = ("spread_score_raw", "interpod_score_raw")


@pytest.mark.parametrize("factored", ["0", "1"])
@pytest.mark.parametrize("fn", _TOPOLOGY_MASKS + _TOPOLOGY_RAW)
def test_topology_bit_equal_both_domain_branches(enc, monkeypatch, factored, fn):
    monkeypatch.setenv("KTPU_DOMAIN_FACTORED", factored)
    rct, rpb, ct, pb, topo_keys = enc["plain"]
    ref = _np(getattr(ref_topology, fn)(rct, rpb, topo_keys))
    port = _np(getattr(topology, fn)(ct, pb, topo_keys))
    if fn in _TOPOLOGY_MASKS:
        assert not ref.all(), f"{fn} must veto something in the fixture"
        assert np.array_equal(ref, port)
    else:
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(port, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("factored", ["0", "1"])
def test_domain_counts_bit_equal(enc, monkeypatch, factored):
    monkeypatch.setenv("KTPU_DOMAIN_FACTORED", factored)
    rct, rpb, ct, pb, topo_keys = enc["plain"]
    rcnt = ref_topology._count_pn(rct, rpb.sc_sel, rpb.pod_ns)
    elig = ref_topology._spread_policy_elig(rct, rpb)
    ref = ref_topology._domain_counts(rct, rcnt, rpb.sc_topo, topo_keys,
                                      elig=elig, want_domains=True)
    port = topology._domain_counts(
        ct, topology._count_pn(ct, pb.sc_sel, pb.pod_ns), pb.sc_topo,
        topo_keys, elig=topology._spread_policy_elig(ct, pb),
        want_domains=True)
    for r, p in zip(ref, port):
        assert np.array_equal(_np(r), _np(p))


_RAW_SCORES = ("least_allocated", "most_allocated",
               "requested_to_capacity_ratio", "balanced_allocation",
               "image_locality", "node_affinity_preferred_raw",
               "taint_toleration_raw")


@pytest.mark.parametrize("fn", _RAW_SCORES)
def test_raw_scores_close(enc, fn):
    rct, rpb, ct, pb, _ = enc["plain"]
    ref = _np(getattr(ref_scores, fn)(rct, rpb))
    port = _np(getattr(scores, fn)(ct, pb))
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(port, ref, rtol=0, atol=ATOL)


def test_normalizers_close(enc):
    rct, rpb, ct, pb, _ = enc["plain"]
    feas = np.array(ref_filters.run_filters(rct, rpb))
    raw = np.array(ref_scores.node_affinity_preferred_raw(rct, rpb))
    raw_t, feas_t = torch.from_numpy(raw), torch.from_numpy(feas)
    for reverse in (False, True):
        np.testing.assert_allclose(
            _np(scores.default_normalize(raw_t, feas_t, reverse)),
            _np(ref_scores.default_normalize(raw, feas, reverse)),
            rtol=0, atol=ATOL)
    np.testing.assert_allclose(_np(scores.minmax_normalize(raw_t, feas_t)),
                               _np(ref_scores.minmax_normalize(raw, feas)),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("fit_strategy", ["LeastAllocated", "MostAllocated",
                                          "RequestedToCapacityRatio"])
def test_combined_score_close(enc, fit_strategy):
    rct, rpb, ct, pb, topo_keys = enc["plain"]
    feas = ref_filters.run_filters(rct, rpb)
    extra_ref = {
        "PodTopologySpread": (ref_topology.spread_score_raw(rct, rpb, topo_keys),
                              "default_reverse", None),
        "InterPodAffinity": (ref_topology.interpod_score_raw(rct, rpb, topo_keys),
                             "minmax", np.asarray(rpb.paff_valid).any(axis=1))}
    extra = {
        "PodTopologySpread": (topology.spread_score_raw(ct, pb, topo_keys),
                              "default_reverse", None),
        "InterPodAffinity": (topology.interpod_score_raw(ct, pb, topo_keys),
                             "minmax", pb.paff_valid.any(dim=1))}
    weights = {"ImageLocality": 3.0, "NodeAffinity": 1.5}
    ref = _np(ref_scores.combined_score(rct, rpb, feas, weights=weights,
                                        extra_raw=extra_ref,
                                        fit_strategy=fit_strategy))
    port = _np(scores.combined_score(ct, pb, torch.from_numpy(np.array(feas)),
                                     weights=weights, extra_raw=extra,
                                     fit_strategy=fit_strategy))
    assert np.array_equal(np.isneginf(ref), np.isneginf(port))
    np.testing.assert_allclose(port, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 12345])
@pytest.mark.parametrize("ranked", [False, True])
def test_select_host_bit_equal(seed, ranked):
    rng = np.random.default_rng(seed)
    P, N = 33, 70
    s = rng.integers(0, 4, (P, N)).astype(np.float32)  # many ties
    s[rng.random((P, N)) < 0.3] = -np.inf
    s[5] = -np.inf                                       # no feasible node
    rank = rng.permutation(N).astype(np.int32) if ranked else None
    rc, rh = ref_scores.select_host(s, seed=seed, node_rank=rank)
    c, h = scores.select_host(torch.from_numpy(s), seed=seed,
                              node_rank=None if rank is None
                              else torch.from_numpy(rank))
    assert np.array_equal(_np(rc), _np(c))
    assert np.array_equal(_np(rh), _np(h))
