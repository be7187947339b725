"""The port's default preemption against the JAX package's, on the CPU.

The same inputs go through both packages: pods and nodes built by each
package's own wrappers (or parsed from the same dicts), numeric tensors
made from a seed with numpy.

- every case of ``tests/test_preemption_tensor.py``: ``find_candidate``,
  ``find_candidate_tensor`` and ``preempt_wave`` give equal
  ``PreemptionResult``s (node, victim names in order, PDB violations);
- ``_dry_run`` and ``_wave_scan`` raw outputs bit-equal on seeded inputs,
  with pad rows, N < ``_TOPK`` and the unlimited ``"pods"`` allocatable
  (2**31 - 1); the port's loop that stops after the last real preemptor
  equals all Qb steps;
- ``tensor_static_masks`` bit-equal on a MixedHeterogeneous cluster, and
  on the resident context (``node_rows``) after a node churn patch;
- the saturated workload equals ``benchmarks/preemption_bench.py``'s;
- the ``Scheduler`` with ``PreemptionSimulation`` on: equal binder logs,
  evictions in order, nominations and ``ctx_stats`` at depth 1 and 2; the
  wave riding the resident context reads the host shadow and nominates as
  the snapshot path does, and as the reference does;
- the ``SchedulerRunner`` with the gate on over a ``DirectClient``: the
  same store bindings and evictions as the reference (the reference's
  integration and disruption cases);
- ``verify_wave_results`` gives the reference's verdicts on correct and
  corrupted waves; a refuted wave stops the runner with a ``ParityError``;
- no fallback hides the device: ``find_candidate_tensor``,
  ``tensor_static_masks``, ``dry_run_wave`` and ``preempt_wave`` let a
  device error through; the scheduler counts it
  (``LOOP_ERRORS{site=device_preempt}``), feeds the breaker and takes the
  serial scan, and lets ``KernelError``, ``ParityError`` and
  ``NotImplementedError`` through.
"""

from __future__ import annotations

import copy
import random
import time

import jax
import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as ref_types
from kubernetes_tpu.audit import sentinel as ref_sentinel
from kubernetes_tpu.client import clientset as ref_clientset
from kubernetes_tpu.config import features as ref_features
from kubernetes_tpu.config import types as ref_config
from kubernetes_tpu.ops import preemption as ref_ops
from kubernetes_tpu.sched import cache as ref_cache
from kubernetes_tpu.sched import preemption as ref_pre
from kubernetes_tpu.sched import queue as ref_queue
from kubernetes_tpu.sched import runner as ref_runner
from kubernetes_tpu.sched import scheduler as ref_scheduler
from kubernetes_tpu.store import store as ref_store
from kubernetes_tpu.testing import wrappers as ref_wrappers
from kubernetes_tpu_torch.api import types as port_types
from kubernetes_tpu_torch.audit import sentinel as port_sentinel
from kubernetes_tpu_torch.client import clientset as port_clientset
from kubernetes_tpu_torch.config import features as port_features
from kubernetes_tpu_torch.config import types as port_config
from kubernetes_tpu_torch.metrics import registry as port_registry
from kubernetes_tpu_torch.ops import preemption as port_ops
from kubernetes_tpu_torch.sched import cache as port_cache
from kubernetes_tpu_torch.sched import preemption as port_pre
from kubernetes_tpu_torch.sched import queue as port_queue
from kubernetes_tpu_torch.sched import runner as port_runner
from kubernetes_tpu_torch.sched import scheduler as port_scheduler
from kubernetes_tpu_torch.store import store as port_store
from kubernetes_tpu_torch.testing import wrappers as port_wrappers
from kubernetes_tpu_torch.testing.workloads import (build_saturated,
                                                    mixed_heterogeneous)

LONG = 3600.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _key(res):
    if res is None:
        return None
    return (res.node_name, [v.metadata.name for v in res.victims],
            res.num_pdb_violations)


def _keys(results):
    return [_key(r) for r in results]


# ---- the cases of tests/test_preemption_tensor.py, through both packages ----

_DB_PDB = {"metadata": {"name": "db-pdb", "namespace": "default"},
           "spec": {"minAvailable": 1,
                    "selector": {"matchLabels": {"app": "db"}}}}


def _case_basic(W):
    nodes = [W.make_node(f"n{i}").capacity({"cpu": "4"}).obj()
             for i in range(4)]
    bound = [W.make_pod(f"v{i}-{j}").req({"cpu": "2"}).priority(j + 1)
             .node(f"n{i}").obj() for i in range(4) for j in range(2)]
    return nodes, bound, W.make_pod("hi").req({"cpu": "2"}).priority(100) \
        .obj(), None


def _case_equal_priorities(W):
    nodes = [W.make_node("n0").capacity({"cpu": "4"}).obj()]
    bound = [W.make_pod("same").req({"cpu": "4"}).priority(10).node("n0")
             .obj()]
    return nodes, bound, W.make_pod("p").req({"cpu": "2"}).priority(10) \
        .obj(), None


def _case_pdb_ordering(W):
    nodes = [W.make_node("n0").capacity({"cpu": "6"}).obj()]
    bound = [
        W.make_pod("guarded").req({"cpu": "2"}).priority(1).node("n0")
        .label("app", "db").obj(),
        W.make_pod("free").req({"cpu": "2"}).priority(1).node("n0").obj(),
        W.make_pod("high").req({"cpu": "2"}).priority(50).node("n0").obj(),
    ]
    return nodes, bound, W.make_pod("pre").req({"cpu": "2"}).priority(100) \
        .obj(), [_DB_PDB]


def _case_relational(W):
    nodes = [W.make_node("n0").capacity({"cpu": "8"}).label("zone", "z0")
             .obj()]
    bound = [W.make_pod("blocker").req({"cpu": "1"}).priority(1).node("n0")
             .label("app", "x").obj()]
    pod = (W.make_pod("anti").req({"cpu": "1"}).priority(100)
           .pod_anti_affinity("zone", {"app": "x"}).obj())
    return nodes, bound, pod, None


def _case_fewest_lowest(W):
    nodes = [W.make_node("a").capacity({"cpu": "4"}).obj(),
             W.make_node("b").capacity({"cpu": "4"}).obj()]
    bound = [W.make_pod("a-big").req({"cpu": "4"}).priority(50).node("a")
             .obj(),
             W.make_pod("b-small").req({"cpu": "4"}).priority(2).node("b")
             .obj()]
    return nodes, bound, W.make_pod("pre").req({"cpu": "3"}).priority(100) \
        .obj(), None


def _case_pdb_safe_victims(W):
    """tests/test_disruption.py: the PDB-unprotected victim's node wins."""
    nodes = [W.make_node(f"n{i}").capacity({"cpu": "2", "pods": "10"}).obj()
             for i in range(2)]
    bound = [W.make_pod("guarded").label("app", "web").req({"cpu": "2"})
             .priority(0).node("n0").obj(),
             W.make_pod("free").label("app", "other").req({"cpu": "2"})
             .priority(0).node("n1").obj()]
    pdbs = [{"metadata": {"name": "guard", "namespace": "default"},
             "spec": {"minAvailable": 1,
                      "selector": {"matchLabels": {"app": "web"}}}}]
    return nodes, bound, W.make_pod("pred").req({"cpu": "2"}).priority(100) \
        .obj(), pdbs


def _random_cluster(W, seed, n_pre=1, prio=(15, 15)):
    rng = random.Random(seed)
    nodes = [W.make_node(f"n{i}").capacity(
        {"cpu": str(rng.choice([2, 4, 8])),
         "memory": f"{rng.choice([4, 8])}Gi"}).obj() for i in range(8)]
    bound = []
    for i in range(8):
        for j in range(rng.randint(0, 4)):
            bound.append(
                W.make_pod(f"v{i}-{j}")
                .req({"cpu": str(rng.choice([1, 2])),
                      "memory": f"{rng.choice([1, 2])}Gi"})
                .priority(rng.randint(0, 20)).node(f"n{i}").obj())
    pre = [W.make_pod(f"pre{k}" if n_pre > 1 else "pre")
           .req({"cpu": str(rng.choice([1, 2, 3])), "memory": "2Gi"})
           .priority(rng.randint(*prio)).obj() for k in range(n_pre)]
    return nodes, bound, pre


def _case_random(seed):
    def build(W):
        nodes, bound, pre = _random_cluster(W, seed)
        return nodes, bound, pre[0], None
    return build


_SINGLE_CASES = {
    "basic": _case_basic, "equal_priorities": _case_equal_priorities,
    "pdb_ordering": _case_pdb_ordering, "relational": _case_relational,
    "fewest_lowest": _case_fewest_lowest,
    "pdb_safe_victims": _case_pdb_safe_victims,
    "random0": _case_random(0), "random1": _case_random(1),
    "random2": _case_random(2)}


@pytest.mark.parametrize("case", sorted(_SINGLE_CASES))
def test_single_preemptor_equals_reference(case):
    build = _SINGLE_CASES[case]
    r_nodes, r_bound, r_pod, pdbs = build(ref_wrappers)
    p_nodes, p_bound, p_pod, _ = build(port_wrappers)
    exact = ref_pre.find_candidate(r_nodes, r_bound, r_pod, pdbs=pdbs)
    assert _key(port_pre.find_candidate(p_nodes, p_bound, p_pod,
                                        pdbs=pdbs)) == _key(exact)
    assert _key(ref_pre.find_candidate_tensor(r_nodes, r_bound, r_pod,
                                              pdbs=pdbs)) == _key(exact)
    assert _key(port_pre.find_candidate_tensor(
        p_nodes, p_bound, p_pod, pdbs=pdbs, device="cpu")) == _key(exact)
    if case in ("basic", "pdb_ordering", "fewest_lowest",
                "pdb_safe_victims"):
        assert exact is not None
    if case == "equal_priorities":
        assert exact is None


def _wave_basic(W):
    nodes = [W.make_node(f"n{i}").capacity({"cpu": "8", "pods": "16"}).obj()
             for i in range(6)]
    bound = [W.make_pod(f"v{i}-{j}").req({"cpu": "4"})
             .priority(1 + (i + j) % 3).node(f"n{i}").obj()
             for i in range(6) for j in range(2)]
    pre = [W.make_pod(f"hi{k}").req({"cpu": "6"}).priority(100).obj()
           for k in range(4)]
    return nodes, bound, pre, None


def _wave_double_spend(W):
    nodes = [W.make_node("n0").capacity({"cpu": "4"}).obj()]
    bound = [W.make_pod("low").req({"cpu": "4"}).priority(1).node("n0").obj()]
    pre = [W.make_pod("a").req({"cpu": "4"}).priority(100).obj(),
           W.make_pod("b").req({"cpu": "4"}).priority(100).obj()]
    return nodes, bound, pre, None


def _wave_mixed_priorities(W):
    nodes = [W.make_node("n0").capacity({"cpu": "4"}).obj(),
             W.make_node("n1").capacity({"cpu": "4"}).obj()]
    bound = [W.make_pod("p10").req({"cpu": "4"}).priority(10).node("n0")
             .obj(),
             W.make_pod("p40").req({"cpu": "4"}).priority(40).node("n1")
             .obj()]
    pre = [W.make_pod("mid").req({"cpu": "2"}).priority(20).obj(),
           W.make_pod("top").req({"cpu": "2"}).priority(99).obj()]
    return nodes, bound, pre, None


def _wave_pdb_budgets(W):
    nodes = [W.make_node(f"n{i}").capacity({"cpu": "4"}).obj()
             for i in range(3)]
    bound = [W.make_pod(f"db{i}").req({"cpu": "4"}).priority(1)
             .node(f"n{i}").label("app", "db").obj() for i in range(3)]
    pdbs = [{"metadata": {"name": "db-pdb", "namespace": "default"},
             "spec": {"minAvailable": 2,
                      "selector": {"matchLabels": {"app": "db"}}}}]
    pre = [W.make_pod(f"hi{k}").req({"cpu": "4"}).priority(100).obj()
           for k in range(2)]
    return nodes, bound, pre, pdbs


def _wave_phantom_commit(W):
    nodes = [W.make_node("n0").capacity({"cpu": "8"}).label("zone", "z")
             .obj()]
    bound = [W.make_pod("v").req({"cpu": "6"}).priority(1).node("n0").obj(),
             W.make_pod("h").req({"cpu": "1"}).priority(200).node("n0")
             .label("team", "x").obj()]
    a = (W.make_pod("a").req({"cpu": "6"}).priority(100)
         .pod_anti_affinity("zone", {"team": "x"}).obj())
    b = W.make_pod("b").req({"cpu": "6"}).priority(100).obj()
    return nodes, bound, [a, b], None


def _wave_random(seed):
    def build(W):
        nodes, bound, pre = _random_cluster(W, seed, n_pre=5, prio=(10, 30))
        return nodes, bound, pre, None
    return build


_WAVE_CASES = {
    "basic": _wave_basic, "double_spend": _wave_double_spend,
    "mixed_priorities": _wave_mixed_priorities,
    "pdb_budgets": _wave_pdb_budgets, "phantom_commit": _wave_phantom_commit,
    "random3": _wave_random(3), "random4": _wave_random(4),
    "random5": _wave_random(5), "random6": _wave_random(6)}


def _serial_wave(pre_mod, nodes, bound, preemptors, pdbs=None):
    """The serial failure path, one exact find_candidate per preemptor
    committing evictions and the nominee between calls."""
    import dataclasses
    live = list(bound)
    out = []
    for pod in preemptors:
        res = pre_mod.find_candidate(nodes, live, pod, pdbs=pdbs)
        if res is not None:
            gone = {v.metadata.uid for v in res.victims}
            live = [p for p in live if p.metadata.uid not in gone]
            live.append(dataclasses.replace(
                pod, spec=dataclasses.replace(pod.spec,
                                              node_name=res.node_name)))
        out.append(res)
    return out


@pytest.mark.parametrize("case", sorted(_WAVE_CASES))
def test_wave_equals_reference(case):
    build = _WAVE_CASES[case]
    r_nodes, r_bound, r_pre, pdbs = build(ref_wrappers)
    p_nodes, p_bound, p_pre, _ = build(port_wrappers)
    ref = _keys(ref_pre.preempt_wave(r_nodes, r_bound, r_pre, pdbs=pdbs))
    port = _keys(port_pre.preempt_wave(p_nodes, p_bound, p_pre, pdbs=pdbs,
                                       device="cpu"))
    assert port == ref
    assert port == _keys(_serial_wave(port_pre, p_nodes, p_bound, p_pre,
                                      pdbs=pdbs))
    if case == "double_spend":
        assert port == [("n0", ["low"], 0), None]
    if case == "pdb_budgets":
        assert [k[2] for k in port] == [0, 1]


def test_saturated_wave_at_the_bucket_equals_reference():
    """A saturated cluster (the smoke's preemption cell, cut to 64 nodes),
    a wave padded to WAVE_BUCKET with static masks from the encoded
    cluster: 32 preemptors, two victims each."""
    results = {}
    for side, pre_mod, W, kw in (
            ("ref", ref_pre, ref_wrappers, {}),
            ("port", port_pre, port_wrappers, {"device": "cpu"})):
        if side == "ref":
            from benchmarks.preemption_bench import build_saturated as bs
        else:
            bs = build_saturated
        nodes, bound = bs(64)
        pre = [W.make_pod(f"hi-{k}").req({"cpu": "6", "memory": "8Gi"})
               .priority(100).obj() for k in range(32)]
        results[side] = _keys(pre_mod.preempt_wave(
            nodes, bound, pre, min_q=pre_mod.WAVE_BUCKET, **kw))
    assert results["port"] == results["ref"]
    assert sum(k is not None for k in results["port"]) == 32
    assert all(len(k[1]) == 2 for k in results["port"])


def test_saturated_workload_equals_the_benchmark():
    from benchmarks.preemption_bench import build_saturated as ref_build
    r_nodes, r_bound = ref_build(12, pods_per_node=3)
    p_nodes, p_bound = build_saturated(12, pods_per_node=3)

    def strip(d):
        d = copy.deepcopy(d)
        d["metadata"].pop("uid", None)
        d["metadata"].pop("creationTimestamp", None)
        return d
    assert [strip(n.to_dict()) for n in p_nodes] == \
        [strip(n.to_dict()) for n in r_nodes]
    assert [strip(p.to_dict()) for p in p_bound] == \
        [strip(p.to_dict()) for p in r_bound]


# ---- raw device outputs on seeded inputs --------------------------------------

def _seeded_arrays(seed, N, V, R, Q, Qb, unlimited_pods):
    rng = np.random.default_rng(seed)
    allocatable = rng.integers(4, 16, (N, R)).astype(np.int32)
    # nearly full nodes (at most 1 free a resource), a few overcommitted
    requested = (allocatable - rng.integers(-1, 2, (N, R))).astype(np.int32)
    if unlimited_pods:
        allocatable[:, -1] = np.iinfo(np.int32).max
    # victims packed at the front of each node's row, as the encoder packs
    counts = rng.integers(0, V + 1, N)
    vic_valid = np.arange(V)[None, :] < counts[:, None]
    vic_req = (rng.integers(1, 5, (N, V, R)) * vic_valid[..., None]) \
        .astype(np.int32)
    vic_violating = (rng.random((N, V)) < 0.3) & vic_valid
    vic_prio = np.where(vic_valid, rng.integers(0, 30, (N, V)), 0) \
        .astype(np.int32)
    need = np.zeros((Qb, R), np.int32)
    need[:Q] = rng.integers(0, 5, (Q, R))
    need[:Q, 0] = rng.integers(2, 5, Q)   # never fits without an eviction
    prio = np.full(Qb, ref_ops._INT_MIN, np.int32)
    prio[:Q] = rng.integers(5, 40, Q)
    smask = np.zeros((Qb, N), bool)
    smask[:Q] = rng.random((Q, N)) < 0.8
    return (allocatable, requested, smask, vic_req, vic_valid,
            vic_violating, vic_prio, need, prio)


def _torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("seed,N,V,R,Q,Qb,unlimited", [
    (0, 16, 4, 3, 12, 16, True), (1, 3, 2, 2, 5, 8, False),
    (2, 2, 8, 3, 3, 4, True), (3, 40, 4, 2, 30, 32, False),
    (4, 9, 1, 2, 7, 8, True)],
    ids=["pads", "n_lt_topk", "n2_unlimited", "wide", "one_victim"])
def test_wave_scan_bit_equal(seed, N, V, R, Q, Qb, unlimited):
    arrays = _seeded_arrays(seed, N, V, R, Q, Qb, unlimited)
    ref = jax.device_get(ref_ops._wave_scan(*arrays))
    for steps in (None, Q):
        port = [t.numpy() for t in port_ops._wave_scan(*_torch(arrays),
                                                       steps=steps)]
        for r, p, name in zip(ref, port, ("found", "zero_evict",
                                           "cand_nodes", "evict_sel")):
            r = np.asarray(r)
            assert p.shape == r.shape, name
            assert p.dtype == r.dtype, name
            assert np.array_equal(p, r), (name, steps)
    # the inputs exercised every kind of outcome the scan has
    found = np.asarray(ref[0])
    assert found[:Q].any() and not found[Q:].any()


@pytest.mark.parametrize("seed,N,V,R,unlimited", [
    (0, 16, 4, 3, True), (1, 3, 2, 2, False), (2, 30, 8, 3, True),
    (3, 1, 1, 1, False)])
def test_dry_run_bit_equal(seed, N, V, R, unlimited):
    (allocatable, requested, smask, vic_req, vic_valid, vic_violating,
     vic_prio, need, _prio) = _seeded_arrays(seed, N, V, R, 1, 1,
                                             unlimited)
    arrays = (allocatable, requested, smask[0], vic_req, vic_valid,
              vic_violating, vic_prio, need[0])
    ref = jax.device_get(ref_ops._dry_run(*arrays))
    port = [t.numpy() for t in port_ops._dry_run(*_torch(arrays))]
    for r, p in zip(ref, port):
        r = np.asarray(r)
        assert p.dtype == r.dtype or (r.dtype == np.int32
                                      and p.dtype == np.int64)
        assert np.array_equal(p.astype(r.dtype), r)


def test_encode_cluster_arrays_equal_reference():
    """The host encoding of the wave: totals, victims in eviction order
    (non-violating first, then priority ascending), the "pods" default of
    1 and the unlimited "pods" allocatable."""
    outs = {}
    for side, ops, pre_mod, W in (("ref", ref_ops, ref_pre, ref_wrappers),
                                  ("port", port_ops, port_pre,
                                   port_wrappers)):
        nodes, bound, pods = _random_cluster(W, 9, n_pre=3, prio=(12, 25))
        nodes.append(W.make_node("np").capacity({"cpu": "4"}).obj())
        bound.append(W.make_pod("vp").req({"cpu": "1"}).priority(3)
                     .label("app", "db").node("np").obj())
        budgets = pre_mod._pdb_budgets([_DB_PDB], bound)
        outs[side] = ops._encode_cluster_arrays(
            nodes, bound, ["cpu", "memory", "pods"], 25, budgets)
    for r, p in zip(outs["ref"], outs["port"]):
        assert r.dtype == p.dtype and np.array_equal(r, p)
    alloc = outs["port"][0]
    assert alloc[-1, 2] == np.iinfo(np.int32).max


# ---- static masks -------------------------------------------------------------

def test_tensor_static_masks_equal_reference():
    """A 32-node MixedHeterogeneous cluster (taints on some nodes, node
    selectors and tolerations on some pods), plus a cordoned node and a
    pod pinned by nodeName; masks of 40 preemptors in the WAVE_BUCKET."""
    from benchmarks.workloads import mixed_heterogeneous as ref_mixed
    masks = {}
    for side, gen, pre_mod, W, kw in (
            ("ref", ref_mixed, ref_pre, ref_wrappers, {}),
            ("port", mixed_heterogeneous, port_pre, port_wrappers,
             {"device": "cpu"})):
        nodes, pods = gen(pods=40, nodes=32, seed=2)
        nodes[3].spec.unschedulable = True
        pods[5].spec.node_name = nodes[7].metadata.name
        masks[side] = pre_mod.tensor_static_masks(
            nodes, pods, bound_pods=[], min_p=pre_mod.WAVE_BUCKET, **kw)
        host = np.stack([(ref_ops if side == "ref" else port_ops)
                         ._static_mask(nodes, p) for p in pods])
        assert np.array_equal(masks[side], host)
    assert masks["port"].dtype == masks["ref"].dtype
    assert np.array_equal(masks["port"], masks["ref"])
    assert masks["port"].any() and not masks["port"].all()


def test_static_mask_refuses_a_mesh():
    """A mesh is not refused: since ROADMAP item 20 the static masks run
    sharded on it, and the masks and the wave on a mesh of two logical CPU
    shards equal those without one."""
    from kubernetes_tpu_torch.parallel.mesh import make_mesh
    nodes, bound = build_saturated(2)
    pod = port_wrappers.make_pod("p").req({"cpu": "1"}).obj()
    meshes = (None, make_mesh(["cpu"] * 2))
    masks = [port_pre.tensor_static_masks(nodes, [pod], bound_pods=bound,
                                          mesh=mesh, device="cpu")
             for mesh in meshes]
    assert np.array_equal(masks[0], masks[1])
    waves = [port_pre.preempt_wave(nodes, bound, [pod], mesh=mesh,
                                   device="cpu")
             for mesh in meshes]
    assert [None if r is None else (r.node_name, sorted(
        v.key for v in r.victims)) for r in waves[0]] == [
        None if r is None else (r.node_name, sorted(v.key for v in r.victims))
        for r in waves[1]]


# ---- the Scheduler with PreemptionSimulation on -------------------------------

class _Sched:
    """One package's Scheduler over its own cache, queue, binder log and
    eviction log, with the preemption gate on."""

    def __init__(self, side, nodes, bound, cfg_kw, warm=None, pdbs=()):
        types, config, features, cache_mod, queue_mod, sched_mod, kw = (
            (ref_types, ref_config, ref_features, ref_cache, ref_queue,
             ref_scheduler, {}) if side == "ref" else
            (port_types, port_config, port_features, port_cache, port_queue,
             port_scheduler, {"device": "cpu"}))
        self.types = types
        self.cache = cache_mod.SchedulerCache(assume_ttl=LONG)
        for d in nodes:
            self.cache.add_node(types.Node.from_dict(copy.deepcopy(d)))
        for d in bound:
            self.cache.add_pod(types.Pod.from_dict(copy.deepcopy(d)))
        self.queue = queue_mod.SchedulingQueue(backoff_initial=LONG,
                                               backoff_max=LONG)
        cfg = config.SchedulerConfiguration(**dict(
            dict(explainer_enabled=False, parity_sample_every=1), **cfg_kw))
        gate = features.FeatureGate()
        gate.set_from_map({"PreemptionSimulation": True})
        self.log: dict = {}
        self.evicted: list = []
        self.sched = sched_mod.Scheduler(cfg, self.cache, self.queue,
                                         self._bind, feature_gate=gate, **kw)
        self.sched._drain_ready = lambda pend: False
        self.sched.pdb_lister = lambda: [copy.deepcopy(p) for p in pdbs]
        evict = self.sched._evict

        def logged(victim):
            self.evicted.append(victim.key)
            evict(victim)
        self.sched._evict = logged
        if warm is not None:
            assert self.sched.warm_drain(
                [self.pod(d) for d in warm], slot_headroom=256)

    def pod(self, d):
        return self.types.Pod.from_dict(copy.deepcopy(d))

    def _bind(self, pod, node):
        self.log[pod.key] = node
        return True

    def drive(self, pods, pops=12):
        for d in pods:
            self.queue.add(self.pod(d))
        for _ in range(pops):
            self.sched.run_once(wait=0.01)
            if self.sched.sentinel is not None:
                self.sched.sentinel.drain(LONG)
        self.sched._resolve_pending()
        self.sched.wait_for_bindings()

    def record(self) -> dict:
        return {"log": dict(self.log), "evicted": list(self.evicted),
                "nominated": {k: e[0] for k, e in
                              self.sched._nominated.items()},
                "ctx_stats": copy.deepcopy(self.sched.ctx_stats),
                "queue": self.queue.stats(),
                "samples": dict(self.sched.sentinel.samples),
                "divergences": self.sched.sentinel.divergences}

    def close(self):
        self.sched.close()


def _preempt_workload(n_nodes=12, n_hi=10, n_filler=6):
    nodes, bound = build_saturated(n_nodes)
    W = port_wrappers
    hi = [W.make_pod(f"hi-{k}", "preempt").req({"cpu": "6", "memory": "8Gi"})
          .priority(100).obj() for k in range(n_hi)]
    # priority-0 pods that fit nowhere: they fail without preempting
    filler = [W.make_pod(f"fill-{k}", "preempt").req({"cpu": "2"}).obj()
              for k in range(n_filler)]
    pending = [p for pair in zip(hi, filler) for p in pair] + hi[n_filler:]
    warm = [W.make_pod(f"warm-{k}", "warmup").req({"cpu": "6",
                                                   "memory": "8Gi"})
            .priority(100).obj() for k in range(8)]
    return ([n.to_dict() for n in nodes], [p.to_dict() for p in bound],
            [p.to_dict() for p in pending], [p.to_dict() for p in warm])


@pytest.mark.parametrize("depth,drain", [(1, True), (2, True), (1, False)],
                         ids=["drain_depth1", "drain_depth2", "group"])
def test_scheduler_preempts_as_the_reference(depth, drain):
    nodes, bound, pending, warm = _preempt_workload()
    cfg = dict(batch_size=8, max_drain_batches=2 if drain else 1,
               pipeline_depth=depth)
    sides = [_Sched(side, nodes, bound, cfg,
                    warm=warm if drain else None)
             for side in ("ref", "port")]
    try:
        for s in sides:
            s.drive(pending)
        ref, port = (s.record() for s in sides)
        assert port == ref
        # every high-priority pod evicted two victims and bound
        assert len(port["evicted"]) == 20
        assert sorted(k for k in port["log"] if "/hi-" in k) == \
            sorted(f"preempt/hi-{k}" for k in range(10))
        assert port["samples"]["wave"] >= 1
        assert port["divergences"] == 0
    finally:
        for s in sides:
            s.close()


def test_wave_reads_shadow_not_device(monkeypatch):
    """The wave riding the resident context serves the cluster totals from
    the host shadow, and nominates as the snapshot path does and as the
    reference does (``tests/test_staging.py``'s case)."""
    from kubernetes_tpu_torch.sched.staging import ResidentShadow
    W = port_wrappers
    nodes = [W.make_node(f"node-{i}").capacity(
        {"cpu": "8", "memory": "16Gi", "pods": "20"})
        .label("kubernetes.io/hostname", f"node-{i}").obj().to_dict()
        for i in range(4)]
    low = [W.make_pod(f"low{i}").req({"cpu": "4"}).priority(1).obj()
           .to_dict() for i in range(8)]
    high = [W.make_pod(f"hi{i}").req({"cpu": "4"}).priority(100).obj()
            .to_dict() for i in range(2)]
    outcomes = {}
    for side, mode in (("ref", "shadow"), ("port", "shadow"),
                       ("port", "device"), ("port", "snapshot")):
        s = _Sched(side, nodes, [], dict(batch_size=8), warm=low[:8])
        try:
            s.drive(low, pops=4)
            assert len(s.log) == 8
            served, views = [], []
            if side == "port":
                orig = ResidentShadow.arrays

                def spy(self):
                    got = orig(self)
                    if got is not None:
                        served.append(1)
                    return got
                monkeypatch.setattr(ResidentShadow, "arrays", spy)
                wave_view = s.sched._resident_wave_view
                monkeypatch.setattr(
                    s.sched, "_resident_wave_view",
                    lambda: views.append(wave_view()) or views[-1])
                if mode == "device":
                    s.sched._drain_ctx["shadow"] = None
                if mode == "snapshot":
                    monkeypatch.setattr(s.sched, "_resident_wave_view",
                                        lambda: views.append(None))
            s.drive(high, pops=6)
            outcomes[(side, mode)] = (
                {k: e[0] for k, e in s.sched._nominated.items()},
                dict(s.log), list(s.evicted))
            if side == "port":
                monkeypatch.setattr(ResidentShadow, "arrays", orig)
                assert views, "the wave never ran"
                if mode == "shadow":
                    assert served and views[0] is not None
                if mode == "device":
                    assert not served and views[0] is not None
        finally:
            s.close()
    ref = outcomes[("ref", "shadow")]
    assert len(ref[2]) == 2
    for k, v in outcomes.items():
        assert v == ref, k


def test_resident_static_masks_after_node_churn():
    """The resident context's node rows diverge from the node list after a
    node churn patch (a node deleted, one added): the masks gathered by
    ``node_rows`` from the resident encoding equal the snapshot path's and
    the reference's."""
    W = port_wrappers
    nodes = [W.make_node(f"node-{i}").capacity(
        {"cpu": "8", "memory": "16Gi", "pods": "20"})
        .label("kubernetes.io/hostname", f"node-{i}")
        .label("disk", "ssd" if i % 2 else "hdd").obj().to_dict()
        for i in range(6)]
    low = [W.make_pod(f"low{i}").req({"cpu": "2"}).priority(1).obj()
           .to_dict() for i in range(8)]
    late = (W.make_node("late").capacity({"cpu": "8", "memory": "16Gi",
                                          "pods": "20"})
            .label("kubernetes.io/hostname", "late").label("disk", "ssd")
            .obj().to_dict())
    pre = [W.make_pod(f"hi{i}").req({"cpu": "2"}).priority(100)
           .node_selector({"disk": "ssd"}).obj().to_dict()
           for i in range(3)]
    got = {}
    for side in ("ref", "port"):
        s = _Sched(side, nodes, [], dict(batch_size=8), warm=low)
        try:
            s.drive(low, pops=3)
            s.cache.remove_node("node-1")
            s.cache.add_node(s.types.Node.from_dict(copy.deepcopy(late)))
            # a pop folds the node churn into the resident context
            s.drive([W.make_pod("after").req({"cpu": "1"}).obj().to_dict()],
                    pops=3)
            view = s.sched._resident_wave_view()
            assert view is not None
            pre_mod = ref_pre if side == "ref" else port_pre
            kw = {} if side == "ref" else {"device": "cpu"}
            views = [s.pod(d) for d in pre]
            resident = pre_mod.tensor_static_masks(
                view["nodes"], views, ct=view["ct"], meta=view["meta"],
                encode_pods=s.cache.encode_pods, min_p=pre_mod.WAVE_BUCKET,
                pre_staged=True, node_rows=view["rows"], **kw)
            fresh = pre_mod.tensor_static_masks(
                view["nodes"], views, bound_pods=s.cache.bound_pods(),
                min_p=pre_mod.WAVE_BUCKET, **kw)
            assert np.array_equal(resident, fresh)
            got[side] = ([n.metadata.name for n in view["nodes"]],
                         list(view["rows"]), resident)
        finally:
            s.close()
    assert got["port"][0] == got["ref"][0]
    assert "late" in got["port"][0] and "node-1" not in got["port"][0]
    assert got["port"][1] == got["ref"][1]
    # the churn moved the rows off the node list's positions
    assert got["port"][1] != list(range(len(got["port"][1])))
    assert np.array_equal(got["port"][2], got["ref"][2])
    assert got["port"][2].any() and not got["port"][2].all()


# ---- the runner with the gate on ------------------------------------------------

def _wait(cond, timeout=60.0, what="condition"):
    end = time.time() + timeout
    while not cond():
        if time.time() > end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def _runner_case(kind):
    """-> (nodes, bound, pending, pdbs) as dicts: ``api`` is
    tests/test_integration.py's preemption through the API (one 2-cpu
    node, its victim, a priority-100 pod); ``pdb`` is
    tests/test_disruption.py's PDB-safe victims through the runner;
    ``saturated`` a 16-node saturated cluster and 12 preemptors."""
    W = port_wrappers
    pdbs = []
    if kind == "api":
        nodes = [W.make_node("only").capacity({"cpu": "2", "pods": "5"})
                 .obj()]
        bound = [W.make_pod("victim").req({"cpu": "2"}).priority(1)
                 .node("only").obj()]
        pending = [W.make_pod("vip").req({"cpu": "2"}).priority(100).obj()]
    elif kind == "pdb":
        nodes = [W.make_node(f"n{i}").capacity({"cpu": "2", "pods": "10"})
                 .obj() for i in range(2)]
        bound = [W.make_pod("guarded").label("app", "web")
                 .req({"cpu": "2"}).node("n0").obj(),
                 W.make_pod("free").label("app", "other")
                 .req({"cpu": "2"}).node("n1").obj()]
        pending = [W.make_pod("pred").req({"cpu": "2"}).priority(100).obj()]
        pdbs = [{"kind": "PodDisruptionBudget",
                 "metadata": {"name": "guard", "namespace": "default"},
                 "spec": {"minAvailable": 1,
                          "selector": {"matchLabels": {"app": "web"}}}}]
    else:
        nodes, bound = build_saturated(16)
        pending = [W.make_pod(f"hi-{k}", "preempt")
                   .req({"cpu": "6", "memory": "8Gi"}).priority(100).obj()
                   for k in range(12)]
    return ([n.to_dict() for n in nodes], [p.to_dict() for p in bound],
            [p.to_dict() for p in pending], pdbs)


def _seed_store(client, nodes, bound, pending, pdbs):
    client.nodes().create_many(copy.deepcopy(nodes))
    for pods in (bound, pending):
        by_ns: dict = {}
        for d in pods:
            by_ns.setdefault(d["metadata"].get("namespace", "default"),
                             []).append(copy.deepcopy(d))
        for ns, ds in sorted(by_ns.items()):
            client.pods(ns).create_many(ds)
    for d in pdbs:
        client.resource("poddisruptionbudgets", "default").create(
            copy.deepcopy(d))


def _store_pods(client):
    out = {}
    for ns in ("default", "preempt"):
        for d in client.pods(ns).list():
            out[f"{ns}/{d['metadata']['name']}"] = \
                d["spec"].get("nodeName") or ""
    return out


def _runner_cfg(config, **kw):
    return config.SchedulerConfiguration(**dict(
        dict(explainer_enabled=False, parity_sample_every=1,
             backoff_initial_s=LONG, backoff_max_s=LONG, assume_ttl_s=LONG,
             audit_interval_s=LONG, batch_size=16, max_drain_batches=1),
        **kw))


def _drive_runner(runner, n_pending, pops=10):
    runner.start(start_loop=False)
    _wait(lambda: all(inf.has_synced()
                      for inf in runner.factory._informers.values()),
          what="informer sync")  # the JAX runner has no has_synced()
    _wait(lambda: runner.queue.stats()["active"] >= n_pending,
          what="the pending pods queued")
    runner.scheduler._drain_ready = lambda pend: False
    for _ in range(pops):
        runner.scheduler.run_once(wait=0.01)
        runner.scheduler.sentinel.drain(LONG)
    runner.scheduler._resolve_pending()
    runner.scheduler.wait_for_bindings()


@pytest.mark.parametrize("kind", ["api", "pdb", "saturated"])
def test_runner_preempts_as_the_reference(kind):
    nodes, bound, pending, pdbs = _runner_case(kind)
    out = {}
    gate = ref_features.DEFAULT_FEATURE_GATE
    assert gate.enabled("PreemptionSimulation")
    for side in ("ref", "port"):
        if side == "ref":
            client = ref_clientset.DirectClient(ref_store.ObjectStore())
            _seed_store(client, nodes, bound, pending, pdbs)
            runner = ref_runner.SchedulerRunner(client,
                                                _runner_cfg(ref_config))
        else:
            client = port_clientset.DirectClient(port_store.ObjectStore())
            _seed_store(client, nodes, bound, pending, pdbs)
            runner = port_runner.SchedulerRunner(
                client, _runner_cfg(port_config), device="cpu")
        try:
            _drive_runner(runner, len(pending))
            _wait(lambda: all(_store_pods(client).values()),
                  what="every remaining pod bound")
            out[side] = {
                "pods": _store_pods(client),
                "nominated": {k: e[0] for k, e in
                              runner.scheduler._nominated.items()},
                "waves": runner.scheduler.sentinel.samples["wave"],
                "divergences": runner.scheduler.sentinel.divergences,
                "breaker": runner.scheduler.breaker.mode}
        finally:
            runner.stop()
    assert out["port"] == out["ref"]
    pods = out["port"]["pods"]
    if kind == "api":
        assert pods == {"default/vip": "only"}
    if kind == "pdb":
        assert pods == {"default/guarded": "n0", "default/pred": "n1"}
    if kind == "saturated":
        assert len(pods) == 2 * 16 - 2 * 12 + 12
        assert out["port"]["waves"] >= 1
    assert out["port"]["divergences"] == 0
    assert out["port"]["breaker"] == "single"


# ---- the sentinel's wave sample ------------------------------------------------

def _wave_fixture(W, pre_mod, kw):
    nodes, bound, pre, _ = _wave_basic(W)
    results = pre_mod.preempt_wave(nodes, bound, pre, **kw)
    return nodes, bound, pre, results


def _corrupt(kind, nodes, bound, pre, results):
    import dataclasses
    results = list(results)
    r0 = results[0]
    if kind == "not_on_node":
        other = next(p for p in bound if p.spec.node_name != r0.node_name)
        results[0] = dataclasses.replace(r0, victims=[other])
    elif kind == "higher_priority":
        pre = list(pre)
        pre[0] = dataclasses.replace(
            pre[0], spec=dataclasses.replace(pre[0].spec, priority=1))
    elif kind == "double_eviction":
        results[1] = dataclasses.replace(results[1], node_name=r0.node_name,
                                         victims=list(r0.victims))
    elif kind == "still_infeasible":
        results[0] = dataclasses.replace(r0, victims=r0.victims[:1])
    elif kind == "unknown_node":
        results[0] = dataclasses.replace(r0, node_name="nowhere")
    return pre, results


@pytest.mark.parametrize("kind", ["correct", "not_on_node",
                                  "higher_priority", "double_eviction",
                                  "still_infeasible", "unknown_node"])
def test_verify_wave_results_equals_reference(kind):
    verdicts = {}
    for side, W, pre_mod, sent, kw in (
            ("ref", ref_wrappers, ref_pre, ref_sentinel, {}),
            ("port", port_wrappers, port_pre, port_sentinel,
             {"device": "cpu"})):
        nodes, bound, pre, results = _wave_fixture(W, pre_mod, kw)
        assert all(r is not None for r in results)
        pre, results = _corrupt(kind, nodes, bound, pre, results)
        verdicts[side] = sent.verify_wave_results(nodes, bound, pre,
                                                  results)
    assert verdicts["port"] == verdicts["ref"]
    assert bool(verdicts["port"]) == (kind != "correct")


def test_wave_sample_every_kth():
    sentinel = port_sentinel.ParitySentinel(every=2)
    try:
        nodes, bound, pre, results = _wave_fixture(port_wrappers, port_pre,
                                                   {"device": "cpu"})
        calls = []

        def labels():
            calls.append(1)
            return {}
        for _ in range(4):
            sentinel.maybe_submit_wave(nodes, bound, pre, results, "single",
                                       namespace_labels=labels)
        sentinel.drain(30.0)
        assert sentinel.samples["wave"] == 2 and len(calls) == 2
        assert sentinel.divergences == 0 and sentinel.fault is None
        # a corrupted wave is refuted: the fault the loop raises
        pre2, bad = _corrupt("still_infeasible", nodes, bound, pre, results)
        for _ in range(2):
            sentinel.maybe_submit_wave(nodes, bound, pre2, bad, "single")
        sentinel.drain(30.0)
        assert sentinel.divergences == 1
        assert isinstance(sentinel.fault, port_sentinel.ParityError)
        assert "still infeasible" in str(sentinel.fault)
    finally:
        sentinel.close()


def test_refuted_wave_stops_the_runner(monkeypatch):
    """A wave the sentinel refutes ends the loop for good: the next pop
    raises the ParityError, the breaker does not move, ``stop()`` raises
    it."""
    from kubernetes_tpu_torch.audit.sentinel import ParityError
    refuted = []

    def refute(nodes, bound, views, results, **kw):
        refuted.append(len(results))
        return [f"preemptor {views[0].key} still infeasible: a wrong wave"]

    monkeypatch.setattr(port_sentinel, "verify_wave_results", refute)
    nodes, bound, pending, pdbs = _runner_case("saturated")
    client = port_clientset.DirectClient(port_store.ObjectStore())
    _seed_store(client, nodes, bound, pending, pdbs)
    runner = port_runner.SchedulerRunner(
        client, _runner_cfg(port_config, breaker_threshold=1), device="cpu")
    runner.start()
    try:
        _wait(lambda: runner.loop_error is not None, what="the loop error")
        _wait(lambda: not runner._loop_thread.is_alive(),
              what="the loop thread's end")
        assert isinstance(runner.loop_error, ParityError)
        assert refuted
        assert runner.scheduler.sentinel.divergences >= 1
        assert runner.scheduler.breaker.mode == "single"
        assert "a wrong wave" in runner._resilience_status()["loopError"]
    finally:
        with pytest.raises(ParityError, match="a wrong wave"):
            runner.stop()


# ---- no fallback hides the device ----------------------------------------------

class _DeviceFault(torch.cuda.OutOfMemoryError):
    """The device failure a retry may cure: the allocator refused one
    request (sched/faults.is_fatal keeps it on the retry path)."""


def _fail(*_a, **_k):
    raise _DeviceFault("CUDA out of memory. Tried to allocate 2.00 GiB")


def _cuda_error(msg):
    """The error the CUDA runtime raises: ``torch.AcceleratorError`` where
    this torch has it, else ``RuntimeError("CUDA error: ...")``."""
    cls = getattr(torch, "AcceleratorError", RuntimeError)
    return cls(f"CUDA error: {msg}")


def test_device_paths_let_errors_through(monkeypatch):
    """The reference swallows a device error in these four and scans the
    host instead; the port lets it through."""
    nodes, bound, pre, _ = _wave_basic(port_wrappers)
    monkeypatch.setattr(port_ops, "_dry_run", _fail)
    with pytest.raises(_DeviceFault):
        port_pre.find_candidate_tensor(nodes, bound, pre[0], device="cpu")
    monkeypatch.setattr(port_ops, "_wave_scan", _fail)
    with pytest.raises(_DeviceFault):
        port_ops.dry_run_wave(nodes, bound, pre, [], device="cpu")
    with pytest.raises(_DeviceFault):
        port_pre.preempt_wave(nodes, bound, pre, device="cpu")
    monkeypatch.setattr(port_pre, "_static_filters_program", _fail)
    with pytest.raises(_DeviceFault):
        port_pre.tensor_static_masks(nodes, pre, bound_pods=bound,
                                     device="cpu")


def _errors(site):
    return port_registry.LOOP_ERRORS.items().get((("site", site),), 0)


@pytest.mark.parametrize("path", ["wave", "single"])
def test_scheduler_counts_a_device_failure(monkeypatch, path):
    """A device failure of the wave (or of a lone preemptor's dry-run) that
    a retry may cure (CUDA out of memory) is counted, feeds the breaker,
    and the serial scan gives the reference's answer."""
    nodes, bound, pending, warm = _preempt_workload(
        n_nodes=4, n_hi=2 if path == "wave" else 1, n_filler=0)
    cfg = dict(batch_size=8, max_drain_batches=1, breaker_threshold=3)
    ref = _Sched("ref", nodes, bound, cfg)
    port = _Sched("port", nodes, bound, cfg)
    monkeypatch.setattr(port_ops, "_wave_scan", _fail)
    monkeypatch.setattr(port_ops, "_dry_run", _fail)
    before = _errors("device_preempt")
    try:
        for s in (ref, port):
            s.drive(pending, pops=4)
        assert _errors("device_preempt") == before + 1
        assert port.sched.breaker.mode == "single"   # below the threshold
        assert port.record()["evicted"] == ref.record()["evicted"]
        assert port.log == ref.log and len(port.log) == len(pending)
        # the serial fallback IS the oracle: the sentinel samples no wave
        assert port.sched.sentinel.samples["wave"] == 0
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("error", ["kernel", "parity", "not_ported", "cuda"])
@pytest.mark.parametrize("path", ["wave", "single"])
def test_scheduler_lets_fatal_errors_through(monkeypatch, error, path):
    from kubernetes_tpu_torch.audit.sentinel import ParityError
    from kubernetes_tpu_torch.ops.kernels import KernelError
    exc = {"kernel": KernelError("count_pn launch failed"),
           "parity": ParityError("a wrong count"),
           "not_ported": NotImplementedError("item 99"),
           "cuda": _cuda_error("an illegal memory access was encountered"),
           }[error]

    def raise_it(*_a, **_k):
        raise exc
    nodes, bound, pending, _warm = _preempt_workload(
        n_nodes=4, n_hi=2 if path == "wave" else 1, n_filler=0)
    port = _Sched("port", nodes, bound, dict(batch_size=8,
                                             max_drain_batches=1,
                                             breaker_threshold=1))
    monkeypatch.setattr(port_ops, "_wave_scan", raise_it)
    monkeypatch.setattr(port_ops, "_dry_run", raise_it)
    before = _errors("device_preempt")
    try:
        for d in pending:
            port.queue.add(port.pod(d))
        with pytest.raises(type(exc)):
            port.sched.run_once(wait=0.01)
        assert _errors("device_preempt") == before
        assert port.sched.breaker.mode == "single"
        assert port.evicted == []
    finally:
        port.close()


def test_smoke_fails_a_phase_with_device_preempt_errors(monkeypatch,
                                                        capsys):
    """chip_smoke.py fails any phase in which the scheduler degraded a
    device preemption failure to the host scan."""
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "device_preempt_errors", lambda: 0)
    chip_smoke.emit({"phase": "preemption", "resolved": 128})
    assert '"phase": "preemption"' in capsys.readouterr().out
    monkeypatch.setattr(chip_smoke, "device_preempt_errors", lambda: 1)
    with pytest.raises(chip_smoke.PhaseFailed, match="device_preempt"):
        chip_smoke.emit({"phase": "connected_preemption"})
    assert capsys.readouterr().out == ""
