"""Out-of-tree tensor plugins in the port against the JAX package's, on the
CPU.

- Every case of ``tests/test_framework_plugins.py`` runs on both packages'
  ``Scheduler``: each tensor plugin is written twice, in ``jax.numpy`` for
  the reference and in torch for the port, and the bindings must be equal
  (and what the reference's case asserts).
- A seeded ``relational_mix`` cluster with one filter and one score plugin
  (``kubernetes_tpu_torch/testing/plugins.py`` and its ``jnp`` twin) goes
  through ``gang_schedule``, ``gang_drain``, ``drain_step`` and the
  ``Scheduler`` (group path, drain depth 1 and 2, with and without
  ``warm_drain``): assignments, rounds, carried ``requested`` and the
  folded context are bit-equal; every placement passes the filter; and
  without the plugins the placements differ, so the plugins ran.
- ``converge_key`` differs between two plugin sets.
- The oracle and a tensor filter: the reference's degraded cycle binds past
  the filter's veto; the port's requeues (ROADMAP, Deliberate differences).
"""

from __future__ import annotations

import copy
import dataclasses
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as ref_types
from kubernetes_tpu.config import features as ref_features
from kubernetes_tpu.config import types as ref_config
from kubernetes_tpu.encode.scaling import UNLIMITED as REF_UNLIMITED
from kubernetes_tpu.encode.snapshot import SnapshotEncoder as RefEncoder
from kubernetes_tpu.models import gang as ref_gang
from kubernetes_tpu.sched import cache as ref_cache
from kubernetes_tpu.sched import framework as ref_framework
from kubernetes_tpu.sched import queue as ref_queue
from kubernetes_tpu.sched import scheduler as ref_scheduler
from kubernetes_tpu_torch.api import types as port_types
from kubernetes_tpu_torch.config import features as port_features
from kubernetes_tpu_torch.config import types as port_config
from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
from kubernetes_tpu_torch.models import gang
from kubernetes_tpu_torch.sched import cache as port_cache
from kubernetes_tpu_torch.sched import framework as port_framework
from kubernetes_tpu_torch.sched import queue as port_queue
from kubernetes_tpu_torch.sched import scheduler as port_scheduler
from kubernetes_tpu_torch.testing import plugins as port_plugins
from kubernetes_tpu_torch.testing.workloads import relational_mix
from kubernetes_tpu_torch.testing.wrappers import make_node, make_pod

REF = SimpleNamespace(name="ref", types=ref_types, features=ref_features,
                      config=ref_config, cache=ref_cache, queue=ref_queue,
                      scheduler=ref_scheduler, fw=ref_framework, kw={})
PORT = SimpleNamespace(name="port", types=port_types, features=port_features,
                       config=port_config, cache=port_cache, queue=port_queue,
                       scheduler=port_scheduler, fw=port_framework,
                       kw={"device": "cpu"})
LONG = 3600.0
MODULUS = 5  # the stripe filter vetoes every 5th node of the small clusters


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---- the plugins, once per package -------------------------------------------

def _only_node_one(pkg):
    if pkg is REF:
        return lambda ct, pb, tk: (
            (jnp.arange(ct.node_valid.shape[0]) == 1)[None, :]
            | jnp.zeros((pb.pod_valid.shape[0], 1), bool))
    return lambda ct, pb, tk: (
        (torch.arange(ct.node_valid.shape[0]) == 1)[None, :]
        | torch.zeros((pb.pod_valid.shape[0], 1), dtype=torch.bool))


def _prefer_node_two(pkg):
    if pkg is REF:
        return lambda ct, pb, tk: (
            (jnp.arange(ct.node_valid.shape[0]) == 2).astype(jnp.float32)
            [None, :] * jnp.ones((pb.pod_valid.shape[0], 1), jnp.float32))
    return lambda ct, pb, tk: (
        (torch.arange(ct.node_valid.shape[0]) == 2).to(torch.float32)
        [None, :] * torch.ones((pb.pod_valid.shape[0], 1)))


def _veto_everything(pkg):
    if pkg is REF:
        return lambda ct, pb, tk: jnp.zeros(
            (pb.pod_valid.shape[0], ct.node_valid.shape[0]), bool)
    return lambda ct, pb, tk: torch.zeros(
        (pb.pod_valid.shape[0], ct.node_valid.shape[0]), dtype=torch.bool)


def _ref_stripe(modulus):
    def filter_fn(ct, pb, tk):
        n = ct.node_valid.shape[0]
        allow = jnp.arange(n) % modulus != 0
        return jnp.broadcast_to(allow[None, :], (pb.pod_valid.shape[0], n))
    return ref_framework.TensorPlugin(name=port_plugins.STRIPE_FILTER,
                                      filter_fn=filter_fn)


def _ref_cpu_packing():
    cpu = port_plugins.CPU_INDEX

    def score_fn(ct, pb, tk):
        alloc = ct.allocatable[:, cpu]
        used = ct.requested[:, cpu].astype(jnp.float32)
        ok = ct.node_valid & (alloc > 0) & (alloc < REF_UNLIMITED)
        share = jnp.where(ok, used / jnp.maximum(alloc, 1).astype(
            jnp.float32), 0.0)
        return jnp.broadcast_to(share[None, :],
                                (pb.pod_valid.shape[0], share.shape[0]))
    return ref_framework.TensorPlugin(name=port_plugins.CPU_PACKING_SCORE,
                                      score_fn=score_fn, normalize="minmax",
                                      weight=port_plugins.CPU_PACKING_WEIGHT)


def _pair(pkg, modulus=MODULUS) -> tuple:
    """The stripe filter and the cpu-packing score for ``pkg``, in the
    registry's order (by name)."""
    if pkg is REF:
        ps = (_ref_stripe(modulus), _ref_cpu_packing())
    else:
        ps = (port_plugins.stripe_filter(modulus),
              port_plugins.cpu_packing_score())
    return tuple(sorted(ps, key=lambda p: p.name))


def _registry(pkg, plugins) -> object:
    reg = pkg.fw.Registry()
    for p in plugins:
        reg.register(p)
    return reg


def test_smoke_plugins_are_the_pair():
    assert [p.name for p in port_plugins.smoke_plugins(MODULUS)] == [
        p.name for p in _pair(PORT)]
    assert port_plugins.stripe_allows(12, 5).tolist() == [
        i % 5 != 0 for i in range(12)]


# ---- tests/test_framework_plugins.py on both packages -----------------------

def _build(pkg, cfg=None, registry=None, n_nodes=3, cpu="8", binder=None):
    cache = pkg.cache.SchedulerCache()
    for i in range(n_nodes):
        cache.add_node(pkg.types.Node.from_dict(
            make_node(f"n{i}").capacity({"cpu": cpu, "pods": "10"}).obj()
            .to_dict()))
    queue = pkg.queue.SchedulingQueue()
    bound: dict = {}
    sched = pkg.scheduler.Scheduler(
        cfg or pkg.config.SchedulerConfiguration(), cache, queue,
        binder=binder or (lambda p, n: bound.setdefault(p.key, n) or True),
        registry=registry, **pkg.kw)
    return sched, queue, bound


def _pod(pkg, name="p0"):
    return pkg.types.Pod.from_dict(
        make_pod(name).req({"cpu": "1"}).obj().to_dict())


def _run(pkg, registry=None, cfg=None, pod="p0"):
    sched, queue, bound = _build(pkg, cfg=cfg, registry=registry)
    try:
        queue.add(_pod(pkg, pod))
        sched.run_once(wait=0.1)
        sched.wait_for_bindings()
        return dict(bound)
    finally:
        sched.close()


def _both(make_registry, cfg=None, **kw) -> dict:
    out = {}
    for pkg in (REF, PORT):
        c = cfg(pkg) if cfg is not None else None
        out[pkg.name] = _run(pkg, make_registry(pkg), cfg=c, **kw)
    assert out["port"] == out["ref"]
    return out["port"]


def test_custom_filter_plugin_vetoes_nodes():
    bound = _both(lambda pkg: pkg.fw.Registry().register(
        pkg.fw.TensorPlugin(name="OnlyNodeOne",
                            filter_fn=_only_node_one(pkg))))
    assert bound.get("default/p0") == "n1", bound


def test_custom_score_plugin_steers():
    bound = _both(lambda pkg: pkg.fw.Registry().register(
        pkg.fw.TensorPlugin(name="PreferNodeTwo", weight=1000.0,
                            score_fn=_prefer_node_two(pkg))))
    assert bound.get("default/p0") == "n2", bound


def test_profile_opt_out_disables_plugin():
    def veto(pkg):
        return pkg.fw.Registry().register(pkg.fw.TensorPlugin(
            name="VetoEverything", filter_fn=_veto_everything(pkg)))
    bound = _both(veto, cfg=lambda pkg: pkg.config.SchedulerConfiguration(
        profiles=[pkg.config.Profile(out_of_tree=[])]))
    assert bound, "opted-out plugin must not veto"
    # and with the plugin enabled (default profile), nothing binds
    assert not _both(veto, pod="p1")


@pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])
def test_registry_rejects_duplicates(pkg):
    reg = pkg.fw.Registry().register(pkg.fw.TensorPlugin(name="X"))
    with pytest.raises(ValueError):
        reg.register(pkg.fw.TensorPlugin(name="X"))
    reg.register(pkg.fw.LifecyclePlugin(name="X"))  # separate namespace


@pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])
def test_registry_rejects_in_tree_names(pkg):
    with pytest.raises(ValueError):
        pkg.fw.Registry().register(pkg.fw.TensorPlugin(
            name="PodTopologySpread"))
    with pytest.raises(ValueError):
        pkg.fw.Registry().register(pkg.fw.TensorPlugin(
            name="TaintToleration"))


def test_registry_order_is_stable_by_name():
    for pkg in (REF, PORT):
        reg = pkg.fw.Registry()
        for name in ("Zeta", "Alpha", "Mid"):
            reg.register(pkg.fw.TensorPlugin(name=name))
        assert [p.name for p in reg.tensor_plugins()] == ["Alpha", "Mid",
                                                          "Zeta"]
        assert [p.name for p in reg.tensor_plugins({"Zeta", "Mid"})] == [
            "Mid", "Zeta"]


@pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])
def test_unknown_profile_plugin_name_fails_fast(pkg):
    cfg = pkg.config.SchedulerConfiguration(
        profiles=[pkg.config.Profile(out_of_tree=["Typo"])])
    with pytest.raises(ValueError):
        _build(pkg, cfg=cfg, registry=pkg.fw.Registry())


def test_profile_score_weight_zero_disables_plugin():
    bound = _both(
        lambda pkg: pkg.fw.Registry().register(pkg.fw.TensorPlugin(
            name="PreferNodeTwo", weight=1000.0,
            score_fn=_prefer_node_two(pkg))),
        cfg=lambda pkg: pkg.config.SchedulerConfiguration(profiles=[
            pkg.config.Profile(score_weights={"PreferNodeTwo": 0.0})]))
    assert bound.get("default/p0") != "n2", bound


def test_permit_deny_blocks_binding():
    assert not _both(lambda pkg: pkg.fw.Registry().register(
        pkg.fw.LifecyclePlugin(name="Gatekeeper",
                               permit=lambda pod, node: pkg.fw.DENY)))


def test_permit_wait_then_allow():
    out = {}
    for pkg in (REF, PORT):
        state = {"ready": False}

        def permit(pod, node, pkg=pkg, state=state):
            return (pkg.fw.ALLOW if state["ready"]
                    else (pkg.fw.WAIT, 0.05))
        sched, queue, bound = _build(pkg, registry=pkg.fw.Registry().register(
            pkg.fw.LifecyclePlugin(name="Warmup", permit=permit)))
        try:
            queue.add(_pod(pkg))
            sched.run_once(wait=0.1)
            time.sleep(0.2)
            state["ready"] = True
            sched.wait_for_bindings(timeout=10.0)
            out[pkg.name] = dict(bound)
        finally:
            sched.close()
    assert out["port"] == out["ref"] and out["port"].get("default/p0")


def test_pre_bind_failure_unreserves():
    out = {}
    for pkg in (REF, PORT):
        calls = []
        reg = pkg.fw.Registry().register(pkg.fw.LifecyclePlugin(
            name="SideEffect",
            pre_bind=lambda pod, node, c=calls: c.append(
                ("pre", pod.metadata.name)) or True,
            unreserve=lambda pod, node, c=calls: c.append(
                ("undo", pod.metadata.name)),
        )).register(pkg.fw.LifecyclePlugin(
            name="ZFailer", pre_bind=lambda pod, node: False))  # sorts LAST
        out[pkg.name] = (_run(pkg, reg), calls)
    assert out["port"] == out["ref"]
    bound, calls = out["port"]
    assert not bound
    assert ("pre", "p0") in calls and ("undo", "p0") in calls


def test_permit_allowed_joins_unreserve_rollback():
    """A permit-only plugin that allowed gets unreserved when the BIND
    itself fails."""
    out = {}
    for pkg in (REF, PORT):
        calls = []
        reg = pkg.fw.Registry().register(pkg.fw.LifecyclePlugin(
            name="Reserver",
            permit=lambda pod, node, c=calls: c.append("permit")
            or pkg.fw.ALLOW,
            unreserve=lambda pod, node, c=calls: c.append("undo")))
        sched, queue, _ = _build(pkg, registry=reg, n_nodes=1,
                                 binder=lambda p, n: False)
        try:
            queue.add(_pod(pkg))
            sched.run_once(wait=0.1)
            sched.wait_for_bindings()
        finally:
            sched.close()
        out[pkg.name] = calls
    assert out["port"] == out["ref"] == ["permit", "undo"]


def test_profile_opt_out_disables_lifecycle_plugin():
    assert _both(
        lambda pkg: pkg.fw.Registry().register(pkg.fw.LifecyclePlugin(
            name="Gatekeeper", permit=lambda pod, node: pkg.fw.DENY)),
        cfg=lambda pkg: pkg.config.SchedulerConfiguration(
            profiles=[pkg.config.Profile(out_of_tree=[])]))


def test_post_bind_notified():
    out = {}
    for pkg in (REF, PORT):
        seen = []
        reg = pkg.fw.Registry().register(pkg.fw.LifecyclePlugin(
            name="Notify", post_bind=lambda pod, node, s=seen: s.append(
                (pod.metadata.name, node))))
        out[pkg.name] = (_run(pkg, reg), seen)
    assert out["port"] == out["ref"]
    bound, seen = out["port"]
    assert bound and seen and seen[0][0] == "p0"


# ---- a seeded cluster through the programs ----------------------------------

def _cluster(seed, pods=48, nodes=20, bound=10):
    n, b, p, ns = relational_mix(pods=pods, nodes=nodes, bound=bound,
                                 seed=seed)
    return ([x.to_dict() for x in n], [x.to_dict() for x in b],
            [x.to_dict() for x in p], ns)


def _encode_both(node_dicts, bound_dicts, pending_dicts, batch, ns_labels,
                 pending_slots=False):
    out = []
    for enc, N, P in ((RefEncoder(), ref_types.Node, ref_types.Pod),
                      (SnapshotEncoder(), port_types.Node, port_types.Pod)):
        if ns_labels:
            enc.set_namespaces(ns_labels)
        pending = [P.from_dict(d) for d in pending_dicts]
        ct, meta = enc.encode_cluster([N.from_dict(d) for d in node_dicts],
                                      [P.from_dict(d) for d in bound_dicts],
                                      pending_pods=pending,
                                      pending_slots=pending_slots)
        pbs = [enc.encode_pods(pending[i:i + batch], meta)
               for i in range(0, len(pending), batch)]
        out.append((ct, pbs, meta))
    return out


def _flat(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _flat(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy().copy()
    return np.asarray(x)


def _assert_same(ref, port, path="") -> None:
    if isinstance(ref, dict):
        assert set(ref) == set(port), path
        for k in ref:
            _assert_same(ref[k], port[k], f"{path}.{k}")
        return
    assert ref.dtype == port.dtype and ref.shape == port.shape, path
    assert np.array_equal(ref, port, equal_nan=ref.dtype.kind == "f"), path


def _allowed(assignments, n_nodes) -> bool:
    a = np.asarray(assignments).reshape(-1)
    allow = port_plugins.stripe_allows(n_nodes, MODULUS)
    return bool(np.all(allow[a[a >= 0]]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gang_schedule_with_plugins_equals_reference(seed):
    nodes, bound, pending, ns = _cluster(seed)
    (rct, rpbs, rmeta), (ct, pbs, meta) = _encode_both(nodes, bound,
                                                       pending[:16], 16, ns)
    out = {}
    for name, plugins in (("with", True), ("without", False)):
        ra, rr = ref_gang.gang_schedule(
            rct, rpbs[0], topo_keys=rmeta.topo_keys,
            plugins=_pair(REF) if plugins else ())
        pa, pr = gang.gang_schedule(
            ct.to("cpu"), pbs[0].to("cpu"), topo_keys=meta.topo_keys,
            plugins=_pair(PORT) if plugins else ())
        assert np.array_equal(np.asarray(ra), pa), name
        assert int(rr) == pr, name
        out[name] = pa
    assert _allowed(out["with"], len(nodes))
    assert (out["with"] >= 0).sum() > 0
    assert not np.array_equal(out["with"], out["without"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gang_drain_with_plugins_equals_reference(seed):
    nodes, bound, pending, ns = _cluster(seed)
    (rct, rpbs, rmeta), (ct, pbs, meta) = _encode_both(nodes, bound,
                                                       pending, 16, ns)
    out = {}
    for name, plugins in (("with", True), ("without", False)):
        ref = ref_gang.gang_drain(rct, rpbs, topo_keys=rmeta.topo_keys,
                                  plugins=_pair(REF) if plugins else ())
        got = gang.gang_drain(ct, pbs, topo_keys=meta.topo_keys,
                              device="cpu",
                              plugins=_pair(PORT) if plugins else ())
        for what, r, g in zip(("assignments", "rounds", "requested"),
                              ref, got):
            r = np.asarray(r)
            assert r.dtype == g.dtype and np.array_equal(r, g), (name,
                                                                 what)
        out[name] = got[0]
    assert _allowed(out["with"], len(nodes))
    assert not np.array_equal(out["with"], out["without"])


def _ref_stack(rpbs):
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs),
                                  *ref_gang.unify_batches(rpbs))


def test_drain_step_with_plugins_equals_reference():
    """Two consecutive drain_steps (the second on the folded context):
    assignments, rounds, new_fill and the folded context bit-equal."""
    nodes, bound, pending, ns = _cluster(4)
    (rct, rpbs, rmeta), (ct, pbs, meta) = _encode_both(
        nodes, bound, pending[:32], 8, ns, pending_slots=True)
    rctx, e0, rfill = ref_gang.build_drain_context(rct, rpbs[:2],
                                                   nom_bucket=8)
    ctx, _, fill = gang.build_drain_context(ct, pbs[:2], nom_bucket=8,
                                            device="cpu")
    kw = dict(seed=0, fit_strategy="LeastAllocated", weights=(),
              enabled_filters=(), max_rounds=64)
    for step in (slice(0, 2), slice(2, 4)):
        ra, rr, rctx, rfill = ref_gang.drain_step(
            rctx, _ref_stack(rpbs[step]), rfill, e0=e0,
            topo_keys=rmeta.topo_keys, plugins=_pair(REF), **kw)
        pa, pr, ctx, fill = gang.drain_step(
            ctx, gang.stack_batches(gang.unify_batches(pbs[step])), fill,
            e0=e0, topo_keys=meta.topo_keys, plugins=_pair(PORT), **kw)
        assert np.array_equal(np.asarray(ra), pa.numpy())
        assert np.array_equal(np.asarray(rr), pr.numpy())
        assert int(rfill) == int(fill) and (pa >= 0).any()
        assert _allowed(pa.numpy(), len(nodes))
        _assert_same(_flat(rctx), _flat(ctx), "folded")


def test_converge_key_differs_between_plugin_sets():
    """The plugin tuple is a static of the round graphs' key: two profiles
    with different plugin sets never replay each other's graphs."""
    nodes, bound, pending, ns = _cluster(0, pods=16, nodes=8, bound=4)
    _, (ct, pbs, meta) = _encode_both(nodes, bound, pending[:8], 8, ns)
    pb = pbs[0].to("cpu")
    ct_ext = gang.extend_cluster(ct.to("cpu"), pb)
    st = gang._new_state(ct_ext.requested, int(pb.pod_valid.shape[0]), "cpu")
    kw = dict(limit=64, chunk=2, slot_start=int(ct.epod_valid.shape[0]),
              seed=0, fit_strategy="LeastAllocated", topo_keys=(),
              serial=False, weights=(), enabled_filters=())
    pair = _pair(PORT)
    keys = [gang.converge_key(ct_ext, pb, st, plugins=ps, **kw)
            for ps in ((), pair[:1], pair[1:], pair, pair)]
    assert len(set(keys[:4])) == 4
    assert keys[3] == keys[4]
    # another instance of the same plugin is another plugin
    other = (port_plugins.stripe_filter(MODULUS),)
    assert gang.converge_key(ct_ext, pb, st, plugins=other, **kw) != keys[1]


# ---- the Scheduler's paths ---------------------------------------------------

class _Side:
    """One package's scheduler over its own cache, queue and binder log,
    every pod queued before the first pop and backoff outlasting the test
    (as tests/test_torch_sched.py drives it)."""

    def __init__(self, pkg, cfg_kw, nodes, bound, ns_labels, plugins,
                 warm=None, gates=None):
        self.pkg = pkg
        self.cache = pkg.cache.SchedulerCache(assume_ttl=LONG)
        for name, labels in (ns_labels or {}).items():
            self.cache.update_namespace({"metadata": {"name": name,
                                                      "labels": labels}})
        self.nodes = [d["metadata"]["name"] for d in nodes]
        for d in nodes:
            self.cache.add_node(pkg.types.Node.from_dict(copy.deepcopy(d)))
        for d in bound:
            self.cache.add_pod(pkg.types.Pod.from_dict(copy.deepcopy(d)))
        self.queue = pkg.queue.SchedulingQueue(backoff_initial=LONG,
                                               backoff_max=LONG)
        self.log: dict[str, str] = {}
        cfg = pkg.config.SchedulerConfiguration(
            explainer_enabled=False, parity_sample_every=0, **cfg_kw)
        gate = pkg.features.FeatureGate()
        gate.set_from_map(dict({"PreemptionSimulation": False},
                               **(gates or {})))
        self.sched = pkg.scheduler.Scheduler(
            cfg, self.cache, self.queue, self._bind, feature_gate=gate,
            registry=_registry(pkg, plugins), **pkg.kw)
        self.sched._drain_ready = lambda pend: False
        if warm is not None:
            assert self.sched.warm_drain(
                [pkg.types.Pod.from_dict(copy.deepcopy(d)) for d in warm],
                slot_headroom=256)

    def _bind(self, pod, node):
        self.log[pod.key] = node
        return True

    def drive(self, pods, pops=8) -> None:
        for d in pods:
            self.queue.add(self.pkg.types.Pod.from_dict(copy.deepcopy(d)))
        for _ in range(pops):
            self.sched.run_once(wait=0.01)
        self.sched._resolve_pending()
        self.sched.wait_for_bindings()

    def close(self):
        self.sched.close()


PATHS = {"group": dict(batch_size=8, max_drain_batches=1),
         "drain1": dict(batch_size=8, max_drain_batches=2, pipeline_depth=1),
         "drain2": dict(batch_size=8, max_drain_batches=2, pipeline_depth=2)}


@pytest.mark.parametrize("path,warm", [("group", False), ("drain1", True),
                                       ("drain2", True), ("drain2", False)])
def test_scheduler_with_plugins_equals_reference(path, warm):
    nodes, bound, pending, ns = _cluster(7, pods=48, nodes=20, bound=10)
    warm_pods = pending[:16] if warm else None
    sides = [_Side(pkg, PATHS[path], nodes, bound, ns, _pair(pkg),
                   warm=warm_pods) for pkg in (REF, PORT)]
    # the port without the plugins: its placements must differ
    plain = _Side(PORT, PATHS[path], nodes, bound, ns, (), warm=warm_pods)
    try:
        for s in sides + [plain]:
            s.drive(pending)
        ref, port = sides
        assert port.log == ref.log
        assert len(port.log) >= 24
        if path != "group":
            assert port.sched._drain_ctx is not None
    finally:
        for s in sides + [plain]:
            s.close()
    # the cache rows follow the order the nodes were added
    vetoed = {n for i, n in enumerate(port.nodes) if i % MODULUS == 0}
    assert not vetoed & set(port.log.values())
    assert port.log != plain.log


def test_warm_drain_captures_with_the_profiles_plugins(monkeypatch):
    """The warm ladder's drains take the profile's plugins, as the live
    drain does (on the card they share the graphs only then)."""
    seen = []
    real = gang.drain_step

    def spy(*a, **k):
        seen.append(tuple(p.name for p in k.get("plugins", ())))
        return real(*a, **k)
    from kubernetes_tpu_torch.models import gang as port_gang
    monkeypatch.setattr(port_gang, "drain_step", spy)
    monkeypatch.setattr(port_scheduler, "drain_step", spy, raising=False)
    nodes, bound, pending, ns = _cluster(8, pods=24, nodes=12, bound=4)
    side = _Side(PORT, PATHS["drain1"], nodes, bound, ns, _pair(PORT),
                 warm=pending[:16])
    try:
        side.drive(pending[:16], pops=3)
    finally:
        side.close()
    want = tuple(p.name for p in _pair(PORT))
    assert len(seen) >= 3 and set(seen) == {want}


# ---- the oracle and a tensor filter (a deliberate difference) ---------------

def _broken(*_a, **_k):
    raise RuntimeError("injected device failure")


def test_oracle_requeues_where_a_tensor_filter_would_veto(monkeypatch):
    """The device fails (not fatally), so the batch goes to the oracle.
    The reference's oracle cannot run the tensor filter and binds the pod
    onto the node the filter vetoes; the port's requeues the batch, as
    both do for an extender's veto."""
    monkeypatch.setattr(ref_scheduler, "gang_schedule", _broken)
    monkeypatch.setattr(port_scheduler, "gang_schedule", _broken)
    out = {}
    for pkg in (REF, PORT):
        reg = pkg.fw.Registry().register(pkg.fw.TensorPlugin(
            name="OnlyNodeOne", filter_fn=_only_node_one(pkg)))
        cfg = pkg.config.SchedulerConfiguration(
            explainer_enabled=False, parity_sample_every=0,
            max_drain_batches=1, breaker_threshold=100)
        sched, queue, bound = _build(pkg, cfg=cfg, registry=reg,
                                     n_nodes=3)
        try:
            queue.add(_pod(pkg))
            sched.run_once(wait=0.1)
            sched.wait_for_bindings()
            out[pkg.name] = (dict(bound), queue.stats())
        finally:
            sched.close()
    ref_bound, _ = out["ref"]
    port_bound, port_stats = out["port"]
    # the reference's oracle placed the pod past the veto (not on n1)
    assert ref_bound and ref_bound["default/p0"] != "n1"
    assert port_bound == {}
    assert port_stats["backoff"] + port_stats["unschedulable"] == 1
