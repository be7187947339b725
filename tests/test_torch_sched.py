"""The port's scheduling loop against the JAX package's, on the CPU.

Both sides get the same node and pod dicts, parsed by each package's own
``api``, and each its own ``SchedulerCache``, ``SchedulingQueue`` and
binder log. Every pod is queued before the first ``run_once`` and backoff
outlasts the test, so the sequence of pops is deterministic; churn lands
in both caches between the same pops. The explainer and the parity
sentinel are off and ``PreemptionSimulation`` is off on both sides (the
explainer is held against the reference in ``tests/test_torch_explain.py``,
default preemption in ``tests/test_torch_preemption.py``), so both run the
same loop.

- drain path: placements, ``ctx_stats``, the patch state's ``fill_host``
  and ``top``, and the folded resident ``requested``, ``epod_valid`` and
  ``epod_node`` bit-equal at pipeline depth 1, 2 and 3, fused fold on and
  off, staging on and off; ``fill_bound == fill_host`` once the pipeline
  has drained;
- group and serial paths: placements equal;
- breaker: a failing device degrades to the oracle on both sides, with
  equal placements;
- queue, rescue, and the refusals of what waits for later slices; a pod
  with a resource claim and a slice gang with claims (DRA) schedule as
  the reference schedules them.
"""

from __future__ import annotations

import copy
import dataclasses
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as ref_types
from kubernetes_tpu.config import features as ref_features
from kubernetes_tpu.config import types as ref_config
from kubernetes_tpu.metrics import registry as ref_registry
from kubernetes_tpu.sched import cache as ref_cache
from kubernetes_tpu.sched import queue as ref_queue
from kubernetes_tpu.sched import scheduler as ref_scheduler
from kubernetes_tpu_torch.api import types as port_types
from kubernetes_tpu_torch.config import features as port_features
from kubernetes_tpu_torch.config import types as port_config
from kubernetes_tpu_torch.metrics import registry as port_registry
from kubernetes_tpu_torch.sched import cache as port_cache
from kubernetes_tpu_torch.sched import queue as port_queue
from kubernetes_tpu_torch.sched import scheduler as port_scheduler
from kubernetes_tpu_torch.testing.workloads import relational_mix
from kubernetes_tpu_torch.testing.wrappers import make_node, make_pod

REF = SimpleNamespace(name="ref", types=ref_types, features=ref_features,
                      config=ref_config, cache=ref_cache, queue=ref_queue,
                      scheduler=ref_scheduler, registry=ref_registry,
                      kw={})
PORT = SimpleNamespace(name="port", types=port_types, features=port_features,
                       config=port_config, cache=port_cache, queue=port_queue,
                       scheduler=port_scheduler, registry=port_registry,
                       kw={"device": "cpu"})

# backoff and assume TTL far beyond any test: failed pods never come back
# and assumed pods never expire mid-test, so both sides pop the same pods
LONG = 3600.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy().copy()
    return np.asarray(x).copy()


class _Side:
    """One package's scheduler over its own cache, queue and binder log."""

    def __init__(self, pkg, cfg_kw: dict, gates: dict, nodes, bound,
                 ns_labels=None, warm=None, headroom=256, ready="lazy"):
        self.pkg = pkg
        self.cache = pkg.cache.SchedulerCache(assume_ttl=LONG)
        for name, labels in (ns_labels or {}).items():
            self.cache.update_namespace({"metadata": {"name": name,
                                                      "labels": labels}})
        for d in nodes:
            self.cache.add_node(self.node(d))
        for d in bound:
            self.cache.add_pod(self.pod(d))
        self.queue = pkg.queue.SchedulingQueue(backoff_initial=LONG,
                                               backoff_max=LONG)
        self.log: dict[str, str] = {}
        cfg = pkg.config.SchedulerConfiguration(
            explainer_enabled=False, parity_sample_every=0, **cfg_kw)
        pkg.config.validate(cfg)
        gate = pkg.features.FeatureGate()
        gate.set_from_map(dict({"PreemptionSimulation": False}, **gates))
        self.sched = pkg.scheduler.Scheduler(
            cfg, self.cache, self.queue, self._bind, feature_gate=gate,
            **pkg.kw)
        # When an in-flight drain counts as finished decides where it
        # resolves, and with it whether the next pop sees its folds as
        # resolved (a ctx_stats "reason" can differ, never a placement).
        # "lazy": never early, so drains resolve only at the depth bound
        # and the pipeline's own drains (as if the device were still
        # busy); "eager": at the first look, once its results are in.
        if ready == "lazy":
            self.sched._drain_ready = lambda pend: False
        else:
            self.sched._drain_ready = (
                lambda pend: "done" not in pend or pend["done"].wait(LONG))
        if warm is not None:
            assert self.sched.warm_drain([self.pod(d) for d in warm],
                                         slot_headroom=headroom)
        self.bound = 0

    def node(self, d):
        return self.pkg.types.Node.from_dict(copy.deepcopy(d))

    def pod(self, d):
        return self.pkg.types.Pod.from_dict(copy.deepcopy(d))

    def _bind(self, pod, node):
        self.log[pod.key] = node
        return True

    def churn(self, events) -> None:
        for op, *args in events:
            if op == "node":
                self.cache.add_node(self.node(args[0]))
            elif op == "nodedel":
                self.cache.remove_node(args[0])
            elif op == "pod":
                self.cache.add_pod(self.pod(args[0]))
            elif op == "poddel":
                self.cache.remove_pod(args[0])
            elif op == "nominate":
                self.sched.nominate_external(self.pod(args[0]), args[1])
            else:
                raise ValueError(op)

    def drive(self, pods, churn, extra=4) -> None:
        """Queue every pod, then one run_once per churn step (the step's
        events land first) and ``extra`` more; then drain the pipeline."""
        for d in pods:
            self.queue.add(self.pod(d))
        for i in range(len(churn) + extra):
            if i < len(churn):
                self.churn(churn[i])
            self.bound += self.sched.run_once(wait=0.01)
        self.bound += self.sched._resolve_pending()
        self.sched.wait_for_bindings()

    def ctx_record(self) -> dict:
        ctx = self.sched._drain_ctx
        if ctx is None:
            return {}
        cs, ct = ctx["cs"], ctx["ct"]
        return {"fill_host": cs.fill_host, "top": cs.top,
                "fill_bound": ctx["fill_bound"],
                "folded": dict(cs.folded),
                "requested": _np(ct.requested),
                "epod_valid": _np(ct.epod_valid),
                "epod_node": _np(ct.epod_node),
                "nom_valid": _np(ct.nom_valid),
                "nom_node": _np(ct.nom_node)}

    def close(self) -> None:
        self.sched.close()


def _twins(cfg_kw, gates=None, **kw):
    return [_Side(pkg, cfg_kw, gates or {}, **kw) for pkg in (REF, PORT)]


def _assert_same_ctx(ref: dict, port: dict) -> None:
    assert set(ref) == set(port)
    for k in ref:
        if isinstance(ref[k], np.ndarray):
            assert ref[k].dtype == port[k].dtype, k
            assert np.array_equal(ref[k], port[k]), k
        else:
            assert ref[k] == port[k], k


# ---- the drain path, with churn between pops --------------------------------

def _drain_workload(seed=0):
    """A relational_mix cluster (16 nodes, 12 bound pods) and 80 of its
    pending pods (16 of them first, then 64 without host port or volume);
    churn between the pops: Recreate churn (a 2-cpu node and a foreign pod
    bound to it, the oldest of each deleted past 2), a nominee held from
    the first pop and cleared at the fourth."""
    nodes, bound, pending, ns_labels = relational_mix(pods=160, nodes=16,
                                                      bound=12, seed=seed)
    # the first pop's host-port pods taint the fold (a rebuild follows);
    # the rest carry no host port and no volume, so their pops fold
    clean = [p for p in pending[16:]
             if not p.host_ports() and not p.spec.volumes]
    pending = pending[:16] + clean[:64]
    nominee = (make_pod("nominee", "churn").req({"cpu": "3"})
               .priority(0).obj().to_dict())
    churn, live_nodes, live_pods = [], [], []
    for i in range(6):
        step = []
        if i == 0:
            step.append(("nominate", nominee, "node-0"))
        if i == 3:
            step.append(("nominate", nominee, ""))
        step.append(("node", make_node(f"churn-n{i}").capacity(
            {"cpu": "2", "memory": "4Gi", "pods": "8"}).obj().to_dict()))
        step.append(("pod", make_pod(f"churn-p{i}", "churn")
                     .req({"cpu": "100m"}).node(f"churn-n{i}").obj()
                     .to_dict()))
        live_nodes.append(f"churn-n{i}")
        live_pods.append(f"churn/churn-p{i}")
        if len(live_nodes) > 2:
            step.append(("nodedel", live_nodes.pop(0)))
        if len(live_pods) > 2:
            step.append(("poddel", live_pods.pop(0)))
        churn.append(step)
    return ([n.to_dict() for n in nodes], [p.to_dict() for p in bound],
            [p.to_dict() for p in pending], ns_labels, churn)


def _warm_pods(n):
    return [make_pod(f"__warm{i}").req({"cpu": "100m"}).obj().to_dict()
            for i in range(n)]


@pytest.mark.parametrize("depth,fused,staging,ready,warm", [
    (1, True, True, "lazy", "sample"), (2, True, True, "lazy", "sample"),
    (3, True, True, "lazy", "sample"), (1, False, True, "lazy", "sample"),
    (2, False, False, "lazy", "sample"), (3, True, False, "lazy", "sample"),
    (2, True, False, "lazy", "sample"), (3, False, True, "lazy", "sample"),
    # armed with narrow pods: wider pops rebuild ("batch_shape")
    (2, True, True, "eager", "narrow"), (3, False, False, "eager", "narrow")])
def test_drain_path_with_churn_equals_reference(depth, fused, staging,
                                                ready, warm):
    nodes, bound, pending, ns_labels, churn = _drain_workload()
    cfg = dict(batch_size=8, max_drain_batches=2, pipeline_depth=depth,
               fused_fold=fused, staging_arena=staging)
    sides = _twins(cfg, nodes=nodes, bound=bound, ns_labels=ns_labels,
                   warm=pending[:16] if warm == "sample" else _warm_pods(8),
                   ready=ready)
    try:
        for s in sides:
            s.drive(pending, churn)
        ref, port = sides
        assert port.log == ref.log
        assert port.bound == ref.bound
        assert port.sched.ctx_stats == ref.sched.ctx_stats
        assert port.queue.stats() == ref.queue.stats()
        rec = port.ctx_record()
        _assert_same_ctx(ref.ctx_record(), rec)
        # the pipeline has drained: every dispatch-side reservation either
        # folded or was released
        assert rec["fill_bound"] == rec["fill_host"] <= rec["top"]
        # the churn really exercised the resident context
        stats = port.sched.ctx_stats
        assert stats["folds" if fused else "patches"] >= 3
        assert len(port.log) >= 40
    finally:
        for s in sides:
            s.close()


def test_drain_staging_counts_swaps():
    """With the arena on, every dispatch of the port swaps a staged batch
    (warm_drain's included); with it off, none is submitted."""
    nodes, bound, pending, ns_labels, churn = _drain_workload(seed=1)
    for staging in (True, False):
        cfg = dict(batch_size=8, max_drain_batches=2, staging_arena=staging)
        side = _Side(PORT, cfg, {}, nodes, bound, ns_labels,
                     warm=_warm_pods(8))
        try:
            side.drive(pending, churn)
            st = side.cache.staging_stats()
            assert st["enabled"] is staging
            assert st["fallbacks"] == 0 and st["inflight"] == 0
            if staging:
                assert st["swaps"] == st["submits"] >= 4
                assert st["bytesStaged"] > 0
            else:
                assert st["submits"] == st["swaps"] == 0
        finally:
            side.close()


# ---- the group and serial paths ---------------------------------------------

@pytest.mark.parametrize("serial", [False, True], ids=["group", "serial"])
def test_group_path_equals_reference(serial):
    """Shallow pops (max_drain_batches 1, no armed context) take the
    per-batch group path; with TPUBatchScheduling off every pop is serial."""
    nodes, bound, pending, ns_labels = relational_mix(pods=40, nodes=12,
                                                      bound=10, seed=3)
    cfg = dict(batch_size=8, max_drain_batches=1)
    gates = {"TPUBatchScheduling": False} if serial else {}
    sides = _twins(cfg, gates, nodes=[n.to_dict() for n in nodes],
                   bound=[p.to_dict() for p in bound], ns_labels=ns_labels)
    try:
        for s in sides:
            s.drive([p.to_dict() for p in pending], [], extra=6)
        ref, port = sides
        assert port.log == ref.log
        assert port.bound == ref.bound == len(ref.log) >= 20
        assert port.sched._drain_ctx is None
        assert port.queue.stats() == ref.queue.stats()
    finally:
        for s in sides:
            s.close()


# ---- the circuit breaker ----------------------------------------------------

def _broken(*_a, **_k):
    raise RuntimeError("injected device failure")


@pytest.mark.parametrize("broken", ["drain", "device"])
def test_breaker_fallbacks_equal_reference(monkeypatch, broken):
    """``drain``: drain_step raises, so every deep pop falls back to the
    per-batch path (the breaker counts the drain's failure, the group
    program's success resets it). ``device``: the group program raises
    too, so each batch runs on the oracle and the breaker counts a failure
    per program; past breaker_threshold the loop runs the oracle directly.
    Placements, breaker mode and loop errors equal the reference's."""
    from kubernetes_tpu.models import gang as ref_gang
    from kubernetes_tpu_torch.models import gang as port_gang
    monkeypatch.setattr(ref_gang, "drain_step", _broken)
    monkeypatch.setattr(port_gang, "drain_step", _broken)
    if broken == "device":
        monkeypatch.setattr(ref_scheduler, "gang_schedule", _broken)
        monkeypatch.setattr(port_scheduler, "gang_schedule", _broken)
    nodes, bound, pending, ns_labels = relational_mix(pods=48, nodes=12,
                                                      bound=10, seed=5)
    cfg = dict(batch_size=8, max_drain_batches=2, breaker_threshold=3,
               breaker_cooldown_s=LONG)
    errors0 = {pkg.name: pkg.registry.LOOP_ERRORS.items()
               for pkg in (REF, PORT)}
    sides = _twins(cfg, nodes=[n.to_dict() for n in nodes],
                   bound=[p.to_dict() for p in bound], ns_labels=ns_labels)
    try:
        for s in sides:
            s.drive([p.to_dict() for p in pending], [], extra=5)
        ref, port = sides
        assert port.log == ref.log
        assert len(port.log) >= 24
        want_mode = "oracle" if broken == "device" else "single"
        assert port.sched.breaker.mode == ref.sched.breaker.mode == want_mode
        errors = {}
        for s in sides:
            now = s.pkg.registry.LOOP_ERRORS.items()
            errors[s.pkg.name] = {k: v - errors0[s.pkg.name].get(k, 0)
                                  for k, v in now.items()
                                  if v != errors0[s.pkg.name].get(k, 0)}
        assert errors["port"] == errors["ref"]
        assert errors["port"][(("site", "device_drain"),)] >= 1
        assert port.queue.stats() == ref.queue.stats()
    finally:
        for s in sides:
            s.close()


# ---- the queue --------------------------------------------------------------

def test_queue_sequence_equals_reference():
    """The same add / fail / park / delete / pop sequence gives the same
    pops and stats on both queues."""
    nodes, bound, pending, _ = relational_mix(pods=24, nodes=4, bound=2,
                                              seed=2)
    out = {}
    for pkg in (REF, PORT):
        q = pkg.queue.SchedulingQueue(backoff_initial=LONG, backoff_max=LONG)
        pods = [pkg.types.Pod.from_dict(p.to_dict()) for p in pending]
        trace = []
        for p in pods[:16]:
            q.add(p)
        got = q.pop_batch(6, wait=0.0)
        trace.append([(p.key, a) for p, a in got])
        for p, a in got[:3]:
            q.add_unschedulable(p, a + 1)
        q.park_unschedulable(*got[3])
        q.delete(pods[10])
        for p in pods[16:]:
            q.add(p)
        q.add(got[4][0], attempts=2)
        trace.append(q.stats())
        for _ in range(3):
            trace.append([(p.key, a) for p, a in q.pop_batch(5, wait=0.0)])
        trace.append(q.stats())
        out[pkg.name] = trace
    assert out["port"] == out["ref"]
    assert out["port"][-1]["backoff"] == 3


# ---- the rescue of a popped batch -------------------------------------------

def test_mid_cycle_failure_requeues_popped_pods(monkeypatch):
    """An exception in the middle of a cycle escapes run_once, and every
    popped pod that is neither assumed nor bound is back in a queue — on
    both sides alike."""
    nodes, bound, pending, ns_labels = relational_mix(pods=20, nodes=8,
                                                      bound=4, seed=4)
    sides = _twins(dict(batch_size=8, max_drain_batches=2),
                   nodes=[n.to_dict() for n in nodes],
                   bound=[p.to_dict() for p in bound], ns_labels=ns_labels)
    try:
        stats = []
        for s in sides:
            for p in pending:
                s.queue.add(s.pod(p.to_dict()))
            monkeypatch.setattr(s.cache, "encode_pods", _broken)
            with pytest.raises(RuntimeError, match="injected"):
                s.sched.run_once(wait=0.01)
            stats.append(s.queue.stats())
        assert stats[0] == stats[1]
        assert stats[1]["active"] == 4 and stats[1]["backoff"] == 16
        assert not sides[1].log
    finally:
        for s in sides:
            s.close()


# ---- what waits for later slices --------------------------------------------

def _port_sched(cfg_kw=None, gates=None, nodes=2, **kw):
    cache = port_cache.SchedulerCache()
    for i in range(nodes):
        cache.add_node(make_node(f"n{i}").capacity(
            {"cpu": "1", "memory": "2Gi", "pods": "8"}).obj())
    queue = port_queue.SchedulingQueue(backoff_initial=LONG,
                                       backoff_max=LONG)
    cfg = port_config.SchedulerConfiguration(
        **dict(dict(explainer_enabled=False, parity_sample_every=0,
                    batch_size=4, max_drain_batches=2), **(cfg_kw or {})))
    gate = port_features.FeatureGate()
    gate.set_from_map(gates or {"PreemptionSimulation": False})
    return port_scheduler.Scheduler(cfg, cache, queue, lambda p, n: True,
                                    feature_gate=gate, device="cpu", **kw)


# config options an earlier slice refused, each with the ROADMAP item it
# waited for; a mesh (item 8) is now taken and run single-device, as the
# reference's scheduler runs a mesh it has too few devices for (the
# explainer, item 5, and extenders, item 3c, were refused until their
# slices: their cases check that the option is taken and built)
_WAITING_OPTIONS = [
    ({"mesh_shape": (1, 2)}, "item 8"),
]

# options an earlier slice refused and this one ports
_PORTED_OPTIONS = [
    {"explainer_enabled": True},
    {"extenders": [{"urlPrefix": "http://localhost:1",
                    "filterVerb": "filter"}]},
]


def _ported_cfg_kw(cfg_kw):
    """The option as a configuration file states it (extenders parse into
    ExtenderConfig there)."""
    if "extenders" in cfg_kw:
        return {"extenders": port_config.SchedulerConfiguration.from_dict(
            {"extenders": cfg_kw["extenders"]}).extenders}
    return cfg_kw


@pytest.mark.parametrize("cfg_kw,item", _WAITING_OPTIONS, ids=["mesh"])
def test_construction_refuses_what_waits(cfg_kw, item, caplog):
    """The mesh is no longer refused: the Scheduler is built, warns that
    it runs single-device, and schedules there."""
    from kubernetes_tpu_torch.metrics.registry import MESH_DEVICES
    with caplog.at_level("WARNING"):
        sched = _port_sched(cfg_kw)
    try:
        assert "running single-device" in caplog.text
        assert MESH_DEVICES.get() == 1
        sched.queue.add(port_types.Pod.from_dict(
            make_pod("p0").req({"cpu": "100m"}).obj().to_dict()))
        bound = sched.run_once(wait=0.01) + sched._resolve_pending()
        assert bound == 1
    finally:
        sched.close()


@pytest.mark.parametrize("cfg_kw", _PORTED_OPTIONS,
                         ids=["explainer", "extenders"])
def test_ported_options_build(cfg_kw):
    sched = _port_sched(_ported_cfg_kw(cfg_kw))
    try:
        if "extenders" in cfg_kw:
            assert [e.cfg.url_prefix for e in sched._extenders] \
                == ["http://localhost:1"]
            assert sched._extender_bind is not None
        else:
            assert sched.explainer is not None
    finally:
        sched.close()


def _claim_twins(cfg_kw, nodes, dra_objs):
    """Both packages' schedulers over ``nodes`` with the same DRA objects
    fed to each cache, as the runner's informers feed them."""
    sides = _twins(cfg_kw, nodes=nodes, bound=[])
    for s in sides:
        for kind, obj in dra_objs:
            s.cache.update_dra_object(kind, copy.deepcopy(obj))
    return sides


def test_slice_gang_with_claims_schedules_as_reference():
    """A slice gang whose pods carry resource claims (DRA, ported) is
    carved and bound as the reference carves and binds it: the members'
    devices come from the slices of a 2x1x1 torus."""
    from kubernetes_tpu_torch.testing import workloads
    from kubernetes_tpu_torch.topology.slicing import (GANG_LABEL,
                                                      SLICE_SHAPE_LABEL,
                                                      topology_labels)
    nodes = []
    for x in range(2):
        w = make_node(f"t{x}").capacity({"cpu": "4", "memory": "8Gi",
                                         "pods": "8"})
        for k, v in topology_labels(x, 0, 0).items():
            w = w.label(k, v)
        nodes.append(w.obj().to_dict())
    objs = [("ResourceSlice", workloads.resource_slice(f"t{x}", 1,
                                                       cls="tpu"))
            for x in range(2)]
    objs += [("ResourceClaim", workloads.resource_claim(f"claim-{m}",
                                                        cls="tpu"))
             for m in range(2)]
    pods = [workloads.with_claim(
        make_pod(f"s{m}").req({"cpu": "100m"})
        .label(SLICE_SHAPE_LABEL, "2x1x1").label(GANG_LABEL, "g")
        .obj().to_dict(), f"claim-{m}") for m in range(2)]
    sides = _claim_twins({"batch_size": 4}, nodes, objs)
    try:
        for s in sides:
            s.drive(pods, [], extra=2)
        ref, port = sides
        assert port.log == ref.log
        assert sorted(port.log.values()) == ["t0", "t1"]
    finally:
        for s in sides:
            s.close()


def test_dra_claim_pod_schedules_as_reference():
    """A pod with a resource claim (DRA, ported) schedules as the
    reference schedules it: onto the node whose ResourceSlice publishes
    the device, and the cache takes DRA objects."""
    from kubernetes_tpu_torch.testing import workloads
    nodes = [make_node(f"n{i}").capacity(
        {"cpu": "1", "memory": "2Gi", "pods": "8"}).obj().to_dict()
        for i in range(2)]
    objs = [("DeviceClass", workloads.device_class("gpu")),
            ("ResourceSlice", workloads.resource_slice("n1", 1, cls="gpu")),
            ("ResourceClaim", workloads.resource_claim("claim-0",
                                                       cls="gpu"))]
    claimed = workloads.with_claim(
        make_pod("claimed").req({"cpu": "100m"}).obj().to_dict(), "claim-0")
    plain = make_pod("plain").req({"cpu": "100m"}).obj().to_dict()
    sides = _claim_twins({"batch_size": 4}, nodes, objs)
    try:
        for s in sides:
            s.drive([claimed, plain], [], extra=2)
        ref, port = sides
        assert port.log == ref.log
        assert port.log["default/claimed"] == "n1"
        assert set(port.cache.dra_catalog.classes) == {"gpu"}
    finally:
        for s in sides:
            s.close()


def test_accepts_fleet_mode_and_tensor_plugins():
    from kubernetes_tpu_torch.sched.framework import Registry, TensorPlugin
    sched = _port_sched()
    try:
        # fleet mode (item 7b) is ported: its chunks are no longer refused
        # (tests/test_torch_fleet.py holds them against the reference)
        sched.fleet_mode = True
        assert sched._tenant_chunks([], 4) == []
    finally:
        sched.close()
    # out-of-tree tensor plugins (item 12) are ported: a registry holding
    # one is taken (tests/test_torch_plugins.py holds placements against
    # the reference), and a profile naming an unregistered one is refused
    # as the reference refuses it
    reg = Registry()
    reg.register(TensorPlugin(name="Extra",
                              score_fn=lambda ct, pb, tk: torch.zeros(1)))
    sched = _port_sched(registry=reg)
    try:
        assert [p.name for p in sched._tensor_plugins(None)] == ["Extra"]
    finally:
        sched.close()
    with pytest.raises(ValueError, match="unregistered"):
        _port_sched(cfg_kw={"profiles": [port_config.Profile(
            out_of_tree=["Missing"])]}, registry=reg)


@pytest.mark.parametrize("cfg_kw,item", _WAITING_OPTIONS, ids=["mesh"])
def test_validate_refuses_what_waits(cfg_kw, item):
    """A mesh validates as the reference validates it (power-of-two axes,
    a pods axis dividing batchSize) and is no longer refused."""
    port_config.validate(port_config.SchedulerConfiguration(**cfg_kw))
    for bad in ((1, 3), (4, 1)):
        with pytest.raises(port_config.ValidationError):
            port_config.validate(port_config.SchedulerConfiguration(
                mesh_shape=bad, batch_size=2))


@pytest.mark.parametrize("cfg_kw", _PORTED_OPTIONS,
                         ids=["explainer", "extenders"])
def test_ported_options_validate(cfg_kw):
    port_config.validate(
        port_config.SchedulerConfiguration(**_ported_cfg_kw(cfg_kw)))


def test_default_config_builds_a_scheduler():
    """The port's defaults leave the unported features off (the parity
    sentinel and the explainer are ported and on, as in the reference), so
    the default configuration validates and builds a Scheduler."""
    cfg = port_config.SchedulerConfiguration()
    port_config.validate(cfg)
    sched = port_scheduler.Scheduler(
        cfg, port_cache.SchedulerCache(), port_queue.SchedulingQueue(),
        lambda p, n: True, device="cpu")
    sched.close()


def test_run_lets_refusals_escape(monkeypatch):
    """``run`` retries a failed cycle, but not a refusal: a retry cannot
    cure it. The popped pod is back in a queue. The refusal is injected
    where a cycle chooses its path (no feature of the done slices refuses
    on this path any more)."""
    sched = _port_sched()
    stop = threading.Event()
    timer = threading.Timer(30.0, stop.set)  # a loop that swallows it ends
    timer.start()

    def refused(pod):
        raise port_config.not_ported("API priority and fairness", "13")
    monkeypatch.setattr(sched, "_slice_shape_of", refused)
    try:
        sched.queue.add(port_types.Pod.from_dict(
            make_pod("p0").req({"cpu": "100m"}).obj().to_dict()))
        with pytest.raises(NotImplementedError, match="item 13"):
            sched.run(stop)
        assert not stop.is_set()
        assert sched.queue.stats()["backoff"] == 1
    finally:
        timer.cancel()
        sched.close()


# ---- a kernel that fails is not degraded around ------------------------------

@pytest.mark.parametrize("path", ["drain", "group", "run"])
def test_kernel_failure_escapes_the_breaker(monkeypatch, path):
    """A ``count_pn`` that does not build or launch raises ``KernelError``.
    It leaves ``run_once`` (and ``run``) as it came: the breaker counts no
    failure, no pod goes through the numpy oracle, and the popped pods are
    back in a queue. ``drain``: a pop of two batches on the resident drain;
    ``group``: one batch on the per-batch path."""
    from kubernetes_tpu_torch.ops import topology as port_topology
    from kubernetes_tpu_torch.ops.kernels import KernelError
    nodes, bound, pending, ns_labels = relational_mix(pods=24, nodes=8,
                                                      bound=4, seed=3)
    launches = []

    def broken_count_pn(*args, **kwargs):
        launches.append(1)
        raise KernelError("count_pn launch failed: CUDA error 700")

    side = _Side(PORT, dict(batch_size=8, breaker_threshold=1,
                            max_drain_batches=1 if path == "group" else 2),
                 {}, nodes=[n.to_dict() for n in nodes],
                 bound=[p.to_dict() for p in bound], ns_labels=ns_labels)
    oracle = []
    monkeypatch.setattr(port_topology, "_count_pn", broken_count_pn)
    monkeypatch.setattr(side.sched, "_schedule_oracle",
                        lambda *a: oracle.append(a) or 0)
    stop = threading.Event()
    timer = threading.Timer(30.0, stop.set)
    timer.start()
    errors0 = port_registry.LOOP_ERRORS.items()
    try:
        for p in pending:
            side.queue.add(side.pod(p.to_dict()))
        with pytest.raises(KernelError, match="CUDA error 700"):
            if path == "run":
                side.sched.run(stop)
            else:
                side.sched.run_once(wait=0.01)
        assert launches and not oracle and not side.log
        assert not stop.is_set()
        assert side.sched.breaker.mode == "single"
        assert side.sched.breaker.trips == 0
        assert side.sched._drain_ctx is None
        assert port_registry.LOOP_ERRORS.items() == errors0
        stats = side.queue.stats()
        assert sum(stats.values()) == len(pending)
        assert stats["backoff"] == (8 if path == "group" else 16)
    finally:
        timer.cancel()
        side.close()


# ---- the resident shadow through churn --------------------------------------

@pytest.mark.parametrize("fused", [True, False], ids=["fused", "legacy"])
def test_resident_shadow_follows_context_like_reference(fused):
    """After the churn run, the port's host shadow (winner folds caught up)
    equals its resident context's allocatable/requested and the reference
    scheduler's shadow."""
    nodes, bound, pending, ns_labels, churn = _drain_workload(seed=2)
    cfg = dict(batch_size=8, max_drain_batches=2, pipeline_depth=2,
               fused_fold=fused)
    sides = _twins(cfg, nodes=nodes, bound=bound, ns_labels=ns_labels,
                   warm=pending[:16])
    try:
        got = []
        for s in sides:
            s.drive(pending, churn)
            ctx = s.sched._drain_ctx
            cs, shadow = ctx["cs"], ctx["shadow"]
            shadow.catch_up(lambda p, c=s.cache, cs=cs:
                            c.request_vector(p, cs.resources))
            arrays = shadow.arrays()
            assert arrays is not None, s.pkg.name
            got.append((ctx, [a.copy() for a in arrays]))
        (_, ref), (pctx, port) = got
        for a, b in zip(ref, port):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        alloc, req = port
        assert np.array_equal(alloc, _np(pctx["ct"].allocatable))
        assert np.array_equal(req, _np(pctx["ct"].requested))
        assert sides[1].sched.ctx_stats["folds" if fused else "patches"] >= 3
    finally:
        for s in sides:
            s.close()


# ---- utils/sanity.py: plain torch checks ------------------------------------

def test_sanity_checks_match_reference():
    """``checked_evaluate`` returns the step's result after its NaN and
    bounds checks (the reference instruments the program with checkify);
    ``check_step_result`` and ``check_assignment`` report what the
    reference's report on the same step."""
    from kubernetes_tpu.encode.snapshot import SnapshotEncoder as RefEncoder
    from kubernetes_tpu.models.schedule_step import evaluate as ref_evaluate
    from kubernetes_tpu.utils import sanity as ref_sanity
    from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
    from kubernetes_tpu_torch.models.schedule_step import evaluate
    from kubernetes_tpu_torch.utils import sanity
    nodes, bound, pending, ns = relational_mix(pods=16, nodes=8, bound=4,
                                               seed=6)
    out = {}
    for name, enc_cls, ev, mod, tree in (
            ("ref", RefEncoder, ref_evaluate, ref_sanity,
             lambda x: x),
            ("port", SnapshotEncoder, evaluate, sanity,
             lambda x: x.to("cpu"))):
        types = ref_types if name == "ref" else port_types
        enc = enc_cls()
        enc.set_namespaces(ns)
        pend = [types.Pod.from_dict(p.to_dict()) for p in pending]
        ct, meta = enc.encode_cluster(
            [types.Node.from_dict(n.to_dict()) for n in nodes],
            [types.Pod.from_dict(p.to_dict()) for p in bound],
            pending_pods=pend)
        pb = enc.encode_pods(pend, meta)
        res = ev(tree(ct), tree(pb), topo_keys=meta.topo_keys)
        out[name] = (np.asarray(res.choice), np.asarray(res.assigned),
                     mod.check_step_result(res, len(nodes)),
                     mod.check_assignment(np.asarray([0, -1, 7, 9]), 8))
        if name == "port":
            checked = sanity.checked_evaluate(ct.to("cpu"), pb.to("cpu"),
                                              topo_keys=meta.topo_keys)
            assert torch.equal(checked.choice, res.choice)
            bad = res.scores.clone()
            bad[0, 0] = float("nan")
            assert sanity.check_step_result(
                dataclasses.replace(res, scores=bad), len(nodes))
    assert np.array_equal(out["ref"][0], out["port"][0])
    assert np.array_equal(out["ref"][1], out["port"][1])
    assert out["ref"][2:] == out["port"][2:]
    assert out["port"][2] == [] and out["port"][3]
