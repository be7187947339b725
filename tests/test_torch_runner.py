"""The port's connected scheduler (``sched/runner.SchedulerRunner``) against
the JAX package's, on the CPU.

Each side gets its own ``ObjectStore`` holding the same nodes, namespaces,
bound and pending pods, and its own runner over a ``DirectClient``. The
runner's informers sync with the loop stopped (``start(start_loop=False)``),
so every pod reaches the queue — and the encode cache, at informer time —
before the first pop; the test then calls ``run_once`` until the queue and
the pipeline are empty. Whether a finished drain resolves at the next pop's
start depends on the resolver thread's timing, so both sides hold it until
the depth bound (as ``tests/test_torch_sched.py`` does). The explainer (a
later slice) and ``PreemptionSimulation`` are off on both sides (default
preemption through the runner is held against the reference in
``tests/test_torch_preemption.py``), the port's parity sentinel samples
every drain, and the auditor sweeps at the end.

Two differences from the reference's sentinel, pinned here: it skips
winners with a ``DoNotSchedule`` spread constraint (the reference's
full-set check refutes a correct one on ``relational_mix``: ROADMAP
Queue C), and a refutation stops the runner with a ``ParityError`` where
the reference trips its breaker to the oracle.

- bindings in the store, ``ctx_stats`` and the folded resident context
  bit-equal at pipeline depth 1 and 2, on ``relational_mix`` (24 nodes) and
  MixedHeterogeneous (32 nodes x 192 pods); 0 violations on both sides;
  the port's sentinel samples with 0 divergences on both workloads, and
  its samples equal the reference's on MixedHeterogeneous (on
  ``relational_mix`` the reference runs with its sentinel off, since its
  false refutation would move it to the oracle);
- the hard-spread case itself: the reference's check refutes it, the
  port's skips it, and both refute a winner that breaks a node selector;
- a refuted drain stops the runner for good with a ``ParityError``: no
  revive, no oracle, and ``stop()`` raises it;
- the pods were compiled at informer time: the encode cache hits at pop
  time;
- leader election: two port runners on one store, exactly one binds;
- a ``KernelError`` in the loop stops the runner for good: no revive, no
  oracle, and ``stop()`` raises it;
- over HTTP (the port's ``APIServer``, JSON and msgpack): the same bindings
  as over the ``DirectClient``.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import pytest
import torch

from kubernetes_tpu.client import clientset as ref_clientset
from kubernetes_tpu.config import features as ref_features
from kubernetes_tpu.config import types as ref_config
from kubernetes_tpu.sched import runner as ref_runner
from kubernetes_tpu.store import store as ref_store
from kubernetes_tpu_torch.client import clientset as port_clientset
from kubernetes_tpu_torch.config import features as port_features
from kubernetes_tpu_torch.config import types as port_config
from kubernetes_tpu_torch.sched import runner as port_runner
from kubernetes_tpu_torch.store import apiserver as port_apiserver
from kubernetes_tpu_torch.store import store as port_store
from kubernetes_tpu_torch.testing.workloads import (mixed_heterogeneous,
                                                    relational_mix)

# backoff, assume TTL and audit cadence far beyond any test
LONG = 3600.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def _no_ref_preemption():
    """The JAX runner builds its Scheduler on the package's default feature
    gate: turn default preemption off there for the test (the port's
    runner takes a gate)."""
    gate = ref_features.DEFAULT_FEATURE_GATE
    was = gate.enabled("PreemptionSimulation")
    gate.set_from_map({"PreemptionSimulation": False})
    yield
    gate.set_from_map({"PreemptionSimulation": was})


def _port_gate():
    gate = port_features.FeatureGate()
    gate.set_from_map({"PreemptionSimulation": False})
    return gate


def _cfg(pkg_config, **kw):
    return pkg_config.SchedulerConfiguration(**dict(
        dict(explainer_enabled=False, parity_sample_every=1,
             backoff_initial_s=LONG, backoff_max_s=LONG, assume_ttl_s=LONG,
             audit_interval_s=LONG), **kw))


def _workload(name: str):
    """-> (nodes, bound, pending, namespace labels) as wire dicts."""
    if name == "relational":
        nodes, bound, pending, ns = relational_mix(pods=64, nodes=24,
                                                   bound=24, seed=1)
    else:
        nodes, pending = mixed_heterogeneous(pods=192, nodes=32, seed=0)
        bound, ns = [], {}
    return ([n.to_dict() for n in nodes], [p.to_dict() for p in bound],
            [p.to_dict() for p in pending], ns)


def _seed(client, nodes, bound, pending, ns_labels) -> None:
    for name, labels in sorted(ns_labels.items()):
        client.resource("namespaces", None).create(
            {"kind": "Namespace", "metadata": {"name": name,
                                               "labels": labels}})
    client.nodes().create_many(copy.deepcopy(nodes))
    for pods in (bound, pending):
        by_ns: dict = {}
        for p in pods:
            by_ns.setdefault(p["metadata"]["namespace"], []).append(
                copy.deepcopy(p))
        for ns in sorted(by_ns):
            client.pods(ns).create_many(by_ns[ns])


def _wait(cond, timeout=30.0, what="condition"):
    end = time.time() + timeout
    while not cond():
        if time.time() > end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def _drive(runner) -> None:
    """Informers synced with the loop stopped, then run_once until the
    queue and the pipeline are empty, the bindings landed."""
    runner.start(start_loop=False)
    _wait(lambda: all(inf.has_synced()
                      for inf in runner.factory._informers.values()),
          what="informer sync")  # the JAX runner has no has_synced()
    sched = runner.scheduler
    sched._drain_ready = lambda pend: False  # resolve at the depth bound
    for _ in range(64):
        sched.run_once(wait=0.01)
        if sched.sentinel is not None:
            # land the verdicts of this pop's samples before the next pop:
            # a refuted answer trips the breaker at the same point on
            # both sides
            sched.sentinel.drain(30.0)
        if runner.queue.stats()["active"] == 0 and not sched._pending:
            break
    sched._resolve_pending()
    sched.wait_for_bindings()


def _bindings(client) -> dict:
    return {f"{p['metadata']['namespace']}/{p['metadata']['name']}":
            p["spec"].get("nodeName", "")
            for p in client.pods(None).list()}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy().copy()
    return np.asarray(x).copy()


def _ctx_record(sched) -> dict:
    ctx = sched._drain_ctx
    if ctx is None:
        return {}
    cs, ct = ctx["cs"], ctx["ct"]
    return {"fill_host": cs.fill_host, "top": cs.top,
            "folded": dict(cs.folded),
            "requested": _np(ct.requested),
            "epod_valid": _np(ct.epod_valid),
            "epod_node": _np(ct.epod_node)}


def _settle_and_check_audit(runner) -> dict:
    """Two sweeps (confirm-2 invariants need consecutive looks), the
    sentinel's verdicts landed. -> the sentinel's stats."""
    runner.scheduler.wait_for_bindings()
    _wait(lambda: not runner.cache.audit_view()["assumed"],
          what="bind confirmations")
    for _ in range(2):
        runner.auditor.run_once()
    assert runner.auditor.total_violations == 0
    sentinel = runner.scheduler.sentinel
    if sentinel is None:
        return None
    sentinel.drain(30.0)
    return sentinel.stats()


def _run_side(pkg: str, workload, depth: int, parity_every: int = 1) -> dict:
    nodes, bound, pending, ns = workload
    kw = dict(batch_size=16, max_drain_batches=2, pipeline_depth=depth,
              parity_sample_every=parity_every)
    if pkg == "ref":
        client = ref_clientset.DirectClient(ref_store.ObjectStore())
        _seed(client, nodes, bound, pending, ns)
        runner = ref_runner.SchedulerRunner(client, _cfg(ref_config, **kw))
    else:
        client = port_clientset.DirectClient(port_store.ObjectStore())
        _seed(client, nodes, bound, pending, ns)
        runner = port_runner.SchedulerRunner(
            client, _cfg(port_config, **kw), feature_gate=_port_gate(),
            device="cpu")
    try:
        _drive(runner)
        parity = _settle_and_check_audit(runner)
        assert getattr(runner, "loop_error", None) is None
        return {"bindings": _bindings(client),
                "ctx_stats": copy.deepcopy(runner.scheduler.ctx_stats),
                "ctx": _ctx_record(runner.scheduler),
                "parity": parity,
                "breaker": runner.scheduler.breaker.mode}
    finally:
        runner.stop()


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("name", ["relational", "mixed"])
def test_runner_matches_reference(name, depth, _no_ref_preemption):
    workload = _workload(name)
    # the reference's sentinel refutes a correct hard-spread winner on
    # relational_mix and trips to the oracle (ROADMAP Queue C): run it
    # without its sentinel there, so both sides stay on the device path
    ref = _run_side("ref", workload, depth,
                    parity_every=0 if name == "relational" else 1)
    port = _run_side("port", workload, depth)
    assert port["bindings"] == ref["bindings"]
    n_pending = len(workload[2])
    placed = sum(1 for p in workload[2]
                 if ref["bindings"][f"{p['metadata']['namespace']}/"
                                    f"{p['metadata']['name']}"])
    assert placed >= n_pending // 2, "the workload barely schedules"
    assert port["ctx_stats"] == ref["ctx_stats"]
    assert set(port["ctx"]) == set(ref["ctx"])
    for k, want in ref["ctx"].items():
        if isinstance(want, np.ndarray):
            assert port["ctx"][k].dtype == want.dtype, k
            assert np.array_equal(port["ctx"][k], want), k
        else:
            assert port["ctx"][k] == want, k
    assert port["breaker"] == ref["breaker"] == "single"
    assert port["parity"]["samples"]["drain"] >= 1
    assert port["parity"]["divergences"] == 0
    if name == "mixed":
        assert port["parity"]["samples"] == ref["parity"]["samples"]
        assert ref["parity"]["divergences"] == 0


def test_pods_compile_at_informer_time():
    """Every pending pod's encode record was compiled on the watch thread:
    the pops' encode finds all of them in the cache."""
    nodes, bound, pending, ns = _workload("mixed")
    client = port_clientset.DirectClient(port_store.ObjectStore())
    _seed(client, nodes, bound, pending, ns)
    runner = port_runner.SchedulerRunner(
        client, _cfg(port_config, batch_size=16, max_drain_batches=2),
        feature_gate=_port_gate(), device="cpu")
    try:
        runner.start(start_loop=False)
        _wait(runner.has_synced, what="informer sync")
        before = runner.cache.encode_cache_stats()
        assert before["hits"] == 0
        _drive(runner)
        after = runner.cache.encode_cache_stats()
        # every pod's rows came from the cache (a re-encoded pop hits
        # again), none was compiled on the hot path
        assert after["hits"] - before["hits"] >= len(pending)
        assert after["misses"] == before["misses"]
    finally:
        runner.stop()


class _CountingClient(port_clientset.DirectClient):
    """A DirectClient that counts the bindings it sends."""

    def __init__(self, store):
        super().__init__(store)
        self.bound = 0

    def bind_many(self, bindings):
        self.bound += len(bindings)
        return super().bind_many(bindings)

    def bind(self, ns, name, node_name):
        self.bound += 1
        return super().bind(ns, name, node_name)


def test_leader_election_one_runner_binds():
    store = port_store.ObjectStore()
    seed = port_clientset.DirectClient(store)
    nodes, _bound, pending, ns = _workload("mixed")
    seed.nodes().create_many(copy.deepcopy(nodes))
    clients = [_CountingClient(store) for _ in range(2)]
    runners = [port_runner.SchedulerRunner(
        c, _cfg(port_config, batch_size=16, max_drain_batches=2,
                leader_elect=True), identity=f"sched-{i}",
        feature_gate=_port_gate(), device="cpu")
        for i, c in enumerate(clients)]
    try:
        for r in runners:
            r.start()
        seed.pods("default").create_many(copy.deepcopy(pending[:64]))
        _wait(lambda: sum(1 for p in seed.pods(None).list()
                          if p["spec"].get("nodeName")) == 64,
              timeout=60.0, what="every pod bound")
        assert sorted(c.bound for c in clients) == [0, 64]
        leaders = [r._elector.is_leader for r in runners]
        assert sorted(leaders) == [False, True]
        assert clients[leaders.index(True)].bound == 64
    finally:
        for r in runners:
            r.stop()


def test_kernel_error_stops_the_runner(monkeypatch):
    """A ``count_pn`` that fails to launch ends the loop for good: the
    watchdog does not revive it, the breaker does not degrade it to the
    oracle, nothing binds, and ``stop()`` raises the error."""
    from kubernetes_tpu_torch.ops import topology as port_topology
    from kubernetes_tpu_torch.ops.kernels import KernelError
    launches = []

    def broken_count_pn(*args, **kwargs):
        launches.append(1)
        raise KernelError("count_pn launch failed: CUDA error 700")

    monkeypatch.setattr(port_topology, "_count_pn", broken_count_pn)
    nodes, bound, pending, ns = _workload("relational")
    client = port_clientset.DirectClient(port_store.ObjectStore())
    _seed(client, nodes, bound, pending, ns)
    runner = port_runner.SchedulerRunner(
        client, _cfg(port_config, batch_size=16, max_drain_batches=2,
                     watchdog_interval_s=0.05, breaker_threshold=1),
        feature_gate=_port_gate(), device="cpu")
    oracle = []
    monkeypatch.setattr(runner.scheduler, "_schedule_oracle",
                        lambda *a: oracle.append(a) or 0)
    bound_before = _bindings(client)
    runner.start()
    try:
        _wait(lambda: runner.loop_error is not None, what="the loop error")
        time.sleep(0.5)  # ten watchdog sweeps
        assert isinstance(runner.loop_error, KernelError)
        assert launches and not oracle
        assert not runner._loop_thread.is_alive()
        assert runner._watchdog.restarts == 0
        assert runner.scheduler.breaker.mode == "single"
        assert runner.scheduler.breaker.trips == 0
        assert _bindings(client) == bound_before
        status = runner._resilience_status()
        assert "CUDA error 700" in status["loopError"]
    finally:
        with pytest.raises(KernelError, match="CUDA error 700"):
            runner.stop()


def _cuda_error(msg):
    """The error the CUDA runtime raises: ``torch.AcceleratorError`` where
    this torch has it, else ``RuntimeError("CUDA error: ...")``."""
    cls = getattr(torch, "AcceleratorError", RuntimeError)
    return cls(f"CUDA error: {msg}")


@pytest.mark.parametrize("max_drain_batches", [1, 2],
                         ids=["group", "drain"])
def test_cuda_error_stops_the_runner(monkeypatch, max_drain_batches):
    """A CUDA error in the scheduler's device work ends the loop for good,
    as a ``KernelError`` does: neither the per-batch path nor the oracle
    takes the pods, the breaker does not trip, nothing binds, and
    ``stop()`` raises the error. The reference degrades to its oracle on
    a device error; the port does not (sched/faults.is_fatal)."""
    from kubernetes_tpu_torch.ops import topology as port_topology
    from kubernetes_tpu_torch.metrics import registry as port_registry
    launches = []

    def broken_count_pn(*args, **kwargs):
        launches.append(1)
        raise _cuda_error("an illegal memory access was encountered")

    monkeypatch.setattr(port_topology, "_count_pn", broken_count_pn)
    nodes, bound, pending, ns = _workload("relational")
    client = port_clientset.DirectClient(port_store.ObjectStore())
    _seed(client, nodes, bound, pending, ns)
    runner = port_runner.SchedulerRunner(
        client, _cfg(port_config, batch_size=16,
                     max_drain_batches=max_drain_batches,
                     watchdog_interval_s=0.05, breaker_threshold=1),
        feature_gate=_port_gate(), device="cpu")
    oracle = []
    monkeypatch.setattr(runner.scheduler, "_schedule_oracle",
                        lambda *a: oracle.append(a) or 0)
    errors = port_registry.LOOP_ERRORS
    before = {site: errors.get({"site": site})
              for site in ("device_gang", "device_drain", "run_once")}
    bound_before = _bindings(client)
    runner.start()
    try:
        _wait(lambda: runner.loop_error is not None, what="the loop error")
        time.sleep(0.5)  # ten watchdog sweeps
        assert "CUDA error" in str(runner.loop_error)
        assert launches and not oracle
        assert not runner._loop_thread.is_alive()
        assert runner._watchdog.restarts == 0
        assert runner.scheduler.breaker.mode == "single"
        assert runner.scheduler.breaker.trips == 0
        assert {site: errors.get({"site": site}) for site in before} \
            == before
        assert _bindings(client) == bound_before
    finally:
        with pytest.raises(type(runner.loop_error),
                           match="illegal memory access"):
            runner.stop()


def _graph_error():
    from kubernetes_tpu_torch.models.graphs import GraphError
    return GraphError("CUDA graph capture of the rounds failed: "
                      "RuntimeError: CUDA error: operation not permitted "
                      "when stream is capturing")


@pytest.mark.parametrize("exc, fatal", [
    (_cuda_error("an illegal memory access was encountered"), True),
    (RuntimeError("CUDA error: device-side assert triggered"), True),
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                 "2.00 GiB"), False),
    (RuntimeError("device lost"), False),
    (ValueError("CUDA error: not from the runtime"), False),
    (_graph_error(), True),
], ids=["accelerator", "runtime_cuda", "out_of_memory", "other_runtime",
        "value_error", "graph_capture"])
def test_is_fatal_classes_cuda_errors(exc, fatal):
    """The one predicate every device site shares: a CUDA error is fatal,
    a CUDA out-of-memory error keeps the retry path, and so is a CUDA
    graph of the rounds that fails to capture (it is never run eagerly
    instead)."""
    from kubernetes_tpu_torch.sched.faults import is_fatal
    assert is_fatal(exc) is fatal


@pytest.mark.parametrize("wire", ["json", "msgpack"])
def test_runner_over_http_matches_direct(wire):
    """The port's runner behind an ``HTTPClient`` against the port's
    ``APIServer`` binds every pod, to the same nodes as over a
    ``DirectClient``."""
    nodes, bound, pending, ns = _workload("mixed")
    results = []
    for transport in ("direct", "http"):
        server = None
        if transport == "http":
            server = port_apiserver.APIServer().start()
            client = port_clientset.HTTPClient(server.url, wire=wire)
        else:
            client = port_clientset.DirectClient(port_store.ObjectStore())
        _seed(client, nodes, bound, pending, ns)
        runner = port_runner.SchedulerRunner(
            client, _cfg(port_config, batch_size=16, max_drain_batches=2),
            feature_gate=_port_gate(), device="cpu")
        try:
            _drive(runner)
            _wait(lambda: all(_bindings(client).values()),
                  what="every pod bound")
            results.append(_bindings(client))
        finally:
            runner.stop()
            if server is not None:
                server.stop()
    assert results[1] == results[0]
    assert len(results[0]) == len(pending)


def test_sentinel_refuses_unported_samples():
    """No sample site is refused any more: the name dates from the slices
    that refused the carve site. Slice carving is ported, so the carve
    site takes its sample and judges it."""
    from kubernetes_tpu_torch.audit.sentinel import ParitySentinel
    sentinel = ParitySentinel(every=1)
    sentinel.maybe_submit_carve([], [], {}, [])
    sentinel.drain()
    sentinel.close()
    assert sentinel.samples["carve"] == 1
    assert sentinel.divergences == 0 and sentinel.fault is None


def _spread_case(ref_side: bool, kind: str):
    """Two single-node zones, no bound pods. Winner A carries a
    DoNotSchedule zone spread (maxSkew 1) over app=c and lands in zone a;
    winner B, placed after it in the same drain, matches app=c and lands in
    zone a too. The drain placed both correctly in sequence; judged with B
    counted, A's zone skew would be 2. With ``kind == "selector"``, A asks
    instead for ``disk=ssd``, which only zone b's node has, and still sits
    in zone a: a wrong answer."""
    from kubernetes_tpu import api as ref_api
    from kubernetes_tpu_torch import api as port_api
    api = ref_api if ref_side else port_api
    nodes = [api.Node.from_dict({
        "kind": "Node",
        "metadata": {"name": f"n-{z}",
                     "labels": {"topology.kubernetes.io/zone": z,
                                "kubernetes.io/hostname": f"n-{z}",
                                "disk": "ssd" if z == "b" else "hdd"}},
        "status": {"allocatable": {"cpu": "8", "memory": "16Gi",
                                   "pods": "110"}}}) for z in ("a", "b")]

    def pod(name, spec):
        return api.Pod.from_dict({
            "kind": "Pod",
            "metadata": {"name": name, "namespace": "default",
                         "labels": {"app": "c"}},
            "spec": dict({"containers": [{"name": "c", "resources": {
                "requests": {"cpu": "100m", "memory": "64Mi"}}}]}, **spec)})
    spread = {"topologySpreadConstraints": [{
        "maxSkew": 1, "topologyKey": "topology.kubernetes.io/zone",
        "whenUnsatisfiable": "DoNotSchedule",
        "labelSelector": {"matchLabels": {"app": "c"}}}]}
    if kind == "selector":
        spread = {"nodeSelector": {"disk": "ssd"}}
    winners = [(pod("a", spread), "n-a"), (pod("b", {}), "n-a")]
    return nodes, winners


@pytest.mark.parametrize("kind", ["hard_spread", "selector"])
def test_sentinel_verdict_against_reference(kind):
    """The reference's sentinel refutes the correct hard-spread winner;
    the port's skips it (and so never refutes it). A winner that breaks
    its node selector is refuted by both, with the same problem."""
    from kubernetes_tpu.audit import sentinel as ref_sentinel
    from kubernetes_tpu_torch.audit import sentinel as port_sentinel
    verdicts = {}
    for side, mod in (("ref", ref_sentinel), ("port", port_sentinel)):
        nodes, winners = _spread_case(side == "ref", kind)
        verdicts[side] = mod.verify_drain_winners(nodes, [], winners, [])
    assert len(verdicts["ref"]) == 1
    assert "refuted by the oracle" in verdicts["ref"][0]
    assert "default/a -> n-a" in verdicts["ref"][0]
    if kind == "hard_spread":
        assert verdicts["port"] == []
    else:
        assert verdicts["port"] == verdicts["ref"]


def test_parity_divergence_stops_the_runner(monkeypatch):
    """A drain the sentinel refutes ends the loop for good: the next pop
    raises the ``ParityError``, the watchdog does not revive the loop, the
    breaker does not move the work to the oracle, and ``stop()`` raises
    it."""
    from kubernetes_tpu_torch.audit import sentinel as port_sentinel
    from kubernetes_tpu_torch.audit.sentinel import ParityError
    refuted = []

    def refute(nodes, bound, winners, prior_winners, **kw):
        refuted.append(len(winners))
        return [f"winner {winners[0][0].key} -> {winners[0][1]} refuted "
                "by the oracle: a wrong count"]

    monkeypatch.setattr(port_sentinel, "verify_drain_winners", refute)
    nodes, bound, pending, ns = _workload("mixed")
    client = port_clientset.DirectClient(port_store.ObjectStore())
    _seed(client, nodes, bound, pending, ns)
    runner = port_runner.SchedulerRunner(
        client, _cfg(port_config, batch_size=16, max_drain_batches=2,
                     watchdog_interval_s=0.05, breaker_threshold=1),
        feature_gate=_port_gate(), device="cpu")
    oracle = []
    monkeypatch.setattr(runner.scheduler, "_schedule_oracle",
                        lambda *a: oracle.append(a) or 0)
    runner.start()
    try:
        _wait(lambda: runner.loop_error is not None, what="the loop error")
        time.sleep(0.5)  # ten watchdog sweeps
        assert isinstance(runner.loop_error, ParityError)
        assert refuted and not oracle
        assert runner.scheduler.sentinel.divergences >= 1
        assert not runner._loop_thread.is_alive()
        assert runner._watchdog.restarts == 0
        assert runner.scheduler.breaker.mode == "single"
        assert runner.scheduler.breaker.trips == 0
        assert "a wrong count" in runner._resilience_status()["loopError"]
    finally:
        with pytest.raises(ParityError, match="a wrong count"):
            runner.stop()


def test_watchdog_never_restarts_a_starting_resolver():
    """The resolver thread is spawned lazily at the first drain, while the
    runner's watchdog sweeps. A sweep that read the thread between its
    publication and its start saw it dead and restarted a healthy resolver
    (a watchdog restart in ``test_parity_divergence_stops_the_runner``
    under a loaded run). Sweeps every 0.1 ms against 100 first spawns,
    with the interpreter switching threads every microsecond: no restart."""
    import sys

    from kubernetes_tpu_torch.sched.cache import SchedulerCache
    from kubernetes_tpu_torch.sched.queue import SchedulingQueue
    from kubernetes_tpu_torch.sched.resilience import ThreadWatchdog
    from kubernetes_tpu_torch.sched.scheduler import Scheduler
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    restarts = 0
    try:
        for _ in range(100):
            sched = Scheduler(_cfg(port_config), SchedulerCache(),
                              SchedulingQueue(), lambda p, n: True,
                              device="cpu")
            watchdog = ThreadWatchdog(interval_s=1e-4, stall_s=LONG)
            watchdog.register(
                "resolver",
                is_alive=lambda: (sched._resolver_thread is None
                                  or sched._resolver_thread.is_alive()),
                restart=sched.restart_resolver, busy=lambda: False)
            watchdog.start()
            try:
                time.sleep(0.001)
                sched._ensure_resolver()
                time.sleep(0.003)
            finally:
                watchdog.stop()
                sched.close()
            restarts += watchdog.restarts
    finally:
        sys.setswitchinterval(prev)
    assert restarts == 0
