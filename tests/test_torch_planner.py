"""The port's resident planners against the JAX package's, on the CPU.

``tests/test_planner.py`` ported to ``kubernetes_tpu_torch`` (every device
call on ``device="cpu"``), plus the reference held beside it:

- the resident-vs-cold fuzz (seeds 0-2): for all three planners the port's
  resident plan equals its cold plan, and the overlay path was taken (hits
  advance, no decline); the port's plans equal the reference's cold plans
  on the same observation, compared in ``benchmarks/plannerloop.py``'s
  ``_norm_*`` forms;
- the decline matrix: every staleness reason of the reference's matrix
  but the mesh epoch (the port has no mesh, ROADMAP Queue A item 8), plus
  the port's own ``raced`` (the context moved while a dispatch ran), and
  the no-context decline;
- the tenant quota: ``Descheduler.plan`` blocks the same sets as the
  reference's in one quota dispatch;
- the ``BackgroundPlanner`` cadence over HTTP: one shared
  ``ResidentPlanner``, the steady window's ``steadyCompiles``, the status
  ConfigMap (``ktpu status`` is not ported, ROADMAP Queue A item 10);
- no fallback hides the card: the cold paths run on the card unless
  ``device="cpu"`` is passed, ``cluster_arrays`` catches no read-back
  failure, and a ``KernelError`` in a planner escapes the cycle (no
  decline counted) and stops the cadence's loop.
"""

from __future__ import annotations

import json
import time

import pytest
import torch

import chip_smoke
from benchmarks.plannerloop import (_norm_evictions, _norm_gang,
                                    _norm_scale_down, _norm_scale_up)
from kubernetes_tpu.autoscaler import nodegroup as ref_nodegroup
from kubernetes_tpu.autoscaler import simulator as ref_simulator
from kubernetes_tpu.descheduler import planner as ref_planner
from kubernetes_tpu.api.types import Node as RefNode, Pod as RefPod
from kubernetes_tpu.encode.snapshot import SnapshotEncoder as RefEncoder
from kubernetes_tpu.testing import wrappers as ref_wrappers
from kubernetes_tpu_torch.autoscaler.nodegroup import (NODE_GROUP_LABEL,
                                                       NodeGroup)
from kubernetes_tpu_torch.autoscaler.simulator import (simulate_scale_down,
                                                       simulate_scale_up)
from kubernetes_tpu_torch.config.types import SchedulerConfiguration
from kubernetes_tpu_torch.descheduler import plan_evictions
from kubernetes_tpu_torch.encode import overlay
from kubernetes_tpu_torch.encode.overlay import ResidentPlanner
from kubernetes_tpu_torch.encode.snapshot import TENANT_LABEL
from kubernetes_tpu_torch.ops.kernels import KernelError
from kubernetes_tpu_torch.sched.cache import SchedulerCache
from kubernetes_tpu_torch.sched.queue import SchedulingQueue
from kubernetes_tpu_torch.sched.scheduler import Scheduler
from kubernetes_tpu_torch.testing import wrappers as port_wrappers
from kubernetes_tpu_torch.testing.workloads import planner_fuzz_cluster
from kubernetes_tpu_torch.testing.wrappers import make_node, make_pod

D = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _sched(nodes, bound=()):
    """A warm port scheduler over ``nodes``+``bound`` whose resident drain
    context can hand out plan views (the product's warm_drain arming)."""
    cache = SchedulerCache()
    for n in nodes:
        cache.add_node(n)
    for p in bound:
        cache.add_pod(p)
    queue = SchedulingQueue(backoff_initial=0.01, backoff_max=0.05)
    cfg = SchedulerConfiguration(batch_size=4, max_drain_batches=2,
                                 backoff_initial_s=0.01, backoff_max_s=0.05)
    sched = Scheduler(cfg, cache, queue, lambda pod, node: True, device=D)
    warm = [make_pod(f"__warm{i}").req({"cpu": "100m"}).obj()
            for i in range(4)]
    assert sched.warm_drain(warm, slot_headroom=64)
    return sched, cache


def _reference_plans(seed):
    """The reference's cold plans for the same fuzz questions, its objects
    parsed from the port's dicts."""
    nodes, bound, pending, groups, sets, gang, gsets = \
        chip_smoke.planner_questions(seed)

    def node(n):
        return RefNode.from_dict(n.to_dict())

    def pods(ps):
        return [RefPod.from_dict(p.to_dict()) for p in ps]

    def cand(cs):
        return ref_planner.CandidateSet(
            name=cs.name, strategy=cs.strategy, victims=pods(cs.victims),
            exclude_targets=set(cs.exclude_targets))

    nodes, bound, pending, gang = ([node(n) for n in nodes], pods(bound),
                                   pods(pending), pods(gang))
    groups = [ref_nodegroup.NodeGroup(name=g.name, min_size=g.min_size,
                                      max_size=g.max_size,
                                      template=node(g.template))
              for g in groups]
    cold = RefEncoder()
    cands = [n.metadata.name for n in nodes]
    return {
        "scale_up": _norm_scale_up(ref_simulator.simulate_scale_up(
            nodes, bound, pending, groups, encoder=cold)),
        "scale_down": _norm_scale_down(ref_simulator.simulate_scale_down(
            nodes, bound, cands, utilization_threshold=0.6, encoder=cold)),
        "evictions": _norm_evictions(ref_planner.plan_evictions(
            nodes, bound, [cand(cs) for cs in sets], encoder=cold)),
        "gang_defrag": _norm_gang(ref_planner.plan_gang_defrag(
            nodes, bound, gang, "fuzz", [cand(cs) for cs in gsets],
            encoder=cold)),
    }


# ------------------------------------------------- resident/cold parity

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resident_vs_cold_plan_parity_fuzz(seed):
    """All three planners, same observation, overlay view vs cold encode:
    plans equal, and the overlay path actually taken (a decline would make
    the comparison vacuous cold-vs-cold)."""
    nodes, bound = planner_fuzz_cluster(seed)
    sched, cache = _sched(nodes, bound)
    try:
        rp = ResidentPlanner(sched.resident_plan_view, cache)
        resident = chip_smoke.planner_plans(seed, rp, D)
        assert rp.stats() == {"hits": {"autoscaler": 2, "descheduler": 1,
                                       "gangDefrag": 1},
                              "declines": {}}, rp.stats()
        cold = chip_smoke.planner_plans(seed, None, D)
        assert resident == cold
        assert cold["scale_up"], "scale-up parity must compare a real option"
    finally:
        sched.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_plans_equal_reference(seed):
    """The port's cold plans equal the JAX package's on the same
    observation, in the PlannerLoop bench's normal forms."""
    port = chip_smoke.planner_plans(seed, None, D)
    ref = _reference_plans(seed)
    for leg in ("scale_up", "scale_down", "evictions", "gang_defrag"):
        assert port[leg] == ref[leg], leg


# --------------------------------------------------------- decline matrix

def test_decline_matrix_every_staleness_reason():
    """Each freshness violation declines (cold fallback) with its reason
    recorded. The reference's mesh-epoch case has no counterpart: the port
    has no mesh (ROADMAP Queue A item 8)."""
    nodes = [make_node(f"d{i}")
             .capacity({"cpu": "8", "memory": "16Gi", "pods": "32"}).obj()
             for i in range(4)]
    bound = [make_pod("db0").req({"cpu": "1"}).node("d0").obj()]
    sched, cache = _sched(nodes, bound)
    try:
        rp = ResidentPlanner(sched.resident_plan_view, cache)
        live = cache.list_nodes()
        assert rp.plan_view(live, bound, planner="t") is not None
        assert rp.plan_view(live[:-1], bound, planner="t") is None
        ghost = make_pod("ghost").req({"cpu": "1"}).node("d1").obj()
        assert rp.plan_view(live, bound + [ghost], planner="t") is None
        sched._pending.append({"sentinel": True})
        assert rp.plan_view(live, bound, planner="t") is None
        sched._pending.clear()
        assert rp.plan_view(live, bound, planner="t") is not None
        cache.add_node(make_node("d-new").capacity(
            {"cpu": "8", "memory": "16Gi", "pods": "32"}).obj())
        assert rp.plan_view(cache.list_nodes(), bound, planner="t") is None
        sched._drain_ctx["cs"].tainted = True
        assert rp.plan_view(live, bound, planner="t") is None
        assert rp.stats()["declines"]["t"] == {
            "node_set_skew": 1, "bound_set_skew": 1, "in_flight": 1,
            "stale_log": 1, "tainted": 1}
    finally:
        sched.close()


def test_no_ctx_declines_before_warmup():
    cache = SchedulerCache()
    cache.add_node(make_node("c0").capacity(
        {"cpu": "4", "memory": "8Gi", "pods": "16"}).obj())
    sched = Scheduler(SchedulerConfiguration(batch_size=4), cache,
                      SchedulingQueue(), lambda pod, node: True, device=D)
    try:
        rp = ResidentPlanner(sched.resident_plan_view, cache)
        assert rp.plan_view(cache.list_nodes(), [], planner="t") is None
        assert rp.stats()["declines"]["t"] == {"no_ctx": 1}
    finally:
        sched.close()


def test_a_context_moved_during_a_dispatch_declines_raced():
    """The resident tensors are updated in place by the drain: a dispatch
    whose context moved meanwhile (here a churn patch consumed: ``seq``)
    declines instead of answering with a mixed cluster state."""
    nodes, bound = planner_fuzz_cluster(0)
    sched, cache = _sched(nodes, bound)
    try:
        rp = ResidentPlanner(sched.resident_plan_view, cache)
        pods = [make_pod("q0").req({"cpu": "1"}).obj()]
        ctx = rp.plan_view(nodes, bound, planner="t")
        assert rp.mask_scores(ctx, pods) is not None
        ctx = rp.plan_view(nodes, bound, planner="t")
        real = overlay._plan_mask_program

        def moving(*args):
            out = real(*args)
            sched._drain_ctx["seq"] += 1
            return out

        overlay._plan_mask_program = moving
        try:
            assert rp.mask_scores(ctx, pods) is None
        finally:
            overlay._plan_mask_program = real
        assert rp.stats()["declines"]["t"] == {"raced": 1}
    finally:
        sched.close()


def test_a_same_shape_rebuild_during_a_dispatch_declines_raced():
    """A rebuild at the old shapes writes the new snapshot into the old
    context's tensors (gang.adopt_storage), with no new delta and no fold:
    the tensors, ``seq`` and the patch cursors read as before, and only
    the context's build epoch tells the planner that its view moved."""
    nodes, bound = planner_fuzz_cluster(0)
    sched, cache = _sched(nodes, bound)
    try:
        rp = ResidentPlanner(sched.resident_plan_view, cache)
        pods = [make_pod("q0").req({"cpu": "1"}).obj()]
        ctx = rp.plan_view(nodes, bound, planner="t")
        old = sched._drain_ctx
        # an unplaceable pod: the rebuilt context folds nothing
        sched.taint_ctx()
        sched.queue.add(make_pod("huge").req({"cpu": "100000"}).obj())
        sched.run_once(wait=0.01)
        sched._resolve_pending()
        new = sched._drain_ctx
        assert new is not old and new["ct"] is old["ct"]
        assert (new["seq"], new["cs"].fill_host, new["cs"].top) == (
            old["seq"], old["cs"].fill_host, old["cs"].top)
        assert rp.mask_scores(ctx, pods) is None
        assert rp.stats()["declines"]["t"] == {"raced": 1}
    finally:
        sched.close()


# ------------------------------------------------- tenant drain quotas

def _quota_store(client_mod, store_mod, wrappers, tenant_label):
    client = client_mod.DirectClient(store_mod.ObjectStore())

    def node(name, tenant, pool=None):
        b = wrappers.make_node(name).capacity(
            {"cpu": "8", "memory": "16Gi", "pods": "32"})
        b = b.label(tenant_label, tenant)
        if pool:
            b = b.label("pool", pool)
        client.nodes().create(b.obj().to_dict())

    def pod(name, tenant, on, cpu="1", selector=None):
        b = wrappers.make_pod(name).req({"cpu": cpu}).label(tenant_label,
                                                            tenant)
        if selector:
            b = b.node_selector(selector)
        client.pods("default").create(b.node(on).obj().to_dict())

    node("q0", "acme")
    node("q1", "acme")
    node("q2", "acme", pool="busy")
    node("q3", "acme", pool="busy")
    node("q4", "zeta", pool="busy")
    busy = {"pool": "busy"}
    pod("acme-a", "acme", "q0", selector=busy)
    pod("zeta-a", "zeta", "q0", selector=busy)
    pod("acme-b", "acme", "q1", selector=busy)
    pod("acme-c", "acme", "q1", selector=busy)
    for i, on in enumerate(["q2", "q2", "q3", "q3"]):
        pod(f"load-{i}", "acme", on, cpu="3")
    return client


def test_tenant_drain_quota_blocks_whole_set_in_one_dispatch(monkeypatch):
    """tests/test_planner.py's quota case through both packages'
    ``Descheduler.plan``: both sets block whole, a blocked set's victims
    still consume their slots, ONE quota dispatch serves the cycle."""
    from kubernetes_tpu.client import clientset as ref_clientset
    from kubernetes_tpu.descheduler.descheduler import (
        Descheduler as RefDescheduler,
        DeschedulerConfiguration as RefConfig)
    from kubernetes_tpu.encode.snapshot import TENANT_LABEL as REF_TENANT
    from kubernetes_tpu.store import store as ref_store
    from kubernetes_tpu_torch.client import clientset
    from kubernetes_tpu_torch.descheduler.descheduler import (
        Descheduler, DeschedulerConfiguration)
    from kubernetes_tpu_torch.store import store

    calls = []
    real = overlay.tenant_quota_mask
    monkeypatch.setattr(overlay, "tenant_quota_mask",
                        lambda ids, quotas, device=None:
                        calls.append(len(ids)) or real(ids, quotas, device))
    kw = dict(strategies={"HighNodeUtilization": {"threshold": 0.3}},
              gang_defrag=False,
              tenant_drain_quotas={"acme": 2, "zeta": 0})
    d = Descheduler(_quota_store(clientset, store, port_wrappers,
                                 TENANT_LABEL),
                    DeschedulerConfiguration(**kw), device=D)
    plan, _gangs = d.plan()
    assert plan.blocked == {
        "drain/q0": "tenant drain quota exceeded",
        "drain/q1": "tenant drain quota exceeded",
    }, (plan.blocked, [s.name for s in plan.accepted])
    assert not plan.accepted
    assert calls == [4]
    ref = RefDescheduler(_quota_store(ref_clientset, ref_store, ref_wrappers,
                                      REF_TENANT), RefConfig(**kw))
    ref_plan, _ = ref.plan()
    assert _norm_evictions(plan) == _norm_evictions(ref_plan)


# ------------------------------------------------- BackgroundPlanner

def test_background_planner_cycles_and_status():
    """The cadence over HTTP: one shared ResidentPlanner wired to both
    planners, steady-window compile counts, hits advancing, and the
    status published to the planner ConfigMap."""
    from kubernetes_tpu_torch.autoscaler.autoscaler import ClusterAutoscaler
    from kubernetes_tpu_torch.autoscaler.nodegroup import (
        StaticNodeGroupProvider)
    from kubernetes_tpu_torch.client.clientset import HTTPClient
    from kubernetes_tpu_torch.descheduler.descheduler import (
        Descheduler, DeschedulerConfiguration)
    from kubernetes_tpu_torch.sched.bgplanner import (PLANNER_CONFIGMAP,
                                                      BackgroundPlanner)
    from kubernetes_tpu_torch.sched.runner import SchedulerRunner
    from kubernetes_tpu_torch.store.apiserver import APIServer

    server = APIServer().start()
    runner = None
    try:
        client = HTTPClient(server.url)
        client.nodes().create_many(
            [make_node(f"bg{i}").capacity({"cpu": "8", "memory": "16Gi",
                                           "pods": "32"})
             .label("kubernetes.io/hostname", f"bg{i}")
             .label(NODE_GROUP_LABEL, "bg-pool").obj().to_dict()
             for i in range(3)])
        client.pods("default").create_many(
            [make_pod(f"bgp{i}").req({"cpu": "2"}).node(f"bg{i}")
             .obj().to_dict() for i in range(2)])
        # a pod no node fits keeps the scale-up simulation live
        client.pods("default").create(
            make_pod("huge").req({"cpu": "64"}).obj().to_dict())
        runner = SchedulerRunner(HTTPClient(server.url),
                                 SchedulerConfiguration(batch_size=4),
                                 device=D)
        runner.start(wait_sync=30.0, start_loop=False)
        assert runner.scheduler.warm_drain(
            [make_pod(f"bgw{i}").req({"cpu": "1"}).obj()
             for i in range(4)], slot_headroom=32)
        autoscaler = ClusterAutoscaler(
            HTTPClient(server.url),
            StaticNodeGroupProvider(HTTPClient(server.url), [NodeGroup(
                name="bg-pool", min_size=0, max_size=4,
                template=make_node("bg-t").capacity(
                    {"cpu": "2", "memory": "4Gi", "pods": "16"}).obj())]),
            scale_down_unneeded_s=10 ** 9, device=D)
        descheduler = Descheduler(HTTPClient(server.url),
                                  DeschedulerConfiguration(), device=D)
        planner = BackgroundPlanner(client, runner.scheduler,
                                    autoscaler=autoscaler,
                                    descheduler=descheduler,
                                    descheduler_dry_run=True,
                                    warmup_cycles=1)
        assert autoscaler.resident is planner.resident
        assert descheduler.resident is planner.resident

        first = planner.run_once()
        assert "steadyCompiles" not in first
        second = planner.run_once()
        third = planner.run_once()
        assert second["steadyCompiles"] == 0
        assert third["steadyCompiles"] == 0
        st = planner.status()
        assert st["cycles"] == 3 and st["steadyCompiles"] == 0
        assert set(st["planners"]) == {"autoscaler", "descheduler",
                                       "gangDefrag"}
        assert st["planners"]["autoscaler"]["hits"] >= 3
        assert st["planners"]["autoscaler"]["declines"] == 0
        assert st["planners"]["descheduler"]["hits"] >= 3
        cm = client.resource("configmaps", "default").get(PLANNER_CONFIGMAP)
        published = json.loads(cm["data"]["status"])
        assert published["cycles"] == 3
        assert published["planners"]["autoscaler"]["hits"] == \
            st["planners"]["autoscaler"]["hits"]
        assert runner.cache.stats()["full_encodes"] >= 1
    finally:
        if runner is not None:
            runner.stop()
        server.stop()


# --------------------------------------------------- no fallback hides it

def test_cold_paths_run_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    nodes, bound, pending, groups, sets, _g, _gs = \
        chip_smoke.planner_questions(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate_scale_up(nodes, bound, pending, groups)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate_scale_down(nodes, bound, [nodes[0].metadata.name],
                            utilization_threshold=0.99)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan_evictions(nodes, bound, sets)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        overlay.tenant_quota_mask([0], [1])


def test_cluster_arrays_catches_nothing():
    """Without a shadow the totals come from one read-back of the resident
    tensors; a failure there escapes (the reference declines
    ``readback`` and plans cold)."""
    nodes, bound = planner_fuzz_cluster(1)
    sched, cache = _sched(nodes, bound)
    try:
        rp = ResidentPlanner(sched.resident_plan_view, cache)
        ctx = rp.plan_view(nodes, bound, planner="t")
        ctx["view"] = dict(ctx["view"], shadow=None)
        alloc, req = rp.cluster_arrays(ctx)
        assert alloc.shape == req.shape == (8, len(ctx["cs"].resources))

        class Broken:
            def cpu(self):
                raise RuntimeError("CUDA error: an illegal memory access")

        ctx["ct"] = ctx["ct"].replace(allocatable=Broken())
        with pytest.raises(RuntimeError, match="illegal memory access"):
            rp.cluster_arrays(ctx)
        assert rp.stats()["declines"] == {}
    finally:
        sched.close()


_FAULTS = {
    "kernel": lambda: KernelError("launch failed"),
    "accelerator": lambda: torch.AcceleratorError(
        "CUDA error: an illegal memory access was encountered"),
    "cuda_runtime": lambda: RuntimeError(
        "CUDA error: an illegal memory access was encountered"),
}


# the loop's thread ends by re-raising the fault, which pytest reports
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
@pytest.mark.parametrize("fault", sorted(_FAULTS))
def test_kernel_error_in_a_planner_escapes_the_cycle(monkeypatch, fault):
    """A KernelError or a CUDA error in a planner's dispatch leaves
    run_once, counts no decline, and the cadence's loop stops for good
    with it."""
    from kubernetes_tpu_torch.autoscaler.autoscaler import ClusterAutoscaler
    from kubernetes_tpu_torch.autoscaler.nodegroup import (
        StaticNodeGroupProvider)
    from kubernetes_tpu_torch.client.clientset import DirectClient
    from kubernetes_tpu_torch.sched.bgplanner import BackgroundPlanner
    from kubernetes_tpu_torch.store.store import ObjectStore

    nodes, bound = planner_fuzz_cluster(2)
    sched, cache = _sched(nodes, bound)
    try:
        client = DirectClient(ObjectStore())
        for n in nodes:
            client.nodes().create(n.to_dict())
        for p in bound:
            client.pods("default").create(p.to_dict())
        # no node and no template fits it: the scale-up simulation runs
        # every cycle and never provisions
        client.pods("default").create(
            make_pod("huge").req({"cpu": "64"}).obj().to_dict())
        autoscaler = ClusterAutoscaler(
            client, StaticNodeGroupProvider(client, [NodeGroup(
                name="spare", min_size=0, max_size=2,
                template=make_node("t").capacity(
                    {"cpu": "32", "memory": "64Gi", "pods": "32"}).obj())]),
            scale_down_unneeded_s=10 ** 9, device=D)
        planner = BackgroundPlanner(client, sched, autoscaler=autoscaler,
                                    warmup_cycles=0)
        assert planner.run_once()["autoscaler"]["pending"] == 1
        assert planner.resident.stats()["hits"]["autoscaler"] >= 1

        def broken(*args):
            raise _FAULTS[fault]()

        kind = type(_FAULTS[fault]())
        monkeypatch.setattr(overlay, "_overlay_mask_program", broken)
        with pytest.raises(kind):
            planner.run_once()
        assert planner.resident.stats()["declines"] == {}
        planner.start(interval=0.01)
        deadline = time.time() + 10
        while planner._thread.is_alive() and time.time() < deadline:
            time.sleep(0.01)
        assert not planner._thread.is_alive()
        assert type(planner.loop_error) is kind
    finally:
        planner.stop()
        sched.close()


def test_other_cycle_failures_keep_the_cadence_running(monkeypatch):
    """A failure that is neither in the runner's fatal set nor a CUDA
    error (here a RuntimeError of the host) is logged, and the loop goes
    on cycling."""
    from kubernetes_tpu_torch.client.clientset import DirectClient
    from kubernetes_tpu_torch.sched.bgplanner import BackgroundPlanner
    from kubernetes_tpu_torch.store.store import ObjectStore

    nodes, bound = planner_fuzz_cluster(2)
    sched, cache = _sched(nodes, bound)
    planner = BackgroundPlanner(DirectClient(ObjectStore()), sched,
                                warmup_cycles=0)
    calls = []

    def flaky():
        calls.append(1)
        raise RuntimeError("observation failed")

    monkeypatch.setattr(planner, "run_once", flaky)
    try:
        planner.start(interval=0.01)
        deadline = time.time() + 10
        while len(calls) < 3 and time.time() < deadline:
            time.sleep(0.01)
        assert len(calls) >= 3
        assert planner._thread.is_alive()
        assert planner.loop_error is None
    finally:
        planner.stop()
        sched.close()


def test_template_label_past_the_key_bucket_requests_a_full_encode():
    """A node-group template whose label key the resident key bucket does
    not hold declines ``template_bucket`` and asks the cache for a full
    encode: the scheduler's next cycle rebuilds its context at the wider
    bucket, and from then on the scale-up rides the resident image, with
    the options of the cold path."""
    nodes = [make_node(f"k{i}")
             .capacity({"cpu": "8", "memory": "16Gi", "pods": "32"}).obj()
             for i in range(4)]
    bound = [make_pod("kb0").req({"cpu": "1"}).node("k0").obj()]
    big = make_pod("big").req({"cpu": "12"}).obj()
    group = NodeGroup(name="big-pool", min_size=0, max_size=4,
                      template=make_node("t").label("pool", "big").capacity(
                          {"cpu": "32", "memory": "64Gi", "pods": "32"})
                      .obj())
    sched, cache = _sched(nodes, bound)
    try:
        rp = ResidentPlanner(sched.resident_plan_view, cache)

        def scale_up(**kw):
            return _norm_scale_up(simulate_scale_up(
                cache.list_nodes(), bound, [big], [group], device=D, **kw))

        cold = scale_up()
        assert cold and cold[0][0] == "big-pool"
        assert scale_up(resident=rp) == cold
        assert rp.stats() == {"hits": {}, "declines": {
            "autoscaler": {"template_bucket": 1}}}
        full0 = cache.stats()["full_encodes"]
        # the scheduler's own cycle: big stays pending, the drain resolves
        sched.queue.add(big)
        sched.run_once(wait=0.1)
        sched.run_once(wait=0.0)
        assert sched.resident_plan_view()[1] == "ok"
        assert cache.stats()["full_encodes"] == full0 + 1
        assert scale_up(resident=rp) == cold
        assert rp.stats() == {"hits": {"autoscaler": 1}, "declines": {
            "autoscaler": {"template_bucket": 1}}}
    finally:
        sched.close()
