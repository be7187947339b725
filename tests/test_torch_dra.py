"""DRA device claims in the port against the JAX package, on the CPU.

Device classes ride the resource axis as ``dra:<class>`` columns
(``sched/dra.py``): a node's ResourceSlices extend its allocatable, a pod's
claims extend its requests, an unready claim holds the pod and an
allocated one pins it. Every case runs the same wire dicts through both
packages (the port on ``device="cpu"``):

- ``tests/test_dra.py``'s six cases: the catalog, the masks (device nodes
  only, devices in use by bound pods, the allocated pin) against the
  port's oracle and the reference's encoder, gang contention, and the
  claim template through the ported ``ResourceClaimController`` over the
  port's ``DirectClient``;
- the slice-claims bridge, a slice-shaped claim routing its pod into the
  carver, and preemption's static mask (``tests/test_topology.py``,
  ``tests/test_planner.py``);
- the catalog's answers on the seeded ``dra_mix`` workload;
- the Scheduler's resident drain over ``dra_mix``: claim pods folded, a
  node joining with a slice published before it (a patch), a new slice
  (a full encode): placements, ``ctx_stats`` and the folded context (its
  ``dra:`` column included) bit-equal, no node over its devices;
- a claim's status-only update leaves the encode generation as it was;
- both runners over a ``DirectClient``: bindings and claim allocations
  equal; a binding that fails unreserves the claim (the port's
  ``APIServer`` over HTTP);
- a ``deviceCapacity`` node group that scales up for a claim pod.
"""

from __future__ import annotations

import copy
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kubernetes_tpu.autoscaler import nodegroup as ref_nodegroup
from kubernetes_tpu.autoscaler import simulator as ref_simulator
from kubernetes_tpu.client import clientset as ref_clientset
from kubernetes_tpu.client import informer as ref_informer
from kubernetes_tpu.config import features as ref_features
from kubernetes_tpu.config import types as ref_config
from kubernetes_tpu.controllers import ResourceClaimController as RefRCC
from kubernetes_tpu.encode import snapshot as ref_snapshot
from kubernetes_tpu.models import gang as ref_gang
from kubernetes_tpu.models import schedule_step as ref_step
from kubernetes_tpu.ops import preemption as ref_ops_preemption
from kubernetes_tpu.sched import cache as ref_cache
from kubernetes_tpu.sched import dra as ref_dra
from kubernetes_tpu.sched import oracle as ref_oracle
from kubernetes_tpu.sched import queue as ref_queue
from kubernetes_tpu.sched import runner as ref_runner
from kubernetes_tpu.sched import scheduler as ref_scheduler
from kubernetes_tpu.store import store as ref_store
from kubernetes_tpu.api import types as ref_types
from kubernetes_tpu_torch.api import types as port_types
from kubernetes_tpu_torch.autoscaler import nodegroup as port_nodegroup
from kubernetes_tpu_torch.autoscaler import simulator as port_simulator
from kubernetes_tpu_torch.client import clientset as port_clientset
from kubernetes_tpu_torch.client import informer as port_informer
from kubernetes_tpu_torch.config import features as port_features
from kubernetes_tpu_torch.config import types as port_config
from kubernetes_tpu_torch.controllers import ResourceClaimController
from kubernetes_tpu_torch.encode import snapshot as port_snapshot
from kubernetes_tpu_torch.models import gang as port_gang
from kubernetes_tpu_torch.models import schedule_step as port_step
from kubernetes_tpu_torch.ops import preemption as port_ops_preemption
from kubernetes_tpu_torch.sched import cache as port_cache
from kubernetes_tpu_torch.sched import dra as port_dra
from kubernetes_tpu_torch.sched import oracle as port_oracle
from kubernetes_tpu_torch.sched import queue as port_queue
from kubernetes_tpu_torch.sched import runner as port_runner
from kubernetes_tpu_torch.sched import scheduler as port_scheduler
from kubernetes_tpu_torch.store import apiserver as port_apiserver
from kubernetes_tpu_torch.store import store as port_store
from kubernetes_tpu_torch.testing import workloads
from kubernetes_tpu_torch.testing.wrappers import make_node, make_pod

REF = SimpleNamespace(
    name="ref", types=ref_types, dra=ref_dra, snapshot=ref_snapshot,
    oracle=ref_oracle, cache=ref_cache, queue=ref_queue,
    scheduler=ref_scheduler, config=ref_config, features=ref_features,
    nodegroup=ref_nodegroup,
    evaluate=lambda ct, pb, tk: np.asarray(
        ref_step.evaluate(ct, pb, topo_keys=tk).feasible),
    gang=lambda ct, pb, tk: np.asarray(
        ref_gang.gang_schedule(ct, pb, topo_keys=tk)[0]),
    scale_up=ref_simulator.simulate_scale_up, kw={})
PORT = SimpleNamespace(
    name="port", types=port_types, dra=port_dra, snapshot=port_snapshot,
    oracle=port_oracle, cache=port_cache, queue=port_queue,
    scheduler=port_scheduler, config=port_config, features=port_features,
    nodegroup=port_nodegroup,
    evaluate=lambda ct, pb, tk: port_step.evaluate(
        ct.to("cpu"), pb.to("cpu"), topo_keys=tk).feasible.numpy(),
    gang=lambda ct, pb, tk: np.asarray(port_gang.gang_schedule(
        ct.to("cpu"), pb.to("cpu"), topo_keys=tk)[0]),
    scale_up=lambda *a, **k: port_simulator.simulate_scale_up(
        *a, device="cpu", **k),
    kw={"device": "cpu"})

LONG = 3600.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def claim(name, cls_name="gpu", count=1, ns="default", alloc_node=None):
    return workloads.resource_claim(name, count=count, ns=ns, cls=cls_name,
                                    alloc_node=alloc_node or "")


def dev_slice(name, node, cls_name="gpu", count=1):
    return workloads.resource_slice(node, count, cls=cls_name, name=name)


def pod_dict(name, claim_name, cpu="100m"):
    return workloads.with_claim(
        make_pod(name).req({"cpu": cpu}).obj().to_dict(), claim_name)


def node_dict(name, cpu="8", pods="10"):
    return make_node(name).capacity({"cpu": cpu, "pods": pods}).obj() \
        .to_dict()


def _catalog(P, claims=(), classes=(), slices=()):
    return P.dra.DraCatalog.from_lists(
        claims=copy.deepcopy(list(claims)), classes=copy.deepcopy(list(classes)),
        slices=copy.deepcopy(list(slices)))


def _objs(P, cls, dicts):
    return [getattr(P.types, cls).from_dict(copy.deepcopy(d)) for d in dicts]


# ---- tests/test_dra.py, on both packages -----------------------------------

def test_catalog_resolution():
    for P in (REF, PORT):
        cat = _catalog(P, claims=[claim("c1", count=2)],
                       slices=[dev_slice("s1", "n0", count=4)])
        p = _objs(P, "Pod", [pod_dict("p", "c1")])[0]
        assert cat.pod_demands(p) == {"dra:gpu": 2}
        assert cat.node_capacity("n0") == {"dra:gpu": 4}
        assert cat.node_capacity("n1") == {}
        assert cat.class_names() == {"gpu"}
        assert cat.pod_allocated_node(p) is None
        assert cat.pod_claims_ready(p)
    assert port_dra.DRA_PREFIX == ref_dra.DRA_PREFIX


def test_catalog_answers_equal_on_dra_mix():
    """Every resolver of the two catalogs answers alike on the seeded
    workload: each pod's claims, demands, readiness, pin and slice shape;
    each node's capacity and topology; the class set; and the allocation
    and release patches."""
    w = workloads.dra_mix(seed=3)
    node_names = [n["metadata"]["name"]
                  for n in w["nodes"] + w["late_nodes"]]
    got = {}
    for P in (REF, PORT):
        cat = _catalog(P, w["claims"], w["classes"], w["slices"])
        pods = _objs(P, "Pod", w["pending"] + w["bound"])
        got[P.name] = (
            [(cat.pod_claims(p), cat.pod_demands(p), cat.pod_claims_ready(p),
              cat.pod_allocated_node(p), cat.pod_slice_shape(p))
             for p in pods],
            [(cat.node_capacity(n), cat.node_topology(n))
             for n in node_names],
            cat.class_names(),
            [(P.dra.allocation_patch(c, "node-0", pods[0]),
              P.dra.release_patch(c)) for c in w["claims"]])
    assert got["port"] == got["ref"]
    demands, ready = got["port"][0][0], got["port"][0]
    assert any(d[1] for d in ready) and not all(d[2] for d in ready)
    assert demands is not None


def _both_masks(P, nodes, pods, bound, cat_lists):
    enc = P.snapshot.SnapshotEncoder()
    cat = _catalog(P, *cat_lists)
    enc.set_dra(cat)
    nodes, pods, bound = (_objs(P, "Node", nodes), _objs(P, "Pod", pods),
                          _objs(P, "Pod", bound))
    ct, meta = enc.encode_cluster(nodes, bound, pending_pods=pods)
    pb = enc.encode_pods(pods, meta)
    tm = P.evaluate(ct, pb, meta.topo_keys)[:len(pods), :len(nodes)]
    orc = P.oracle.OracleScheduler(nodes, bound, dra=cat)
    om = np.asarray([orc.feasible(p)[0] for p in pods])
    np.testing.assert_array_equal(tm, om)
    return tm


def _held_by(name, claim_name, node):
    d = pod_dict(name, claim_name)
    d["spec"]["nodeName"] = node
    return d


_MASK_CASES = {
    # test_claim_filters_to_device_nodes
    "device_nodes": (
        [node_dict("gpu-node"), node_dict("cpu-node")],
        [pod_dict("p", "c1"),
         make_pod("plain").req({"cpu": "1"}).obj().to_dict()], [],
        ([claim("c1")], [], [dev_slice("s1", "gpu-node")]),
        [[True, False], [True, True]]),
    # test_devices_in_use_by_bound_pods_count: the only device is held
    "devices_in_use": (
        [node_dict("n0")], [pod_dict("p", "c1")],
        [_held_by("holder", "c0", "n0")],
        ([claim("c0"), claim("c1")], [], [dev_slice("s1", "n0")]),
        [[False]]),
    # test_allocated_claim_pins_pod
    "allocated_pin": (
        [node_dict("n0"), node_dict("n1")], [pod_dict("p", "c1")], [],
        ([claim("c1", alloc_node="n1")], [],
         [dev_slice("s0", "n0"), dev_slice("s1", "n1")]),
        [[False, True]]),
    # a template claim that does not exist yet holds the pod everywhere
    "unready": (
        [node_dict("n0")],
        [workloads.with_claim(make_pod("w").req({"cpu": "100m"}).obj()
                              .to_dict(), template="tpl")], [],
        ([], [], [dev_slice("s0", "n0")]), [[False]]),
}


@pytest.mark.parametrize("case", sorted(_MASK_CASES))
def test_claim_masks(case):
    nodes, pods, bound, lists, want = _MASK_CASES[case]
    ref = _both_masks(REF, nodes, pods, bound, lists)
    port = _both_masks(PORT, nodes, pods, bound, lists)
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(port, want)


def test_gang_contends_for_devices():
    """Two pods, one device: the gang batcher's capacity acceptance must
    serialize them like any other scarce resource."""
    out = {}
    for P in (REF, PORT):
        nodes = _objs(P, "Node", [node_dict("n0")])
        pods = _objs(P, "Pod", [pod_dict("p1", "c1"), pod_dict("p2", "c2")])
        enc = P.snapshot.SnapshotEncoder()
        enc.set_dra(_catalog(P, [claim("c1"), claim("c2")], [],
                             [dev_slice("s1", "n0")]))
        ct, meta = enc.encode_cluster(nodes, [], pending_pods=pods)
        pb = enc.encode_pods(pods, meta)
        out[P.name] = P.gang(ct, pb, meta.topo_keys)[:2]
    np.testing.assert_array_equal(out["port"], out["ref"])
    assert len([a for a in out["port"] if a >= 0]) == 1


def _wait_until(fn, timeout=30.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return fn()


def _strip(obj):
    obj = copy.deepcopy(obj)
    md = obj.get("metadata") or {}
    for k in ("uid", "resourceVersion", "creationTimestamp", "generation",
              "managedFields"):
        md.pop(k, None)
    for ref in md.get("ownerReferences") or []:
        ref.pop("uid", None)
    return obj


def _template_run(client, controller_cls, informer_factory):
    """tests/test_dra.py's template case. -> (the generated claim, the
    claim after the pod finished)."""
    ctrl = controller_cls(client)
    factory = informer_factory(client)
    ctrl.register(factory)
    factory.start_all()
    assert factory.wait_for_cache_sync(5.0)
    ctrl.start()
    try:
        client.resource("resourceclaimtemplates").create(
            workloads.claim_template("gpu-tpl", cls="gpu"))
        p = make_pod("worker").obj().to_dict()
        p["spec"]["resourceClaims"] = [
            {"name": "dev", "resourceClaimTemplateName": "gpu-tpl"}]
        client.pods().create(p)
        assert _wait_until(lambda: client.resource("resourceclaims").list())
        got = client.resource("resourceclaims").get("worker-dev")
        assert got["spec"]["devices"]["requests"][0]["deviceClassName"] \
            == "gpu"
        assert got["metadata"]["ownerReferences"][0]["kind"] == "Pod"
        made = _strip(got)
        # simulate the scheduler's allocation, then finish the pod: the
        # controller must release the devices
        got["status"] = {"allocation": {"nodeName": "n0"},
                         "reservedFor": [{"resource": "pods",
                                          "name": "worker", "uid": ""}]}
        client.resource("resourceclaims").update_status(got)
        pod = client.pods().get("worker")
        pod["status"] = {"phase": "Succeeded"}
        client.pods().update(pod)
        assert _wait_until(lambda: not (client.resource("resourceclaims")
                                        .get("worker-dev").get("status")
                                        or {}).get("allocation"))
        return made, _strip(client.resource("resourceclaims")
                            .get("worker-dev"))
    finally:
        ctrl.stop()
        factory.stop_all()


def test_claim_template_instantiation_and_release():
    port = _template_run(
        port_clientset.DirectClient(port_store.ObjectStore()),
        ResourceClaimController, port_informer.InformerFactory)
    ref = _template_run(
        ref_clientset.DirectClient(ref_store.ObjectStore()), RefRCC,
        ref_informer.InformerFactory)
    assert port == ref


# ---- tests/test_topology.py and tests/test_planner.py's DRA cases -----------

def _slice_claim(name, shape="2x2x1"):
    return {"apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
            "metadata": {"name": name, "namespace": "default"},
            "spec": {"devices": {"requests": [
                {"name": "tpu", "deviceClassName": "tpu.google.com",
                 "sliceShape": shape}]}}}


def _topo_slice(name, node, x, y, z):
    return {"apiVersion": "resource.k8s.io/v1", "kind": "ResourceSlice",
            "metadata": {"name": name},
            "spec": {"nodeName": node, "devices": [{
                "name": "chip0", "deviceClassName": "tpu.google.com",
                "attributes": {"topology-x": {"int": x},
                               "topology-y": {"int": y},
                               "topology-z": {"int": z}}}]}}


def test_dra_slice_claims_bridge():
    out = {}
    pd = pod_dict("p", "c1")
    for P in (REF, PORT):
        cat = _catalog(P, claims=[_slice_claim("c1")],
                       slices=[_topo_slice("s1", "n0", 1, 2, 0)])
        C = P.dra.DraCatalog
        assert C.claim_slice_shape(_slice_claim("x")) == (2, 2, 1)
        assert C.claim_slice_shape(
            {"spec": {"devices": {"requests": [{"count": 2}]}}}) is None
        pod = _objs(P, "Pod", [pd])[0]
        assert cat.pod_slice_shape(pod) == (2, 2, 1)
        assert cat.node_topology("n0") == (1, 2, 0)
        assert cat.node_topology("n-missing") is None
        with_topo = P.dra.allocation_patch(_slice_claim("c1"), "n0", pod,
                                           coords=(1, 2, 0), shape=(2, 2, 1))
        assert with_topo["status"]["allocation"]["topology"] == {
            "coordinates": [1, 2, 0], "sliceShape": "2x2x1"}
        plain = P.dra.allocation_patch(_slice_claim("c1"), "n0", pod)
        assert "topology" not in plain["status"]["allocation"]
        out[P.name] = (with_topo, plain)
    assert out["port"] == out["ref"]


def _grid_node_dicts(nx, ny, nz):
    from kubernetes_tpu_torch.topology.slicing import topology_labels
    out = []
    for x in range(nx):
        for y in range(ny):
            for z in range(nz):
                w = make_node(f"n-{x}-{y}-{z}").capacity(
                    {"cpu": "8", "memory": "32Gi", "pods": "16"})
                for key, v in topology_labels(x, y, z).items():
                    w = w.label(key, v)
                out.append(w.obj().to_dict())
    return out


def test_dra_claim_routes_pod_into_carver():
    """A slice-shaped ResourceClaim routes the pod into the carver with
    no slice-shape label at all, in the oracle and in the Scheduler."""
    nodes = _grid_node_dicts(2, 1, 1)
    pd = workloads.with_claim(make_pod("claimed").req({"cpu": "1"}).obj()
                              .to_dict(), "c1")
    for P in (REF, PORT):
        cat = _catalog(P, claims=[_slice_claim("c1", "2x1x1")])
        node_objs = _objs(P, "Node", nodes)
        pod = _objs(P, "Pod", [pd])[0]
        assert P.oracle.OracleScheduler(node_objs, [], dra=cat) \
            ._slice_shape_of(pod) == (2, 1, 1)
        side = _Side(P, {}, node_objs=node_objs)
        try:
            side.cache.update_dra_object("ResourceClaim",
                                         _slice_claim("c1", "2x1x1"))
            assert side.sched._slice_shape_of(pod) == (2, 1, 1)
        finally:
            side.close()


def test_preemption_static_mask_respects_dra_claim_state():
    """An unready claim holds the preemptor off every node; an allocated
    claim pins it to the allocation's node."""
    nodes = [make_node(f"p{i}").capacity({"cpu": "4", "memory": "8Gi",
                                          "pods": "16"}).obj().to_dict()
             for i in range(3)]

    def pod_with(claim_name):
        return workloads.with_claim(
            make_pod("pre").req({"cpu": "1"}).priority(100).obj().to_dict(),
            claim_name)

    free = make_pod("free").req({"cpu": "1"}).priority(100).obj().to_dict()
    pinned = {"apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
              "metadata": {"name": "c1", "namespace": "default"},
              "spec": {"devices": {"requests": []}},
              "status": {"allocation": {"nodeName": "p1"},
                         "reservedFor": []}}
    out = {}
    for P, ops in ((REF, ref_ops_preemption), (PORT, port_ops_preemption)):
        node_objs = _objs(P, "Node", nodes)
        missing = ops._static_mask(node_objs, _objs(P, "Pod", [
            pod_with("missing")])[0], dra=_catalog(P))
        cat = _catalog(P, claims=[pinned])
        pin = ops._static_mask(node_objs, _objs(P, "Pod", [
            pod_with("c1")])[0], dra=cat)
        unclaimed = ops._static_mask(node_objs, _objs(P, "Pod", [free])[0],
                                     dra=cat)
        out[P.name] = (missing.tolist(), pin.tolist(), unclaimed.tolist())
    assert out["port"] == out["ref"]
    assert out["port"] == ([False] * 3, [False, True, False], [True] * 3)


# ---- the Scheduler over the seeded claim workload ---------------------------

class _Side:
    """One package's Scheduler over its own cache (DRA objects fed through
    ``update_dra_object``), queue and binder log."""

    def __init__(self, P, cfg_kw, node_objs=(), w=None, gates=None):
        self.P = P
        self.cache = P.cache.SchedulerCache(assume_ttl=LONG)
        for n in node_objs:
            self.cache.add_node(n)
        if w is not None:
            for kind, key in (("DeviceClass", "classes"),
                              ("ResourceSlice", "slices"),
                              ("ResourceClaim", "claims")):
                for obj in w[key]:
                    self.cache.update_dra_object(kind, copy.deepcopy(obj))
            for d in w["nodes"]:
                self.cache.add_node(self.node(d))
            for d in w["bound"]:
                self.cache.add_pod(self.pod(d))
        self.queue = P.queue.SchedulingQueue(backoff_initial=LONG,
                                             backoff_max=LONG)
        self.log: dict[str, str] = {}
        cfg = P.config.SchedulerConfiguration(
            explainer_enabled=False, parity_sample_every=0, **cfg_kw)
        P.config.validate(cfg)
        gate = P.features.FeatureGate()
        gate.set_from_map(dict({"PreemptionSimulation": False},
                               **(gates or {})))
        self.sched = P.scheduler.Scheduler(
            cfg, self.cache, self.queue, self._bind, feature_gate=gate,
            **P.kw)
        self.sched._drain_ready = lambda pend: False

    def node(self, d):
        return self.P.types.Node.from_dict(copy.deepcopy(d))

    def pod(self, d):
        return self.P.types.Pod.from_dict(copy.deepcopy(d))

    def _bind(self, pod, node):
        self.log[pod.key] = node
        return True

    def churn(self, events):
        for op, arg in events:
            if op == "node":
                self.cache.add_node(self.node(arg))
            else:
                self.cache.update_dra_object(op, copy.deepcopy(arg))

    def drive(self, pods, churn, extra=3):
        for d in pods:
            self.queue.add(self.pod(d))
        for i in range(len(churn) + extra):
            if i < len(churn):
                self.churn(churn[i])
            self.sched.run_once(wait=0.01)
        self.sched._resolve_pending()
        self.sched.wait_for_bindings()

    def ctx_record(self) -> dict:
        ctx = self.sched._drain_ctx
        if ctx is None:
            return {}
        cs, ct = ctx["cs"], ctx["ct"]

        def host(x):
            if isinstance(x, torch.Tensor):
                return x.cpu().numpy().copy()
            return np.asarray(x).copy()
        return {"fill_host": cs.fill_host, "top": cs.top,
                "folded": dict(cs.folded),
                "resources": list(ctx["meta"].resources),
                "requested": host(ct.requested),
                "allocatable": host(ct.allocatable),
                "epod_valid": host(ct.epod_valid),
                "epod_node": host(ct.epod_node)}

    def close(self):
        self.sched.close()


def _dra_churn(w):
    """Before the pops: nothing before the first; before the second the
    late node joins (its slice was published before it: a node patch that
    takes the slice's devices, folded); before the third a node without
    devices gets a slice (a new ResourceSlice: a full encode, a
    rebuild)."""
    return [[], [("node", w["late_nodes"][0])],
            [("ResourceSlice", workloads.resource_slice("node-1", 3))]]


@pytest.mark.parametrize("depth,fused", [(1, True), (2, False)])
def test_scheduler_drain_with_claims_equals_reference(depth, fused):
    w = workloads.dra_mix(nodes=16, pods=48, seed=1)
    cfg = dict(batch_size=8, max_drain_batches=2, pipeline_depth=depth,
               fused_fold=fused)
    sides = [_Side(P, cfg, w=w) for P in (REF, PORT)]
    try:
        for s in sides:
            s.drive(w["pending"], _dra_churn(w))
        ref, port = sides
        assert port.log == ref.log
        assert port.sched.ctx_stats == ref.sched.ctx_stats
        assert port.queue.stats() == ref.queue.stats()
        want, got = ref.ctx_record(), port.ctx_record()
        assert set(got) == set(want) and got
        for k in want:
            if isinstance(want[k], np.ndarray):
                assert got[k].dtype == want[k].dtype, k
                assert np.array_equal(got[k], want[k]), k
            else:
                assert got[k] == want[k], k
    finally:
        for s in sides:
            s.close()
    # the workload reaches what it is for
    assert "dra:" + workloads.DRA_CLASS in got["resources"]
    stats = port.sched.ctx_stats
    assert stats["folds"] + stats["patches"] >= 1 and stats["rebuilds"] == 2
    assert "default/unready" not in port.log
    pinned_node = next(c for c in w["claims"] if c["metadata"]["name"]
                       == "c-pinned")["status"]["allocation"]["nodeName"]
    assert port.log["default/pinned"] == pinned_node
    assert sum(1 for k in port.log if k.startswith("default/contend-")) == 2
    assert any(v == "late-0" for v in port.log.values())
    import chip_smoke
    held = chip_smoke._dra_devices_held(
        w, port.log, [workloads.resource_slice("node-1", 3)])
    assert all(h <= c for h, c in held.values()), held


def test_claim_status_update_keeps_encode_generation():
    """The scheduler writes claim status on every bind of a claimed pod:
    a status-only update neither bumps the pod epoch nor forces a full
    encode; a changed spec (or a new claim) does both."""
    for P in (REF, PORT):
        cache = P.cache.SchedulerCache()
        cache.add_node(P.types.Node.from_dict(node_dict("n0")))
        cache.update_dra_object("ResourceSlice", dev_slice("s0", "n0"))
        cache.update_dra_object("ResourceClaim", claim("c1"))
        cache.snapshot()
        gen, epoch = cache._generation, cache._encoder._pod_epoch
        cache.update_dra_object("ResourceClaim", claim("c1", alloc_node="n0"))
        cache.snapshot()
        assert (cache._generation, cache._encoder._pod_epoch) == (gen, epoch)
        assert cache.dra_catalog.claims[("default", "c1")]["status"]
        cache.update_dra_object("ResourceClaim", claim("c1", count=2))
        assert cache._generation == gen + 1
        assert cache._encoder._pod_epoch == epoch + 1
        cache.update_dra_object("ResourceClaim", claim("c1", count=2),
                                deleted=True)
        assert ("default", "c1") not in cache.dra_catalog.claims


# ---- the runner: allocation at bind, unreserve on a failed binding ----------

def _seed_dra(client, w):
    client.resource("deviceclasses", None).create_many(
        copy.deepcopy(w["classes"]))
    client.resource("resourceslices", None).create_many(
        copy.deepcopy(w["slices"]))
    client.nodes().create_many(copy.deepcopy(w["nodes"] + w["late_nodes"]))
    for c in w["claims"]:
        status = c.get("status")
        made = client.resource("resourceclaims", "default").create(
            copy.deepcopy({k: v for k, v in c.items() if k != "status"}))
        if status:
            made["status"] = copy.deepcopy(status)
            client.resource("resourceclaims", "default").update_status(made)
    client.pods("default").create_many(copy.deepcopy(w["bound"]))
    client.pods("default").create_many(copy.deepcopy(w["pending"]))


def _run_runner(P, w):
    cfg = P.config.SchedulerConfiguration(
        explainer_enabled=False, parity_sample_every=1, batch_size=8,
        max_drain_batches=2, backoff_initial_s=LONG, backoff_max_s=LONG,
        assume_ttl_s=LONG, audit_interval_s=LONG)
    if P is REF:
        client = ref_clientset.DirectClient(ref_store.ObjectStore())
        _seed_dra(client, w)
        runner = ref_runner.SchedulerRunner(client, cfg)
    else:
        gate = port_features.FeatureGate()
        gate.set_from_map({"PreemptionSimulation": False})
        client = port_clientset.DirectClient(port_store.ObjectStore())
        _seed_dra(client, w)
        runner = port_runner.SchedulerRunner(client, cfg, feature_gate=gate,
                                             device="cpu")
    try:
        runner.start(start_loop=False)
        assert _wait_until(lambda: all(
            inf.has_synced() for inf in runner.factory._informers.values()))
        sched = runner.scheduler
        sched._drain_ready = lambda pend: False
        for _ in range(16):
            sched.run_once(wait=0.01)
            if runner.queue.stats()["active"] == 0 and not sched._pending:
                break
        sched._resolve_pending()
        sched.wait_for_bindings()
        bindings = {f"{p['metadata']['namespace']}/{p['metadata']['name']}":
                    p["spec"].get("nodeName", "")
                    for p in client.pods(None).list()}
        claims = {c["metadata"]["name"]: (
            (c.get("status") or {}).get("allocation"),
            [r["name"] for r in (c.get("status") or {})
             .get("reservedFor") or []])
            for c in client.resource("resourceclaims", None).list()}
        return bindings, claims, runner.scheduler.ctx_stats
    finally:
        runner.stop()


def test_runner_allocates_claims_like_reference():
    """Both runners over a DirectClient: the runners' DRA informers feed
    the catalog; every bound claim pod's claims are allocated on its node
    with the pod in ``reservedFor``; bindings and claims equal."""
    gate = ref_features.DEFAULT_FEATURE_GATE
    was = gate.enabled("PreemptionSimulation")
    gate.set_from_map({"PreemptionSimulation": False})
    try:
        w = workloads.dra_mix(nodes=12, pods=24, seed=2, late=0)
        ref = _run_runner(REF, w)
        port = _run_runner(PORT, w)
    finally:
        gate.set_from_map({"PreemptionSimulation": was})
    assert port == ref
    bindings, claims, _stats = port
    by_name = {p["metadata"]["name"]: p for p in w["pending"]}
    for name, p in by_name.items():
        node = bindings[f"default/{name}"]
        for ref_ in p["spec"].get("resourceClaims") or []:
            cname = ref_.get("resourceClaimName") or f"{name}-{ref_['name']}"
            if node and cname != "c-pinned":
                assert claims[cname] == ({"nodeName": node}, [name]), cname
    assert bindings["default/unready"] == ""


def _bind_failure(P, client, runner_cls, **kw):
    """``ok`` binds; ``bad`` was bound elsewhere first, so the runner's
    binding conflicts after its claim was allocated. -> (c-ok, c-bad)."""
    cfg = P.config.SchedulerConfiguration(explainer_enabled=False,
                                          parity_sample_every=0)
    runner = runner_cls(client, cfg, **kw)
    try:
        client.nodes().create_many([node_dict("n0"), node_dict("n1")])
        client.resource("resourceslices", None).create(
            dev_slice("s0", "n0", count=2))
        for name in ("c-ok", "c-bad"):
            client.resource("resourceclaims", "default").create(claim(name))
        client.pods("default").create(pod_dict("ok", "c-ok"))
        client.pods("default").create(pod_dict("bad", "c-bad"))
        client.pods("default").bind("bad", "n1")
        runner.start(start_loop=False)
        assert _wait_until(lambda: runner.cache.dra_catalog is not None
                           and len(runner.cache.dra_catalog.claims) == 2)
        pods = {p["metadata"]["name"]: P.types.Pod.from_dict(p)
                for p in client.pods("default").list()}
        pods["bad"].spec.node_name = ""
        assert runner._bind(pods["ok"], "n0") is True
        assert runner._bind(pods["bad"], "n0") is False
        return tuple(client.resource("resourceclaims", "default").get(c)
                     .get("status") or {} for c in ("c-ok", "c-bad"))
    finally:
        runner.stop()


def test_runner_bind_failure_unreserves_claim():
    """A binding the apiserver refuses (the pod is already bound
    elsewhere) rolls back the claim allocation written before it; a
    binding that succeeds keeps it. Over HTTP against the port's
    APIServer. A deliberate difference: the reference's unreserve sends
    the object it allocated with, whose resourceVersion the allocation
    moved, so it is refused and the claim stays allocated to n0."""
    gate = port_features.FeatureGate()
    gate.set_from_map({"PreemptionSimulation": False})
    got = {}
    for P, client_cls, runner_cls, kw in (
            (PORT, port_clientset.HTTPClient, port_runner.SchedulerRunner,
             dict(feature_gate=gate, device="cpu")),
            (REF, ref_clientset.HTTPClient, ref_runner.SchedulerRunner, {})):
        server = port_apiserver.APIServer().start()
        try:
            got[P.name] = _bind_failure(P, client_cls(server.url, wire="json"),
                                        runner_cls, **kw)
        finally:
            server.stop()
    ok, bad = got["port"]
    assert ok["allocation"] == {"nodeName": "n0"}
    assert [r["name"] for r in ok["reservedFor"]] == ["ok"]
    assert not bad.get("allocation") and not bad.get("reservedFor")
    assert got["ref"][0]["allocation"] == ok["allocation"]
    assert got["ref"][1]["allocation"] == {"nodeName": "n0"}


# ---- a node group with deviceCapacity ----------------------------------------

def test_device_capacity_node_group_scales_up_for_claim_pod():
    """A pending claim pod fits no existing node (none publishes the
    device): only the group whose template carries ``deviceCapacity``
    offers relief, and the port's plan equals the reference's."""
    w_nodes = [node_dict("cpu-only", cpu="8", pods="10")]
    pending = [pod_dict("wants-gpu", "c1"),
               make_pod("plain").req({"cpu": "20"}).obj().to_dict()]
    groups = [
        {"name": "gpu-pool", "maxSize": 3, "deviceCapacity": {"gpu": 8},
         "template": make_node("t").capacity({"cpu": "8", "pods": "10"})
         .obj().to_dict()},
        {"name": "cpu-pool", "maxSize": 3,
         "template": make_node("t").capacity({"cpu": "32", "pods": "10"})
         .obj().to_dict()}]
    out = {}
    for P in (REF, PORT):
        enc = P.snapshot.SnapshotEncoder()
        enc.set_dra(_catalog(P, claims=[claim("c1")]))
        gs = [P.nodegroup.load_node_group(copy.deepcopy(g)) for g in groups]
        tpl = gs[0].template_node("gpu-pool-x")
        assert tpl.status.allocatable["dra:gpu"] == "8"
        opts = P.scale_up(_objs(P, "Node", w_nodes), [],
                          _objs(P, "Pod", pending), gs, encoder=enc)
        out[P.name] = sorted((o.group.name, o.pod_indices, o.nodes_needed,
                              o.waste) for o in opts)
    assert out["port"] == out["ref"]
    assert ("gpu-pool", [0]) in [(g, i) for g, i, _n, _w in out["port"]]
    assert ("cpu-pool", [1]) in [(g, i) for g, i, _n, _w in out["port"]]


def test_chip_smoke_dra_parity_runs_on_the_cpu():
    """The card's parity phase, rehearsed with the CPU on both sides: its
    three legs (gang_drain, the Scheduler's drain with churn, serial rounds
    against the oracle) run whole and hold their own gates."""
    import chip_smoke
    out = chip_smoke.dra_parity_phase(devices=("cpu", "cpu"))
    assert out["serial"]["legs"] == ["oracle", "serial_cpu"]
    assert out["scheduler"]["ctx_stats"]["folds"] >= 1
    assert out["scheduler"]["devices_held"] <= \
        out["scheduler"]["devices_published"]


class _WritesDuringRead(dict):
    """A claim that, when the catalog reads its spec, has the informer's
    thread add another claim: the interleaving of a claim created while
    the scheduling thread encodes, made deterministic."""

    def __init__(self, obj, catalog, n):
        super().__init__(obj)
        self.catalog, self.n = catalog, n

    def get(self, key, default=None):
        if key == "spec" and self.n:
            self.n -= 1
            self.catalog.claims[("default", f"late-{self.n}")] = claim(
                f"late-{self.n}")
            self.catalog.slices[f"s-late-{self.n}"] = dev_slice(
                f"s-late-{self.n}", "n0")
        return super().get(key, default)


def test_catalog_reads_survive_informer_writes():
    """The informer thread writes the catalog while the scheduling thread
    encodes from it. The port's walks over its dicts finish (each walks a
    copy); the reference's walk of the same interleaving raises
    "dictionary changed size during iteration" (a deliberate
    difference)."""
    for P in (REF, PORT):
        cat = _catalog(P, claims=[claim("c0")],
                       slices=[dev_slice("s0", "n0")])
        cat.claims[("default", "c0")] = _WritesDuringRead(
            cat.claims[("default", "c0")], cat, 1)
        cat.slices["s0"] = _WritesDuringRead(cat.slices["s0"], cat, 1)
        if P is REF:
            with pytest.raises(RuntimeError, match="changed size"):
                cat.class_names()
        else:
            assert cat.class_names() == {"gpu"}
            assert cat.node_capacity("n0")["dra:gpu"] >= 1
            enc = P.snapshot.SnapshotEncoder()
            enc.set_dra(cat)
            cat.claims[("default", "c0")].n = 2
            ct, meta = enc.encode_cluster(_objs(P, "Node", [node_dict("n0")]),
                                          [])
            assert "dra:gpu" in meta.resources
