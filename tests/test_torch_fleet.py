"""The port's fleet mode against the JAX package's, on the CPU.

Every case of ``tests/test_fleet.py`` runs the same seeded inputs through
both packages (dicts built with the reference's wrappers, parsed by each
package from the same dicts) and requires what they compute to be equal:
rekeyed and unrekeyed objects, the tenant label columns, filter masks and
oracle reasons, tie-break ranks, drain assignments and rounds
(fleet-batched and per tenant), preemption-wave nodes and victims, the
victim guard, the ``cross_tenant`` invariant, ``FleetQueue`` pops,
``Scheduler._tenant_chunks``, the encoder's per-tenant catalog epochs,
per-instance status ConfigMaps, and a ``FleetRunner`` over two tenant
apiservers (the bindings on each tenant, the fleet status ConfigMap on
every tenant). Tolerance 0 throughout. Then the round trip of the rekey
boundary on every rewritten reference, and ``chip_smoke.fleet_failures``,
the FleetChurn phase's gate.
"""

from __future__ import annotations

import copy
import json
import random
import threading
import time

import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as ref_types
from kubernetes_tpu.audit import invariants as ref_inv
from kubernetes_tpu.client import clientset as ref_clientset
from kubernetes_tpu.config import types as ref_config
from kubernetes_tpu.encode.snapshot import TENANT_KEY_ID, TENANT_LABEL
from kubernetes_tpu.encode.snapshot import SnapshotEncoder as RefEncoder
from kubernetes_tpu.models import gang as ref_gang
from kubernetes_tpu.ops import filters as ref_filters
from kubernetes_tpu.sched import cache as ref_cache
from kubernetes_tpu.sched import fleet as ref_fleet
from kubernetes_tpu.sched import oracle as ref_oracle
from kubernetes_tpu.sched import preemption as ref_preemption
from kubernetes_tpu.sched import queue as ref_queue
from kubernetes_tpu.sched import runner as ref_runner
from kubernetes_tpu.sched import scheduler as ref_scheduler
from kubernetes_tpu.store import apiserver as ref_apiserver
from kubernetes_tpu.store import store as ref_store
from kubernetes_tpu.testing.wrappers import make_node, make_pod
from kubernetes_tpu_torch.api import types as port_types
from kubernetes_tpu_torch.audit import invariants as port_inv
from kubernetes_tpu_torch.client import clientset as port_clientset
from kubernetes_tpu_torch.config import types as port_config
from kubernetes_tpu_torch.encode import snapshot as port_snapshot
from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder as PortEncoder
from kubernetes_tpu_torch.metrics import registry as port_registry
from kubernetes_tpu_torch.models import gang as port_gang
from kubernetes_tpu_torch.ops import filters as port_filters
from kubernetes_tpu_torch.sched import cache as port_cache
from kubernetes_tpu_torch.sched import fleet as port_fleet
from kubernetes_tpu_torch.sched import oracle as port_oracle
from kubernetes_tpu_torch.sched import preemption as port_preemption
from kubernetes_tpu_torch.sched import queue as port_queue
from kubernetes_tpu_torch.sched import runner as port_runner
from kubernetes_tpu_torch.sched import scheduler as port_scheduler
from kubernetes_tpu_torch.store import apiserver as port_apiserver
from kubernetes_tpu_torch.store import store as port_store
from kubernetes_tpu_torch.testing import workloads

pytestmark = pytest.mark.fleet

ZONES = ("z0", "z1", "z2")  # SHARED across tenants on purpose
LONG = 3600.0

# the two packages side by side: every case runs once per entry
PKGS = {
    "ref": dict(types=ref_types, fleet=ref_fleet, Encoder=RefEncoder,
                gang=ref_gang, filters=ref_filters, oracle=ref_oracle,
                preemption=ref_preemption, inv=ref_inv, queue=ref_queue,
                cache=ref_cache, scheduler=ref_scheduler,
                config=ref_config, runner=ref_runner,
                clientset=ref_clientset, store=ref_store,
                apiserver=ref_apiserver),
    "port": dict(types=port_types, fleet=port_fleet, Encoder=PortEncoder,
                 gang=port_gang, filters=port_filters, oracle=port_oracle,
                 preemption=port_preemption, inv=port_inv,
                 queue=port_queue, cache=port_cache,
                 scheduler=port_scheduler, config=port_config,
                 runner=port_runner, clientset=port_clientset,
                 store=port_store, apiserver=port_apiserver),
}
# the port's keyword for the CPU where its entry points default to the card
_DEV = {"ref": {}, "port": {"device": "cpu"}}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _both(fn):
    """-> (reference's result, port's result) of ``fn(pkg name, pkg)``."""
    return fn("ref", PKGS["ref"]), fn("port", PKGS["port"])


def _port_ct(ct, pb=None):
    """The port's ops take tensors; its encoder hands out numpy."""
    return ct.to("cpu") if pb is None else (ct.to("cpu"), pb.to("cpu"))


# ---------------------------------------------------------------------------
# rekey boundary
# ---------------------------------------------------------------------------

def test_rekey_pod_roundtrip_and_references():
    pod = (make_pod("p1", "teamA").req({"cpu": "1"})
           .pod_anti_affinity("zone", {"app": "x"})
           .obj().to_dict())
    pod["spec"]["nodeName"] = "node-3"
    pod["status"] = {"nominatedNodeName": "node-9"}
    pod["spec"]["affinity"]["podAntiAffinity"][
        "requiredDuringSchedulingIgnoredDuringExecution"][0][
        "namespaces"] = ["teamB"]
    original = copy.deepcopy(pod)
    rk = {name: P["fleet"].rekey_for_tenant(3, "pods", pod)
          for name, P in PKGS.items()}
    assert rk["port"] == rk["ref"]
    rk = rk["port"]
    assert rk["metadata"]["namespace"] == "t3.teamA"
    assert rk["spec"]["nodeName"] == "t3.node-3"
    assert rk["status"]["nominatedNodeName"] == "t3.node-9"
    assert rk["metadata"]["labels"][TENANT_LABEL] == "3"
    assert rk["spec"]["affinity"]["podAntiAffinity"][
        "requiredDuringSchedulingIgnoredDuringExecution"][0][
        "namespaces"] == ["t3.teamB"]
    # the ingested original is never mutated (informer stores share it)
    assert pod == original
    uk = {name: P["fleet"].unrekey_for_tenant(3, "pods", rk)
          for name, P in PKGS.items()}
    assert uk["port"] == uk["ref"]
    uk = uk["port"]
    assert uk["metadata"]["namespace"] == "teamA"
    assert uk["spec"]["nodeName"] == "node-3"
    assert uk["status"]["nominatedNodeName"] == "node-9"
    assert TENANT_LABEL not in (uk["metadata"]["labels"] or {})


def test_unrekey_volume_and_claim_writebacks():
    """The binder's write-backs never leak fleet-internal names into a
    tenant apiserver: PVC selected-node annotation + volumeName, PV
    claimRef, DRA claim allocation nodeName and event involvedObject all
    strip — alike in both packages."""
    cases = [
        ("persistentvolumeclaims",
         {"metadata": {"name": "c1", "namespace": "t2.default",
                       "annotations": {
                           "volume.kubernetes.io/selected-node": "t2.n0"}},
          "spec": {"volumeName": "t2.pv1", "storageClassName": "t2.fast"}}),
        ("persistentvolumes",
         {"metadata": {"name": "t2.pv1"},
          "spec": {"storageClassName": "t2.fast",
                   "claimRef": {"namespace": "t2.default", "name": "c1"}}}),
        ("resourceclaims",
         {"metadata": {"name": "rc", "namespace": "t2.default"},
          "status": {"allocation": {"nodeName": "t2.n0"}}}),
        ("events",
         {"metadata": {"name": "e", "namespace": "t2.default"},
          "involvedObject": {"kind": "Pod", "name": "p",
                             "namespace": "t2.default"}}),
    ]
    out = {}
    for plural, obj in cases:
        ref, port = _both(lambda _n, P: P["fleet"].unrekey_for_tenant(
            2, plural, copy.deepcopy(obj)))
        assert port == ref, plural
        out[plural] = port
    pvc = out["persistentvolumeclaims"]
    assert pvc["metadata"]["namespace"] == "default"
    assert pvc["metadata"]["annotations"][
        "volume.kubernetes.io/selected-node"] == "n0"
    assert pvc["spec"]["volumeName"] == "pv1"
    assert pvc["spec"]["storageClassName"] == "fast"
    assert out["persistentvolumes"]["metadata"]["name"] == "pv1"
    assert out["persistentvolumes"]["spec"]["claimRef"]["namespace"] \
        == "default"
    assert out["resourceclaims"]["status"]["allocation"]["nodeName"] == "n0"
    assert out["events"]["involvedObject"]["namespace"] == "default"


def test_rekey_node_and_split():
    node = make_node("n0").obj().to_dict()
    ref, port = _both(lambda _n, P: P["fleet"].rekey_for_tenant(
        12, "nodes", node))
    assert port == ref
    assert port["metadata"]["name"] == "t12.n0"
    for name in ("t12.n0", "n0", "t.n0", "t7.", ""):
        assert port_fleet.split_fleet_name(name) == \
            ref_fleet.split_fleet_name(name)
    assert port_fleet.split_fleet_name("t12.n0") == (12, "n0")
    assert port_fleet.split_fleet_name("n0") == (None, "n0")


def _references():
    """(plural, object) with every reference the boundary rewrites: node
    and PV zone labels, PV nodeAffinity node names and zone terms, pod
    nodeName, nominatedNodeName, affinity namespaces lists (plain and
    weighted), nodeAffinity ``metadata.name`` matchFields (required and
    preferred), PVC volume and class, PV class and claimRef."""
    zone = "topology.kubernetes.io/zone"
    pod = (make_pod("p", "web").req({"cpu": "1"})
           .pod_affinity("kubernetes.io/hostname", {"app": "db"})
           .obj().to_dict())
    pod["spec"]["nodeName"] = "n1"
    pod["status"] = {"nominatedNodeName": "n2"}
    aff = pod["spec"]["affinity"]
    aff["podAffinity"]["requiredDuringSchedulingIgnoredDuringExecution"][
        0]["namespaces"] = ["db", "cache"]
    aff["podAntiAffinity"] = {
        "preferredDuringSchedulingIgnoredDuringExecution": [
            {"weight": 5, "podAffinityTerm": {
                "topologyKey": zone, "namespaces": ["batch"],
                "labelSelector": {"matchLabels": {"app": "x"}}}}]}
    aff["nodeAffinity"] = {
        "requiredDuringSchedulingIgnoredDuringExecution": {
            "nodeSelectorTerms": [{"matchFields": [
                {"key": "metadata.name", "operator": "In",
                 "values": ["n1", "n3"]}]}]},
        "preferredDuringSchedulingIgnoredDuringExecution": [
            {"weight": 1, "preference": {"matchFields": [
                {"key": "metadata.name", "operator": "In",
                 "values": ["n3"]}]}}]}
    node = (make_node("n1").label(zone, "z1")
            .label("topology.kubernetes.io/region", "r1").obj().to_dict())
    pv = {"metadata": {"name": "pv1", "labels": {zone: "z1"}},
          "spec": {"storageClassName": "fast",
                   "claimRef": {"namespace": "web", "name": "c1"},
                   "nodeAffinity": {"required": {"nodeSelectorTerms": [
                       {"matchExpressions": [
                           {"key": zone, "operator": "In",
                            "values": ["z1", "z2"]},
                           {"key": "disk", "operator": "In",
                            "values": ["ssd"]}],
                        "matchFields": [
                            {"key": "metadata.name", "operator": "In",
                             "values": ["n1"]}]}]}}}}
    pvc = {"metadata": {"name": "c1", "namespace": "web"},
           "spec": {"volumeName": "pv1", "storageClassName": "fast"}}
    return [("pods", pod), ("nodes", node), ("persistentvolumes", pv),
            ("persistentvolumeclaims", pvc)]


@pytest.mark.parametrize("plural", ["pods", "nodes", "persistentvolumes",
                                    "persistentvolumeclaims"])
def test_rekey_rewrites_every_reference_and_round_trips(plural):
    """rekey then unrekey gives the object back, in both packages, and the
    rekeyed forms are equal; the rewritten references carry the prefix.
    (A pod's affinity terms keep the prefix on the way back: the
    reference's inverse leaves them, as the scheduler never writes them
    to a tenant.)"""
    obj = dict(_references())[plural]
    ref, port = _both(lambda _n, P: P["fleet"].rekey_for_tenant(
        4, plural, obj))
    assert port == ref
    text = json.dumps(port)
    if plural == "pods":
        for ref_name in ('"t4.n1"', '"t4.n2"', '"t4.n3"', '"t4.db"',
                         '"t4.cache"', '"t4.batch"'):
            assert ref_name in text, ref_name
    elif plural == "nodes":
        assert port["metadata"]["labels"][
            "topology.kubernetes.io/zone"] == "t4.z1"
        assert port["metadata"]["labels"][
            "topology.kubernetes.io/region"] == "t4.r1"
    elif plural == "persistentvolumes":
        term = port["spec"]["nodeAffinity"]["required"][
            "nodeSelectorTerms"][0]
        assert term["matchExpressions"][0]["values"] == ["t4.z1", "t4.z2"]
        assert term["matchExpressions"][1]["values"] == ["ssd"]
        assert term["matchFields"][0]["values"] == ["t4.n1"]
        assert port["spec"]["claimRef"]["namespace"] == "t4.web"
    back = {name: P["fleet"].unrekey_for_tenant(4, plural, port)
            for name, P in PKGS.items()}
    assert back["port"] == back["ref"]
    want = copy.deepcopy(obj)
    want["metadata"]["labels"] = want["metadata"].get("labels") or {}
    if plural == "pods":
        # the inverse strips names, namespaces and node references, not
        # the affinity terms (the scheduler never writes them back)
        want["spec"]["affinity"] = port["spec"]["affinity"]
    assert back["port"] == want


# ---------------------------------------------------------------------------
# tenant plane in the encoder + model stack
# ---------------------------------------------------------------------------

def _tenant_node_dicts(t, n, cpu="4"):
    return [ref_fleet.rekey_for_tenant(t, "nodes", (
        make_node(f"n{i}")
        .capacity({"cpu": cpu, "memory": "8Gi", "pods": "32"})
        .label("kubernetes.io/hostname", f"n{i}")
        .label("topology.kubernetes.io/zone", ZONES[i % len(ZONES)])
        .obj().to_dict())) for i in range(n)]


def _tenant_pod_dict(t, wrapper):
    return ref_fleet.rekey_for_tenant(t, "pods", wrapper.obj().to_dict())


def _nodes(P, dicts):
    return [P["types"].Node.from_dict(copy.deepcopy(d)) for d in dicts]


def _pods(P, dicts):
    return [P["types"].Pod.from_dict(copy.deepcopy(d)) for d in dicts]


def test_tenant_plane_rides_the_label_columns():
    node_dicts = _tenant_node_dicts(0, 2) + _tenant_node_dicts(1, 2)
    pod_dicts = [_tenant_pod_dict(1, make_pod("p0").req({"cpu": "1"}))]

    def run(_name, P):
        enc = P["Encoder"]()
        ct, meta = enc.encode_cluster(_nodes(P, node_dicts), [])
        tv = _np(ct.node_labels)[:, TENANT_KEY_ID]
        pb = enc.encode_pods(_pods(P, pod_dicts), meta)
        pv = _np(pb.pod_labels)[:, TENANT_KEY_ID]
        return ([meta.values.lookup(int(v)) for v in tv[:4]],
                meta.values.lookup(int(pv[0])), tv.tolist(), pv.tolist())

    ref, port = _both(run)
    assert port == ref
    assert port[0] == ["0", "0", "1", "1"]
    assert port[1] == "1"
    assert port_snapshot.TENANT_KEY_ID == TENANT_KEY_ID


def test_tenant_mask_gates_filters_and_oracle():
    node_dicts = _tenant_node_dicts(0, 2) + _tenant_node_dicts(1, 2)
    pod_dicts = [_tenant_pod_dict(0, make_pod("a").req({"cpu": "1"})),
                 _tenant_pod_dict(1, make_pod("b").req({"cpu": "1"}))]

    def run(name, P):
        nodes, pods = _nodes(P, node_dicts), _pods(P, pod_dicts)
        enc = P["Encoder"]()
        ct, meta = enc.encode_cluster(nodes, [])
        pb = enc.encode_pods(pods, meta)
        if name == "port":
            ct, pb = _port_ct(ct, pb)
        mask = _np(P["filters"].run_filters(ct, pb))
        orc = P["oracle"].OracleScheduler(nodes, [])
        m, reasons = orc.feasible(pods[0])
        return mask, m, {k: v.value if hasattr(v, "value") else str(v)
                         for k, v in reasons.items()}, \
            reasons[nodes[2].metadata.name] == P["oracle"].FailReason.TENANT

    ref, port = _both(run)
    np.testing.assert_array_equal(port[0], ref[0])
    assert port[1:] == ref[1:]
    mask = port[0]
    assert mask[0, :2].all() and not mask[0, 2:4].any()
    assert mask[1, 2:4].all() and not mask[1, :2].any()
    assert port[1][:2] == [True, True] and port[1][2:] == [False, False]
    assert port[3]


def _rank(name, P, node_dicts):
    enc = P["Encoder"]()
    ct, _meta = enc.encode_cluster(_nodes(P, node_dicts), [])
    if name == "port":
        ct = _port_ct(ct)
    return _np(P["filters"].tenant_local_rank(ct)), int(ct.node_valid.shape[0])


def test_tenant_local_rank_degenerates_to_arange():
    node_dicts = [make_node(f"n{i}").capacity({"cpu": "1"}).obj().to_dict()
                  for i in range(5)]
    ref, port = _both(lambda n, P: _rank(n, P, node_dicts))
    np.testing.assert_array_equal(port[0], ref[0])
    assert port[0].dtype == ref[0].dtype
    np.testing.assert_array_equal(port[0], np.arange(port[1]))


def test_tenant_local_rank_interleaved():
    # interleave two tenants' nodes: ranks must count per tenant
    n0 = _tenant_node_dicts(0, 3)
    n1 = _tenant_node_dicts(1, 3)
    node_dicts = [n0[0], n1[0], n0[1], n1[1], n0[2], n1[2]]
    ref, port = _both(lambda n, P: _rank(n, P, node_dicts))
    np.testing.assert_array_equal(port[0], ref[0])
    np.testing.assert_array_equal(port[0][:6], [0, 0, 1, 1, 2, 2])


# ---------------------------------------------------------------------------
# THE parity gate: fleet-batched == K independent single-tenant runs
# ---------------------------------------------------------------------------

def _random_workload(rng, t, n_nodes, n_pods):
    """One tenant's randomized cluster: shared zone values, mixed
    capacities, pods with random requests, priorities, spread and
    anti-affinity terms (tests/test_fleet.py's generator)."""
    nodes = [make_node(f"n{i}")
             .capacity({"cpu": rng.choice(["2", "4", "8"]),
                        "memory": "16Gi", "pods": "64"})
             .label("kubernetes.io/hostname", f"n{i}")
             .label("topology.kubernetes.io/zone", rng.choice(ZONES))
             .obj().to_dict() for i in range(n_nodes)]
    pods = []
    for i in range(n_pods):
        w = (make_pod(f"p{i}")
             .req({"cpu": rng.choice(["250m", "500m", "1"])})
             .label("app", rng.choice(["a", "b"]))
             .priority(rng.choice([0, 0, 10])))
        r = rng.random()
        if r < 0.3:
            w = w.spread(1, "topology.kubernetes.io/zone", "DoNotSchedule",
                         {"app": "a"})
        elif r < 0.5:
            w = w.pod_anti_affinity("kubernetes.io/hostname",
                                    {"app": "b"})
        pods.append(w.obj().to_dict())
    return nodes, pods


def _drain_assignments(name, P, node_dicts, pod_chunks, batch, seed=7):
    """Schedule ``pod_chunks`` over the nodes with the drain program, each
    chunk's bucket pinned to ``batch``. -> ({pod key: node or None},
    rounds per chunk)."""
    enc = P["Encoder"]()
    typed_nodes = _nodes(P, node_dicts)
    batches = [_pods(P, c) for c in pod_chunks]
    all_pods = [p for c in batches for p in c]
    ct, meta = enc.encode_cluster(typed_nodes, [], pending_pods=all_pods)
    pbs = [enc.encode_pods(b, meta, min_p=batch) for b in batches]
    a, rounds, _req = P["gang"].gang_drain(ct, pbs, seed=seed,
                                           topo_keys=meta.topo_keys,
                                           **_DEV[name])
    a = _np(a)
    out = {}
    for b, chunk in enumerate(batches):
        for i, p in enumerate(chunk):
            ni = int(a[b][i])
            out[p.key] = meta.node_names[ni] if ni >= 0 else None
    return out, _np(rounds).tolist()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fleet_parity_randomized(seed):
    """Randomized K-tenant clusters: the fleet-batched drain (tenants
    interleaved on the node axis, per-tenant batches, shared zone label
    values) places every tenant's pods EXACTLY where its standalone run
    does, in each package, and the port's placements and rounds equal the
    reference's, fleet and standalone."""
    rng = random.Random(seed)
    K, batch = 3, 8
    per_tenant = {t: _random_workload(rng, t, n_nodes=rng.randint(3, 6),
                                      n_pods=rng.randint(6, 12))
                  for t in range(K)}
    fleet_nodes, fleet_chunks = [], []
    maxn = max(len(n) for n, _p in per_tenant.values())
    for i in range(maxn):
        for t in range(K):
            nodes, _pods_ = per_tenant[t]
            if i < len(nodes):
                fleet_nodes.append(ref_fleet.rekey_for_tenant(
                    t, "nodes", nodes[i]))
    for t in range(K):
        rk = [ref_fleet.rekey_for_tenant(t, "pods", p)
              for p in per_tenant[t][1]]
        fleet_chunks += [rk[i:i + batch] for i in range(0, len(rk), batch)]

    def run(name, P):
        singles = {t: _drain_assignments(
            name, P, nodes,
            [pods[i:i + batch] for i in range(0, len(pods), batch)], batch)
            for t, (nodes, pods) in per_tenant.items()}
        return singles, _drain_assignments(name, P, fleet_nodes,
                                           fleet_chunks, batch)

    ref, port = _both(run)
    assert port == ref
    singles, (fleet, _rounds) = port
    assert any(v is not None for v in fleet.values())
    mismatches = []
    for t in range(K):
        for p in per_tenant[t][1]:
            key = f"default/{p['metadata']['name']}"
            fkey = f"t{t}.default/{p['metadata']['name']}"
            want = singles[t][0][key]
            got = fleet.get(fkey)
            if got is not None:
                tid, got = port_fleet.split_fleet_name(got)
                assert tid == t, f"cross-tenant placement: {fkey} -> {got}"
            if want != got:
                mismatches.append((fkey, want, got))
    assert not mismatches, mismatches


def _wave_result(res):
    if res is None:
        return None
    return res.node_name, sorted(v.key for v in res.victims)


def test_fleet_preempt_wave_parity():
    """Preemption-wave parity: per-tenant victims + chosen nodes in the
    fleet view equal each tenant's standalone wave (and never cross), and
    the port's waves equal the reference's."""

    def leg(name, P, t_ids):
        nodes, bound, views = [], [], []
        for t in t_ids:
            def rk(plural, d):
                return ref_fleet.rekey_for_tenant(t, plural, d) \
                    if t is not None else d
            for i in range(2):
                nd = make_node(f"n{i}").capacity(
                    {"cpu": "2", "memory": "4Gi", "pods": "8"}) \
                    .label("kubernetes.io/hostname", f"n{i}").obj().to_dict()
                nodes.append(P["types"].Node.from_dict(rk("nodes", nd)))
            for i in range(2):
                pd = make_pod(f"victim{i}").req({"cpu": "2"}) \
                    .priority(0).obj().to_dict()
                pd["spec"]["nodeName"] = f"n{i}"
                bound.append(P["types"].Pod.from_dict(rk("pods", pd)))
            hp = make_pod("vip").req({"cpu": "2"}).priority(100) \
                .obj().to_dict()
            views.append(P["types"].Pod.from_dict(rk("pods", hp)))
        return [_wave_result(r) for r in P["preemption"].preempt_wave(
            nodes, bound, views, **_DEV[name])]

    ref, port = _both(lambda n, P: (leg(n, P, [0, 1]), leg(n, P, [None])))
    assert port == ref
    fleet, single = port
    assert all(r is not None for r in fleet)
    for t, (node, victims) in enumerate(fleet):
        tid, raw = port_fleet.split_fleet_name(node)
        assert tid == t
        assert raw == single[0][0]
        assert [port_fleet.split_fleet_name(v.split("/")[0])[0]
                for v in victims] == [t] * len(victims)
        assert [v.split("/", 1)[1] for v in victims] == \
            [v.split("/", 1)[1] for v in single[0][1]]


def test_fleet_gang_atomicity_per_tenant():
    """Per-tenant gangs (anti-affine members needing distinct hosts) ride
    the fleet drain atomically: a gang that fits its OWN tenant binds
    whole; a gang that does NOT fit its tenant never spills onto a sibling
    tenant's idle nodes — in both packages, alike."""
    gang_label = ref_inv.GANG_LABEL
    assert port_inv.GANG_LABEL == gang_label

    def gang(t, size):
        out = []
        for i in range(size):
            w = (make_pod(f"g{i}").req({"cpu": "1"})
                 .label(gang_label, f"gang-{t}")
                 .label("grp", f"g{t}")
                 .pod_anti_affinity("kubernetes.io/hostname",
                                    {"grp": f"g{t}"}))
            out.append(ref_fleet.rekey_for_tenant(t, "pods",
                                                  w.obj().to_dict()))
        return out

    nodes = [ref_fleet.rekey_for_tenant(t, "nodes", n.to_dict())
             for t in (0, 1)
             for n in (make_node(f"n{i}")
                       .capacity({"cpu": "4", "memory": "8Gi", "pods": "8"})
                       .label("kubernetes.io/hostname", f"n{i}").obj()
                       for i in range(3))]
    chunks = [gang(0, 3), gang(1, 5)]
    ref, port = _both(lambda n, P: _drain_assignments(n, P, nodes, chunks,
                                                      batch=8))
    assert port == ref
    got = port[0]
    t0_placed = [v for k, v in got.items() if k.startswith("t0.")]
    t1_placed = [v for k, v in got.items() if k.startswith("t1.")]
    assert all(v is not None for v in t0_placed)
    assert len(set(t0_placed)) == 3          # distinct hosts
    assert all(v is None or v.startswith("t1.") for v in t1_placed)
    assert sum(v is not None for v in t1_placed) <= 3


def test_cross_tenant_victim_guard():
    """Scheduler._evict_victims refuses a preemption result carrying a
    foreign tenant's victim (belt-and-braces behind the mask)."""

    def run(name, P):
        sch = P["scheduler"].Scheduler(
            P["config"].SchedulerConfiguration(), P["cache"].SchedulerCache(),
            P["queue"].SchedulingQueue(), lambda p, n: True, **_DEV[name])
        try:
            evicted = []
            sch._evict = lambda v: evicted.append(v.key)
            preemptor, own, foreign = _pods(P, [
                _tenant_pod_dict(0, make_pod("vip").priority(100)),
                _tenant_pod_dict(0, make_pod("mine")),
                _tenant_pod_dict(1, make_pod("theirs"))])
            first = sch._evict_victims(preemptor, [own]), list(evicted)
            evicted.clear()
            second = sch._evict_victims(preemptor, [own, foreign]), evicted
            return first, second
        finally:
            sch.close()

    ref, port = _both(run)
    assert port == ref
    assert port[0] == (True, ["t0.default/mine"])
    assert port[1] == (False, [])  # nothing evicted when ANY is foreign


# ---------------------------------------------------------------------------
# audit invariant
# ---------------------------------------------------------------------------

def test_cross_tenant_invariant():
    node0 = ref_fleet.rekey_for_tenant(0, "nodes",
                                       make_node("n0").obj().to_dict())
    node1 = ref_fleet.rekey_for_tenant(1, "nodes",
                                       make_node("n0").obj().to_dict())
    ok_pod = ref_fleet.rekey_for_tenant(0, "pods",
                                        make_pod("good").obj().to_dict())
    ok_pod["spec"]["nodeName"] = "t0.n0"
    bad_pod = ref_fleet.rekey_for_tenant(0, "pods",
                                         make_pod("bad").obj().to_dict())
    bad_pod["spec"]["nodeName"] = "t1.n0"
    nom_pod = ref_fleet.rekey_for_tenant(1, "pods",
                                         make_pod("nom").obj().to_dict())
    nom_pod["status"] = {"nominatedNodeName": "t0.n0"}
    plain_pod = make_pod("p").obj().to_dict()
    plain_pod["spec"]["nodeName"] = "x"

    def run(_name, P):
        snap = P["inv"].AuditSnapshot(
            ts=time.time(), rv=None, api_pods=[ok_pod, bad_pod, nom_pod],
            api_nodes=[node0, node1])
        v = P["inv"].check_cross_tenant(snap)
        snap2 = P["inv"].AuditSnapshot(
            ts=time.time(), rv=None, api_pods=[plain_pod],
            api_nodes=[make_node("x").obj().to_dict()])
        return (sorted(x.fingerprint for x in v),
                sorted(x.confirm for x in v),
                P["inv"].check_cross_tenant(snap2))

    ref, port = _both(run)
    assert port == ref
    assert {f[1:3] for f in port[0]} == {
        ("t0.default/bad", "nodeName"),
        ("t1.default/nom", "nominatedNodeName")}
    assert port[1] == [1, 1]
    assert port[2] == []  # untenanted cluster: the check is a no-op


# ---------------------------------------------------------------------------
# fairness plane
# ---------------------------------------------------------------------------

def _queued(P, t, name, prio=0):
    p = P["types"].Pod.from_dict(
        make_pod(name, f"t{t}.default").priority(prio).obj().to_dict())
    p.metadata.labels[TENANT_LABEL] = str(t)
    return p


def _popped(batch):
    return [(p.metadata.labels.get(TENANT_LABEL), p.metadata.name, a)
            for p, a in batch]


def test_fleet_queue_round_robin_blocks():
    def run(_name, P):
        q = P["fleet"].FleetQueue(block=4)
        for t in range(3):
            for i in range(10):
                q.add(_queued(P, t, f"p{i}"))
        return _popped(q.pop_batch(12, wait=0.1)), dict(q.batch_share)

    ref, port = _both(run)
    assert port == ref
    batch = [t for t, _n, _a in port[0]]
    assert len(batch) == 12
    for i in range(0, 12, 4):
        assert len(set(batch[i:i + 4])) == 1  # single-tenant blocks
    assert set(batch) == {"0", "1", "2"}      # nobody starved
    assert port[1] == {"0": 4, "1": 4, "2": 4}


def test_fleet_queue_weighted_and_rotating():
    def run(_name, P):
        q = P["fleet"].FleetQueue(block=2, weights={"0": 2})
        for t in range(2):
            for i in range(8):
                q.add(_queued(P, t, f"p{i}"))
        return (_popped(q.pop_batch(6, wait=0.1)),
                _popped(q.pop_batch(2, wait=0.1)))

    ref, port = _both(run)
    assert port == ref
    batch = [t for t, _n, _a in port[0]]
    # tenant 0 carries weight 2: two blocks per rotation vs one
    assert batch.count("0") == 4 and batch.count("1") == 2
    # rotation cursor moved: the next pop starts from the other tenant
    assert [t for t, _n, _a in port[1]] == ["1", "1"]


def test_fleet_queue_short_block_closes_pop():
    def run(_name, P):
        q = P["fleet"].FleetQueue(block=4)
        q.add(_queued(P, 0, "only"))       # tenant 0: 1 pod (short block)
        for i in range(8):
            q.add(_queued(P, 1, f"p{i}"))
        return _popped(q.pop_batch(8, wait=0.1)), \
            _popped(q.pop_batch(16, wait=0.1))

    ref, port = _both(run)
    assert port == ref
    batch, rest = port
    tenants = [t for t, _n, _a in batch]
    if tenants[0] == "0":
        assert [(t, n) for t, n, _a in batch] == [("0", "only")]
    else:
        assert tenants[:4] == ["1"] * 4 and batch[4][0] == "0"
    # leftovers stay queued (priority order intact)
    assert len(batch) + len(rest) == 9


def test_fleet_queue_single_tenant_degenerates():
    def run(_name, P):
        q = P["fleet"].FleetQueue(block=4)
        for i in range(6):
            q.add(P["types"].Pod.from_dict(
                make_pod(f"p{i}").priority(i).obj().to_dict()))
        return [p.metadata.name for p, _ in q.pop_batch(6, wait=0.1)]

    ref, port = _both(run)
    assert port == ref
    assert port == [f"p{i}" for i in range(5, -1, -1)]  # priority desc


def test_scheduler_tenant_chunks():
    def run(name, P):
        sch = P["scheduler"].Scheduler(
            P["config"].SchedulerConfiguration(batch_size=4,
                                               max_drain_batches=4),
            P["cache"].SchedulerCache(), P["queue"].SchedulingQueue(),
            lambda p, n: True, **_DEV[name])
        try:
            items = [(_queued(P, t, f"p{i}"), 0)
                     for t in (0, 1) for i in range(6)]

            def keys(chunks):
                return [[p.key for p, _a in c] for c in chunks]
            plain = keys(sch._tenant_chunks(items, 4))
            sch.fleet_mode = True
            fleet = keys(sch._tenant_chunks(items, 4))
            # more chunks than the drain width: adjacent ones merge
            sch.cfg.max_drain_batches = 2
            merged = keys(sch._tenant_chunks(items[:3] + items[6:9], 4))
            return plain, fleet, merged
        finally:
            sch.close()

    ref, port = _both(run)
    assert port == ref
    plain, fleet, merged = port
    assert [len(c) for c in plain] == [4, 4, 4]  # fleet off: mixed slices
    for c in fleet:
        assert len({k.split(".")[0] for k in c}) == 1  # tenant-homogeneous
    assert sorted(len(c) for c in fleet) == [2, 2, 4, 4]
    assert [len(c) for c in merged] == [3, 3]


# ---------------------------------------------------------------------------
# per-tenant catalog epochs
# ---------------------------------------------------------------------------

def test_tenant_scoped_catalog_epochs():
    def run(_name, P):
        enc = P["Encoder"]()
        p0, p1 = _pods(P, [
            _tenant_pod_dict(0, make_pod("a").req({"cpu": "1"})),
            _tenant_pod_dict(1, make_pod("b").req({"cpu": "1"}))])
        enc.precompile_pod(p0)
        enc.precompile_pod(p1)
        nodes = _nodes(P, _tenant_node_dicts(0, 1)
                       + _tenant_node_dicts(1, 1))
        _ct, meta = enc.encode_cluster(nodes, [], pending_pods=[p0, p1])
        out = []
        enc.pod_cache_hits = enc.pod_cache_misses = 0
        # tenant 1's namespace churns: ONLY tenant 1's record invalidates
        enc.set_namespaces({"t1.default": {TENANT_LABEL: "1", "x": "y"}},
                           changed_tenants={"1"})
        enc.encode_pods([p0, p1], meta)
        out.append((enc.pod_cache_hits, enc.pod_cache_misses))
        # a GLOBAL catalog change (volumes) still invalidates everyone
        enc.pod_cache_hits = enc.pod_cache_misses = 0
        enc.set_volumes(None)
        enc.encode_pods([p0, p1], meta)
        out.append((enc.pod_cache_hits, enc.pod_cache_misses))
        return out

    ref, port = _both(run)
    assert port == ref
    assert port == [(1, 1), (0, 2)]


# ---------------------------------------------------------------------------
# status publishing: parameterized ConfigMap names
# ---------------------------------------------------------------------------

def test_two_tenant_status_publishers_do_not_collide():
    """Two scheduler identities on ONE apiserver, publishing concurrently
    with per-instance ConfigMap names: both survive with their own
    identity, in both packages."""

    def run(name, P):
        client = P["clientset"].DirectClient(P["store"].ObjectStore())
        runners = [
            P["runner"].SchedulerRunner(
                client, identity=f"sched-{i}",
                status_name=f"scheduler-status-{i}",
                explain_name=f"scheduler-explanations-{i}",
                trace_name=f"scheduler-trace-{i}", **_DEV[name])
            for i in range(2)]
        try:
            threads = [threading.Thread(target=r.publish_status)
                       for r in runners for _ in range(3)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(10.0)
            return [json.loads(client.resource("configmaps", "default").get(
                f"scheduler-status-{i}")["data"]["status"])["identity"]
                for i in range(2)]
        finally:
            for r in runners:
                r.stop()

    ref, port = _both(run)
    assert port == ref == ["sched-0", "sched-1"]


# ---------------------------------------------------------------------------
# connected: 2 tenant apiservers, one FleetRunner
# ---------------------------------------------------------------------------

def _wait(cond, timeout=60.0, what="condition"):
    end = time.time() + timeout
    while not cond():
        if time.time() > end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)


def _fleet_side(name, P):
    """Two tenant apiservers over HTTP with three nodes and six pods each,
    one FleetRunner, driven pop by pop with its loop stopped. -> (bindings
    per tenant, fleet status per tenant, audit violations, queue pops)."""
    servers = [P["apiserver"].APIServer().start() for _ in range(2)]
    clients = [P["clientset"].HTTPClient(s.url) for s in servers]
    runner = None
    try:
        for c in clients:
            for i in range(3):
                c.nodes().create(make_node(f"n{i}").capacity(
                    {"cpu": "4", "memory": "8Gi", "pods": "32"})
                    .obj().to_dict())
            for i in range(6):
                c.pods("default").create(
                    make_pod(f"p{i}", "default").req({"cpu": "100m"})
                    .obj().to_dict())
        runner = P["fleet"].FleetRunner(
            clients, P["config"].SchedulerConfiguration(
                batch_size=8, explainer_enabled=False,
                parity_sample_every=1, backoff_initial_s=LONG,
                backoff_max_s=LONG, assume_ttl_s=LONG,
                audit_interval_s=LONG), **_DEV[name])
        runner.start(wait_sync=30.0, start_loop=False)
        _wait(lambda: all(inf.has_synced()
                          for inf in runner._all_informers()),
              what="informer sync")
        _wait(lambda: runner.queue.stats()["active"] == 12,
              what="12 queued pods")
        sched = runner.scheduler
        sched._drain_ready = lambda pend: False
        pops = []
        for _ in range(8):
            before = dict(runner.queue.batch_share)
            sched.run_once(wait=0.01)
            pops.append({t: n - before.get(t, 0)
                         for t, n in runner.queue.batch_share.items()
                         if n != before.get(t, 0)})
            if sched.sentinel is not None:
                sched.sentinel.drain(30.0)
            if runner.queue.stats()["active"] == 0 and not sched._pending:
                break
        sched._resolve_pending()
        sched.wait_for_bindings()
        _wait(lambda: all(
            all(p["spec"].get("nodeName") for p in c.pods("default").list())
            for c in clients), what="bindings on both tenants")
        _wait(lambda: not runner.cache.audit_view()["assumed"],
              what="bind confirmations")
        bindings = [{p["metadata"]["name"]: p["spec"]["nodeName"]
                     for p in c.pods("default").list()} for c in clients]
        runner.auditor.run_once()
        runner.auditor.run_once()
        runner.publish_status()
        status = [json.loads(c.resource("configmaps", "default").get(
            port_fleet.FLEET_SCHED_CONFIGMAP)["data"]["fleetSched"])
            for c in clients]
        for st in status:
            st.pop("updated")
        return bindings, status, runner.auditor.total_violations, pops
    finally:
        if runner is not None:
            runner.kill()
        for s in servers:
            s.stop()


def test_fleet_runner_e2e_two_tenants():
    """Both packages' FleetRunners bind every pod of both tenants to the
    same nodes, with RAW node names on each tenant's apiserver; the fleet
    status ConfigMap lands on every tenant, equal; the auditor (with
    ``cross_tenant`` live) confirms nothing; the pops are single-tenant
    blocks in the same order; the port's fleet gauges carry the status."""
    ref, port = _both(_fleet_side)
    assert port == ref
    bindings, status, violations, pops = port
    for b in bindings:
        assert len(b) == 6
        assert set(b.values()) <= {"n0", "n1", "n2"}
    assert violations == 0
    for st in status:
        assert st["tenants"] == 2
        assert st["identity"] == "kubernetes-tpu-fleet-scheduler"
        assert all(d["bound"] == 6 and d["pending"] == 0
                   and d["batchShare"] == 6 for d in st["tenant"].values())
    assert [p for p in pops if p] == [{"0": 6}, {"1": 6}] or \
        [p for p in pops if p] == [{"1": 6}, {"0": 6}]
    for t in ("0", "1"):
        assert port_registry.FLEET_BATCH_SHARE.get({"tenant": t}) == 6
        assert port_registry.FLEET_PENDING.get({"tenant": t}) == 0


def test_fleet_runner_refuses_leader_election_and_no_tenants():
    for P in PKGS.values():
        with pytest.raises(ValueError, match="leader election"):
            P["fleet"].FleetRunner(
                [], P["config"].SchedulerConfiguration(leader_elect=True))
        with pytest.raises(ValueError, match=">= 1 tenant"):
            P["fleet"].FleetRunner([])


def test_fleet_bind_refuses_cross_tenant_pairs():
    """The per-tenant binder splits a batch per tenant apiserver and
    refuses a pod bound onto another tenant's node, alike."""

    def run(name, P):
        clients = [P["clientset"].DirectClient(P["store"].ObjectStore())
                   for _ in range(2)]
        for c in clients:
            c.nodes().create(make_node("n0").obj().to_dict())
            c.pods("default").create(make_pod("p").obj().to_dict())
        runner = P["fleet"].FleetRunner(clients, **_DEV[name])
        try:
            pods = _pods(P, [_tenant_pod_dict(t, make_pod("p"))
                             for t in (0, 1)])
            out = runner._bind_many([(pods[0], "t0.n0"),
                                     (pods[1], "t0.n0")])
            return out, [[p["spec"].get("nodeName")
                           for p in c.pods("default").list()]
                          for c in clients]
        finally:
            runner.kill()

    ref, port = _both(run)
    assert port == ref
    assert port == ([True, False], [["n0"], [None]])


# ---------------------------------------------------------------------------
# DRA objects behind the boundary (the port rewrites their node names)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plural", ["resourceslices", "resourceclaims"])
def test_rekey_dra_node_names_round_trip(plural):
    """The port prefixes the node a ResourceSlice publishes for and the
    node a claim is allocated on, and its inverse strips both. The
    reference leaves both raw, so its catalog finds no slice for a
    tenant's ``t<id>.`` node: a deliberate difference."""
    obj = (workloads.resource_slice("n1", 2, name="s1")
           if plural == "resourceslices"
           else workloads.resource_claim("c1", alloc_node="n1"))

    def node_of(o):
        return (o["spec"]["nodeName"] if plural == "resourceslices"
                else o["status"]["allocation"]["nodeName"])

    ref, port = _both(lambda _n, P: P["fleet"].rekey_for_tenant(
        3, plural, obj))
    assert node_of(ref) == "n1"
    assert node_of(port) == "t3.n1"
    assert {k: v for k, v in port.items() if k not in ("spec", "status")} \
        == {k: v for k, v in ref.items() if k not in ("spec", "status")}
    back = port_fleet.unrekey_for_tenant(3, plural, port)
    want = copy.deepcopy(obj)
    want["metadata"]["labels"] = {}
    assert back == want


def test_fleet_runner_schedules_claim_pods_on_their_tenant():
    """One FleetRunner over two tenants: tenant 0's pod asks for a device
    that only its node n1 publishes; tenant 1's pod holds a claim already
    allocated on its n0. Each binds there, and each tenant's apiserver
    sees its claim allocated on the RAW node name: tenant 0's newly, with
    its pod in ``reservedFor``; tenant 1's as it was (the binder leaves an
    allocated claim alone, as the reference's does)."""
    clients = [port_clientset.DirectClient(port_store.ObjectStore())
               for _ in range(2)]
    for t, c in enumerate(clients):
        c.nodes().create_many([
            make_node(f"n{i}").capacity({"cpu": "4", "pods": "10"})
            .obj().to_dict() for i in range(2)])
        c.resource("deviceclasses", None).create(workloads.device_class())
        c.resource("resourceslices", None).create(
            workloads.resource_slice("n1" if t == 0 else "n0", 1))
        c.resource("resourceclaims", "default").create(
            workloads.resource_claim("c"))
        if t == 1:
            made = c.resource("resourceclaims", "default").get("c")
            made["status"] = {"allocation": {"nodeName": "n0"},
                              "reservedFor": []}
            c.resource("resourceclaims", "default").update_status(made)
        c.pods("default").create(workloads.with_claim(
            make_pod("p").req({"cpu": "100m"}).obj().to_dict(), "c"))
    runner = port_fleet.FleetRunner(
        clients, port_config.SchedulerConfiguration(
            explainer_enabled=False, parity_sample_every=0,
            backoff_initial_s=LONG, backoff_max_s=LONG,
            assume_ttl_s=LONG, audit_interval_s=LONG), device="cpu")
    try:
        runner.start(wait_sync=30.0, start_loop=False)
        _wait(lambda: runner.queue.stats()["active"] == 2
              and len(runner.cache.dra_catalog.claims) == 2,
              what="2 queued pods and their claims")
        sched = runner.scheduler
        sched._drain_ready = lambda pend: False
        for _ in range(8):
            sched.run_once(wait=0.01)
            if runner.queue.stats()["active"] == 0 and not sched._pending:
                break
        sched._resolve_pending()
        sched.wait_for_bindings()
        got = []
        for c in clients:
            pod = c.pods("default").get("p")
            st = c.resource("resourceclaims", "default").get("c")["status"]
            got.append((pod["spec"].get("nodeName"),
                        st["allocation"]["nodeName"],
                        [r["name"] for r in st.get("reservedFor") or []]))
    finally:
        runner.kill()
    assert got == [("n1", "n1", ["p"]), ("n0", "n0", [])]


# ---------------------------------------------------------------------------
# the FleetChurn phase's gate (chip_smoke.fleet_failures)
# ---------------------------------------------------------------------------

def _fleet_result(**over):
    tenant = {str(t): {"created": 20, "bound": 20, "unbound": 0,
                       "ratio": 1.0, "max_bind_s": 3.0, "p50_bind_s": 1.0,
                       "p99_bind_s": 3.0, "binds": 20} for t in range(4)}
    res = {"tenants": 4, "upfront_per_tenant": 2500,
           "upfront_bound": [2500] * 4,
           "audit": {"violations": 0, "byInvariant": {}},
           "sentinel": {"divergences": 0},
           "ctx_window": {"steady_compiles": 0, "rebuilds": 0},
           "tenant": tenant, "prefix_leaks": [],
           "fleet_configmaps": [4, 4, 4, 4]}
    res.update(over)
    return res


def test_fleet_gate_fails_a_churn_pod_unbound_after_the_timeout():
    import chip_smoke
    res = _fleet_result()
    assert chip_smoke.fleet_failures(res) == []
    res["tenant"]["2"].update(unbound=1, bound=19, ratio=0.95)
    fails = chip_smoke.fleet_failures(res)
    assert len(fails) == 1 and "tenant 2" in fails[0] \
        and "120" in fails[0]
    res = _fleet_result()
    res["tenant"]["1"]["max_bind_s"] = 121.5  # bound, past the wall
    assert any("tenant 1" in f for f in chip_smoke.fleet_failures(res))


def test_fleet_gate_reports_the_p99_slo_without_gating_on_it():
    import chip_smoke
    res = _fleet_result()
    for t in res["tenant"].values():
        t.update(p99_bind_s=12.0, max_bind_s=12.0)
    assert chip_smoke.fleet_failures(res) == []
    slo = chip_smoke.fleet_slo(res)
    assert slo["p99_slo_s"] == 10.0
    assert slo["p99_slo_met"] is False
    assert all(v is False for v in slo["tenant_p99_slo_met"].values())
    for key, bad in (("upfront_bound", [2500, 2499, 2500, 2500]),
                     ("prefix_leaks", ["t0.n3"]),
                     ("fleet_configmaps", [4, 4, 0, 4])):
        assert chip_smoke.fleet_failures(_fleet_result(**{key: bad}))
    assert chip_smoke.fleet_failures(_fleet_result(
        audit={"violations": 1, "byInvariant": {"cross_tenant": 1}}))
    assert chip_smoke.fleet_failures(_fleet_result(
        ctx_window={"steady_compiles": 1, "rebuilds": 0}))
    res = _fleet_result()
    res["tenant"]["3"].update(created=0, bound=0, ratio=None)
    assert chip_smoke.fleet_failures(res)
    res = _fleet_result()
    res["tenant"]["0"].update(ratio=0.4)
    assert chip_smoke.fleet_failures(res)
