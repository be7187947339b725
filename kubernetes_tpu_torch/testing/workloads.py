"""Workload generators for the port: MixedHeterogeneous, copied from
``benchmarks/workloads.py`` so the port builds it without the JAX package,
``relational_mix``, the parity tests' small cluster,
``required_terms_mix``, its cluster under wide required pod (anti-)affinity,
``build_saturated``, the preemption cluster, copied from
``benchmarks/preemption_bench.py``, and the planners' clusters:
``planner_fuzz_cluster`` (``tests/test_planner.py``'s fuzz generator),
``autoscaler_scale_up`` and ``descheduler_defrag``
(``benchmarks/config/performance-config.yaml``'s ClusterAutoscalerScaleUp
and DeschedulerDefrag cases, their templates copied as data, materialized
as ``benchmarks/scheduler_perf.py`` does) and ``planner_loop``
(``benchmarks/plannerloop.py``'s cluster).

Deterministic via seed: all randomness comes from its own
``random.Random(seed)``, so the same (params, seed) yields the same objects
as the reference generator.
"""

from __future__ import annotations

import random

from kubernetes_tpu_torch.api.types import (LabelSelector, PodAffinityTerm,
                                            Requirement)
from kubernetes_tpu_torch.autoscaler.nodegroup import NODE_GROUP_LABEL
from kubernetes_tpu_torch.topology.slicing import GANG_LABEL
from kubernetes_tpu_torch.testing.wrappers import make_node, make_pod

ZONES = [f"zone-{i}" for i in range(10)]


def mixed_heterogeneous(pods: int = 10000, nodes: int = 5000, seed: int = 0):
    """Config 5: 10k heterogeneous pods (affinity+spread+taints) on 5k nodes."""
    rng = random.Random(seed)
    ns = []
    for i in range(nodes):
        w = (make_node(f"node-{i}")
             .capacity({"cpu": rng.choice(["16", "32", "64"]),
                        "memory": rng.choice(["64Gi", "128Gi"]), "pods": "110"})
             .label("topology.kubernetes.io/zone", ZONES[i % len(ZONES)])
             .label("disk", rng.choice(["ssd", "hdd"])))
        if i % 20 == 0:
            w.taint("dedicated", "infra", "NoSchedule")
        ns.append(w.obj())
    ps = []
    for i in range(pods):
        w = (make_pod(f"pod-{i}").label("app", f"svc-{i % 100}")
             .req({"cpu": rng.choice(["100m", "250m", "500m", "1"]),
                   "memory": rng.choice(["128Mi", "512Mi", "1Gi"])}))
        r = rng.random()
        if r < 0.2:
            w.spread(2, "topology.kubernetes.io/zone", "ScheduleAnyway",
                     {"app": f"svc-{i % 100}"})
        elif r < 0.3:
            w.node_selector({"disk": "ssd"})
        elif r < 0.35:
            w.toleration(key="dedicated", operator="Equal", value="infra",
                         effect="NoSchedule")
        elif r < 0.4:
            w.preferred_pod_affinity(50, "topology.kubernetes.io/zone",
                                     {"app": f"svc-{i % 100}"})
        ps.append(w.obj())
    return ns, ps


def relational_mix(pods: int = 48, nodes: int = 24, bound: int = 24,
                   seed: int = 0):
    """A small cluster that reaches every filter, score and relational path:
    taints of all three effects, an unschedulable node, images, host ports,
    numeric labels, a second namespace, existing pods with required
    anti-affinity (the symmetry veto), and pending pods with node
    (anti-)affinity, tolerations, required and preferred pod (anti-)affinity
    (own, listed and selected namespaces), hard and soft spread, priorities
    and a pinned node name. -> (nodes, bound pods, pending pods, namespace
    labels); the bound pods carry their nodeName."""
    rng = random.Random(seed)
    zones = ZONES[:4]
    ns_labels = {"default": {"team": "core"}, "other": {"team": "edge"}}
    out_nodes = []
    for i in range(nodes):
        w = (make_node(f"node-{i}")
             .capacity({"cpu": rng.choice(["4", "8"]),
                        "memory": rng.choice(["8Gi", "16Gi"]), "pods": "16"})
             .label("topology.kubernetes.io/zone", zones[i % len(zones)])
             .label("disk", rng.choice(["ssd", "hdd"]))
             .label("rank", str(i % 7)))
        if i % 6 == 1:
            w.taint("dedicated", "infra", "NoSchedule")
        if i % 6 == 2:
            w.taint("spot", "", "PreferNoSchedule")
        if i % 11 == 3:
            w.taint("evict", "yes", "NoExecute")
        if i % 13 == 5:
            w.unschedulable()
        if i % 3 == 0:
            w.image("registry/app:v1", 300 * 1024 * 1024)
        if i % 4 == 0:
            w.image("registry/db:v2", 900 * 1024 * 1024)
        out_nodes.append(w.obj())

    apps = ["a", "b", "c", "d"]

    def pod(name, i):
        app = apps[i % len(apps)]
        ns = "other" if i % 5 == 4 else "default"
        return (make_pod(name, namespace=ns).label("app", app)
                .req({"cpu": rng.choice(["100m", "500m", "1"]),
                      "memory": rng.choice(["128Mi", "1Gi"])}))

    out_bound = []
    for i in range(bound):
        w = pod(f"old-{i}", i).node(f"node-{rng.randrange(nodes)}")
        if i % 4 == 0:
            w.pod_anti_affinity("kubernetes.io/hostname", {"app": "d"})
        if i % 9 == 2:
            # one port per node whatever the seed
            w.host_port(8080 + i % 2).node(f"node-{i % nodes}")
        out_bound.append(w.obj())

    out_pending = []
    for i in range(pods):
        w = pod(f"new-{i}", i).priority(rng.choice([0, 0, 10]))
        # every kind appears whatever the seed, so the bucket widths (and
        # with them the shapes) do not depend on it
        kind = i % 16
        if kind == 0:
            w.pod_anti_affinity("kubernetes.io/hostname", {"app": "a"})
        elif kind == 1:
            w.pod_affinity("topology.kubernetes.io/zone", {"app": "b"})
        elif kind == 2:
            w.spread(1, "topology.kubernetes.io/zone", "DoNotSchedule",
                     {"app": "c"}, min_domains=rng.choice([None, 5]),
                     node_taints_policy=rng.choice(["Honor", "Ignore"]))
        elif kind == 3:
            w.spread(2, "kubernetes.io/hostname", "ScheduleAnyway",
                     {"app": "c"})
        elif kind == 4:
            w.preferred_pod_affinity(30, "topology.kubernetes.io/zone",
                                     {"app": "b"})
            w.preferred_pod_affinity(20, "kubernetes.io/hostname",
                                     {"app": "a"}, anti=True)
        elif kind == 5:
            w.pod_anti_affinity("topology.kubernetes.io/zone", {"app": "d"},
                                namespaces=["other"])
        elif kind == 6:
            w.pod_affinity("topology.kubernetes.io/zone", {"app": "a"},
                           namespace_selector={"team": "edge"})
        elif kind == 7:
            w.node_affinity_expr(Requirement("disk", "In", ["ssd"]),
                                 Requirement("rank", "Gt", ["2"]))
        elif kind == 8:
            w.preferred_node_affinity(40, Requirement("disk", "NotIn", ["ssd"]))
            w.preferred_node_affinity(10, Requirement("rank", "Lt", ["3"]))
        elif kind == 9:
            w.toleration(key="dedicated", operator="Equal", value="infra",
                         effect="NoSchedule")
            w.toleration(key="spot", operator="Exists")
        elif kind == 10:
            w.node_selector({"disk": "ssd"})
        elif kind == 11:
            w.host_port(8080)
        elif kind == 12:
            w.image(rng.choice(["registry/app:v1", "registry/db:v2"]))
        elif kind == 13:
            w.node(f"node-{rng.randrange(nodes)}")
        out_pending.append(w.obj())
    return out_nodes, out_bound, out_pending, ns_labels


def required_terms_mix(pods: int = 256, nodes: int = 5000, bound: int = 2000,
                       seed: int = 0):
    """``relational_mix``'s nodes and bound pods, with pending pods whose
    required pod affinity and anti-affinity have several terms, each with
    several expressions (In / NotIn / Exists / DoesNotExist, id sets of
    several values) and namespace sets (own, listed or selected), so
    the relational count runs at T, X, V > 1. Every term shape appears
    whatever the seed. -> (nodes, bound pods, pending pods, namespace
    labels)."""
    out_nodes, out_bound, _, ns_labels = relational_mix(
        pods=0, nodes=nodes, bound=bound, seed=seed)
    rng = random.Random(seed)
    zone, host = "topology.kubernetes.io/zone", "kubernetes.io/hostname"

    def term(topo, exprs, labels=None, namespaces=(), ns_selector=None):
        return PodAffinityTerm(
            topology_key=topo,
            label_selector=LabelSelector(match_labels=dict(labels or {}),
                                         match_expressions=list(exprs)),
            namespaces=list(namespaces),
            namespace_selector=(None if ns_selector is None
                                else LabelSelector(match_labels=ns_selector)))

    apps = ["a", "b", "c", "d"]
    out_pending = []
    for i in range(pods):
        w = (make_pod(f"req-{i}", namespace="other" if i % 3 == 2
                      else "default")
             .label("app", apps[i % 4])
             .req({"cpu": rng.choice(["100m", "500m"]), "memory": "128Mi"}))
        aff = w._pod_affinity_target(anti=False).required
        anti = w._pod_affinity_target(anti=True).required
        aff.append(term(zone, [Requirement("app", "In", ["a", "b", "c"]),
                               Requirement("app", "NotIn", ["d"])],
                        namespaces=["default", "other"]))
        if i % 2 == 0:
            aff.append(term(host, [Requirement("app", "Exists")],
                            labels={"app": apps[(i + 1) % 4]}))
        anti.append(term(host, [Requirement("app", "In", ["c", "d", "x"]),
                                Requirement("tier", "DoesNotExist"),
                                Requirement("app", "NotIn", ["a"])],
                         namespaces=["other"]))
        if i % 4 < 2:
            anti.append(term(zone, [Requirement("app", "In",
                                                [apps[i % 4], "z"])],
                             ns_selector={"team": "core"}))
        out_pending.append(w.obj())
    return out_nodes, out_bound, out_pending, ns_labels


def build_saturated(n_nodes: int, pods_per_node: int = 2):
    """The preemption cluster: ``n_nodes`` nodes of 8 CPU / 32Gi / 32 pods,
    each full with ``pods_per_node`` bound pods of 4 CPU / 4Gi at priority
    ``1 + (i + j) % 5``. -> (nodes, bound)."""
    nodes = [make_node(f"n{i}").capacity(
        {"cpu": "8", "memory": "32Gi", "pods": "32"}).obj()
        for i in range(n_nodes)]
    bound = []
    for i in range(n_nodes):
        for j in range(pods_per_node):
            bound.append(
                make_pod(f"low-{i}-{j}")
                .req({"cpu": "4", "memory": "4Gi"})
                .priority(1 + (i + j) % 5).node(f"n{i}").obj())
    return nodes, bound


# ---- the planners' clusters ---------------------------------------------



def planner_fuzz_cluster(seed: int):
    """``tests/test_planner.py``'s ``_fuzz_cluster``: 8 nodes of random
    size, 0-2 bound pods each. -> (nodes, bound)."""
    rng = random.Random(seed)
    nodes, bound = [], []
    for i in range(8):
        cpu, mem = rng.choice([("8", "16Gi"), ("4", "8Gi"), ("16", "32Gi")])
        nodes.append(make_node(f"f{i}")
                     .capacity({"cpu": cpu, "memory": mem, "pods": "32"})
                     .label("disk", rng.choice(["ssd", "hdd"]))
                     .label("kubernetes.io/hostname", f"f{i}")
                     .label(NODE_GROUP_LABEL, "fuzz-pool")
                     .obj())
    k = 0
    for i in range(8):
        for _ in range(rng.randint(0, 2)):
            bound.append(make_pod(f"fb{k}")
                         .req({"cpu": rng.choice(["500m", "1", "2"])})
                         .node(f"f{i}").obj())
            k += 1
    return nodes, bound


# benchmarks/config/templates, as yaml.safe_load parses them
_PAUSE = "registry.k8s.io/pause:3.9"
NODE_DEFAULT = {"apiVersion": "v1", "kind": "Node",
                "metadata": {"generateName": "perf-node-"},
                "status": {"capacity": {"cpu": "32", "memory": "128Gi",
                                        "pods": "110"},
                           "allocatable": {"cpu": "32", "memory": "128Gi",
                                           "pods": "110"}}}


def _pod_template(generate_name: str, cpu: str, memory: str) -> dict:
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"generateName": generate_name},
            "spec": {"containers": [{
                "name": "c", "image": _PAUSE,
                "resources": {"requests": {"cpu": cpu, "memory": memory}}}]}}


POD_DEFAULT = _pod_template("perf-pod-", "500m", "500Mi")
POD_AUTOSCALER_FILL = _pod_template("fill-pod-", "31700m", "127Gi")
POD_DEFRAG_FILL = _pod_template("defrag-fill-", "12", "48Gi")
POD_DEFRAG_GANG = _pod_template("defrag-gang-", "24", "96Gi")


def _node_group(name, max_size, priority, instance_type, cpu, memory, pods):
    caps = {"cpu": cpu, "memory": memory, "pods": pods}
    return {"name": name, "minSize": 0, "maxSize": max_size,
            "priority": priority, "cooldownSeconds": 0,
            "backoffSeconds": 30,
            "template": {"apiVersion": "v1", "kind": "Node",
                         "metadata": {"labels": {
                             "node.kubernetes.io/instance-type":
                                 instance_type}},
                         "status": {"capacity": dict(caps),
                                    "allocatable": dict(caps)}}}


NODE_GROUP_DEFAULT = _node_group("perf-group", 50, 0, "perf-standard",
                                 "32", "128Gi", "110")
NODE_GROUP_LARGE = _node_group("perf-group-large", 20, 10, "perf-large",
                               "96", "384Gi", "250")


def _materialize(template: dict, count: int, prior: int = 0) -> list:
    """``scheduler_perf.materialize``'s createNodes/createPods: names are
    generateName + index (pods: + the list's prior length), nodes carry
    their hostname label."""
    import json
    from kubernetes_tpu_torch.api.types import Node, Pod
    out = []
    for i in range(count):
        d = json.loads(json.dumps(template))
        md = d.setdefault("metadata", {})
        prefix = md.pop("generateName")
        if d["kind"] == "Node":
            md["name"] = f"{prefix}{i}"
            md.setdefault("labels", {})["kubernetes.io/hostname"] = md["name"]
            out.append(Node.from_dict(d))
        else:
            md["name"] = f"{prefix}{prior}-{i}"
            out.append(Pod.from_dict(d))
    return out


def _round_robin(pods: list, nodes: list) -> None:
    for i, p in enumerate(pods):
        p.spec.node_name = nodes[i % len(nodes)].metadata.name


def autoscaler_scale_up(init_nodes: int = 1000, fill_pods: int = 1000,
                        pending_pods: int = 2000):
    """ClusterAutoscalerScaleUp/1000Nodes2000Pending
    (performance-config.yaml:128-156): node-default nodes, one
    pod-autoscaler-fill pod bound on each (round-robin), pod-default pods
    pending, and the node-group-default and node-group-large groups (as
    ``load_node_group`` dicts). -> (nodes, bound, pending, group dicts)."""
    nodes = _materialize(NODE_DEFAULT, init_nodes)
    bound = _materialize(POD_AUTOSCALER_FILL, fill_pods)
    _round_robin(bound, nodes)
    pending = _materialize(POD_DEFAULT, pending_pods)
    return nodes, bound, pending, [NODE_GROUP_DEFAULT, NODE_GROUP_LARGE]


def descheduler_defrag(init_nodes: int = 1000, fill_pods: int = 1000,
                       gang_pods: int = 100):
    """DeschedulerDefrag/1000Nodes100Gang (performance-config.yaml:158-185):
    node-default nodes, one pod-defrag-fill pod bound on each (12 of 32
    CPU), and a pending gang of pod-defrag-gang pods (24 CPU: no fragmented
    node hosts one). -> (nodes, bound, gang)."""
    nodes = _materialize(NODE_DEFAULT, init_nodes)
    bound = _materialize(POD_DEFRAG_FILL, fill_pods)
    _round_robin(bound, nodes)
    return nodes, bound, _materialize(POD_DEFRAG_GANG, gang_pods)


def planner_loop(n_nodes: int = 8, pods_per_node: int = 3):
    """``benchmarks/plannerloop.py``'s cluster: ``n_nodes`` group-labeled
    nodes of 8 CPU / 32Gi / 32 pods; pl-n0 holds ONE small pod (a
    persistent HighNodeUtilization candidate and a live scale-down proof),
    every other node ``pods_per_node`` pods of 2 CPU / 2Gi; two pods no
    node or template fits and a pending 3-pod gang; the node groups
    pool-a and pool-big (headroom 0). -> (nodes, bound, pending, groups),
    the groups as ``load_node_group`` dicts."""
    nodes = [make_node(f"pl-n{i}")
             .capacity({"cpu": "8", "memory": "32Gi", "pods": "32"})
             .label(NODE_GROUP_LABEL, "pool-a").obj()
             for i in range(n_nodes)]
    bound = [make_pod("pl-b0-0", "default")
             .req({"cpu": "1", "memory": "1Gi"}).node("pl-n0").obj()]
    for i in range(1, n_nodes):
        for j in range(pods_per_node):
            bound.append(make_pod(f"pl-b{i}-{j}", "default")
                         .req({"cpu": "2", "memory": "2Gi"})
                         .node(f"pl-n{i}").obj())
    pending = [make_pod(f"pl-big{k}", "default")
               .req({"cpu": "64", "memory": "128Gi"}).obj()
               for k in range(2)]
    pending += [make_pod(f"pl-g{k}", "default").req({"cpu": "6"})
                .label(GANG_LABEL, "pl-gang").obj() for k in range(3)]

    def group(name, max_size, cpu, memory, pods):
        caps = {"cpu": cpu, "memory": memory, "pods": pods}
        return {"name": name, "minSize": 0, "maxSize": max_size,
                "template": {"metadata": {
                                 "name": f"{name}-template",
                                 "labels": {"kubernetes.io/hostname":
                                            f"{name}-template"}},
                             "status": {"capacity": dict(caps),
                                        "allocatable": dict(caps)}}}

    groups = [group("pool-a", n_nodes + 4, "2", "4Gi", "16"),
              group("pool-big", 0, "96", "256Gi", "32")]
    return nodes, bound, pending, groups
