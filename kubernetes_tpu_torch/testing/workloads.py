"""Workload generators for the port: MixedHeterogeneous, copied from
``benchmarks/workloads.py`` so the port builds it without the JAX package,
``relational_mix``, the parity tests' small cluster,
``required_terms_mix``, its cluster under wide required pod (anti-)affinity,
and ``build_saturated``, the preemption cluster, copied from
``benchmarks/preemption_bench.py``.

Deterministic via seed: all randomness comes from its own
``random.Random(seed)``, so the same (params, seed) yields the same objects
as the reference generator.
"""

from __future__ import annotations

import random

from kubernetes_tpu_torch.api.types import (LabelSelector, PodAffinityTerm,
                                            Requirement)
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
