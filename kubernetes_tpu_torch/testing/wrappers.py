"""Fluent test wrappers — analog of ``pkg/scheduler/testing/wrappers.go``
(``st.MakePod()``, ``st.MakeNode()``). Used throughout the test suite and the
benchmark workload generator.
"""

from __future__ import annotations

from typing import Optional

from kubernetes_tpu_torch.api.types import (
    Affinity,
    Container,
    ContainerPort,
    LabelSelector,
    Node,
    NodeAffinity,
    NodeSelectorTerm,
    ObjectMeta,
    Pod,
    PodAffinity,
    PodAffinityTerm,
    PreferredSchedulingTerm,
    Requirement,
    Taint,
    Toleration,
    TopologySpreadConstraint,
    WeightedPodAffinityTerm,
)


class PodWrapper:
    def __init__(self, name: str = "pod", namespace: str = "default"):
        self.pod = Pod(metadata=ObjectMeta(name=name, namespace=namespace))
        self.pod.spec.containers = [Container(name="c0")]

    def obj(self) -> Pod:
        return self.pod

    def name(self, n: str) -> "PodWrapper":
        self.pod.metadata.name = n
        return self

    def namespace(self, ns: str) -> "PodWrapper":
        self.pod.metadata.namespace = ns
        return self

    def uid(self, uid: str) -> "PodWrapper":
        self.pod.metadata.uid = uid
        return self

    def label(self, k: str, v: str) -> "PodWrapper":
        self.pod.metadata.labels[k] = v
        return self

    def labels(self, d: dict[str, str]) -> "PodWrapper":
        self.pod.metadata.labels.update(d)
        return self

    def req(self, requests: dict[str, str]) -> "PodWrapper":
        """Resource requests on the first container (st.MakePod().Req)."""
        self.pod.spec.containers[0].requests.update(requests)
        return self

    def container_req(self, requests: dict[str, str]) -> "PodWrapper":
        self.pod.spec.containers.append(
            Container(name=f"c{len(self.pod.spec.containers)}", requests=dict(requests)))
        return self

    def init_req(self, requests: dict[str, str]) -> "PodWrapper":
        self.pod.spec.init_containers.append(
            Container(name=f"init{len(self.pod.spec.init_containers)}", requests=dict(requests)))
        return self

    def overhead(self, overhead: dict[str, str]) -> "PodWrapper":
        self.pod.spec.overhead.update(overhead)
        return self

    def node(self, node_name: str) -> "PodWrapper":
        self.pod.spec.node_name = node_name
        return self

    def node_selector(self, sel: dict[str, str]) -> "PodWrapper":
        self.pod.spec.node_selector.update(sel)
        return self

    def priority(self, p: int) -> "PodWrapper":
        self.pod.spec.priority = p
        return self

    def scheduler_name(self, n: str) -> "PodWrapper":
        self.pod.spec.scheduler_name = n
        return self

    def toleration(self, key: str = "", operator: str = "Equal", value: str = "",
                   effect: str = "") -> "PodWrapper":
        self.pod.spec.tolerations.append(
            Toleration(key=key, operator=operator, value=value, effect=effect))
        return self

    def host_port(self, port: int, protocol: str = "TCP", host_ip: str = "") -> "PodWrapper":
        self.pod.spec.containers[0].ports.append(
            ContainerPort(container_port=port, host_port=port, protocol=protocol, host_ip=host_ip))
        return self

    def image(self, image: str) -> "PodWrapper":
        self.pod.spec.containers[0].image = image
        return self

    def _affinity(self) -> Affinity:
        if self.pod.spec.affinity is None:
            self.pod.spec.affinity = Affinity()
        return self.pod.spec.affinity

    def node_affinity_in(self, key: str, values: list[str]) -> "PodWrapper":
        return self.node_affinity_expr(Requirement(key, "In", values))

    def node_affinity_expr(self, *exprs: Requirement) -> "PodWrapper":
        aff = self._affinity()
        if aff.node_affinity is None:
            aff.node_affinity = NodeAffinity()
        aff.node_affinity.required.append(NodeSelectorTerm(match_expressions=list(exprs)))
        return self

    def preferred_node_affinity(self, weight: int, *exprs: Requirement) -> "PodWrapper":
        aff = self._affinity()
        if aff.node_affinity is None:
            aff.node_affinity = NodeAffinity()
        aff.node_affinity.preferred.append(
            PreferredSchedulingTerm(weight=weight, preference=NodeSelectorTerm(match_expressions=list(exprs))))
        return self

    def _pod_affinity_target(self, anti: bool) -> PodAffinity:
        aff = self._affinity()
        target = aff.pod_anti_affinity if anti else aff.pod_affinity
        if target is None:
            target = PodAffinity()
            if anti:
                aff.pod_anti_affinity = target
            else:
                aff.pod_affinity = target
        return target

    def pod_affinity(self, topology_key: str, match_labels: dict[str, str],
                     anti: bool = False, namespaces: Optional[list] = None,
                     namespace_selector: Optional[dict] = None,
                     match_label_keys: Optional[list] = None,
                     mismatch_label_keys: Optional[list] = None) -> "PodWrapper":
        term = PodAffinityTerm(
            topology_key=topology_key,
            label_selector=LabelSelector(match_labels=dict(match_labels)),
            namespaces=list(namespaces or []),
            namespace_selector=(None if namespace_selector is None
                                else LabelSelector(match_labels=dict(namespace_selector))),
            match_label_keys=list(match_label_keys or []),
            mismatch_label_keys=list(mismatch_label_keys or []))
        self._pod_affinity_target(anti).required.append(term)
        return self

    def pod_anti_affinity(self, topology_key: str, match_labels: dict[str, str],
                          **kw) -> "PodWrapper":
        return self.pod_affinity(topology_key, match_labels, anti=True, **kw)

    def preferred_pod_affinity(self, weight: int, topology_key: str,
                               match_labels: dict[str, str], anti: bool = False) -> "PodWrapper":
        wterm = WeightedPodAffinityTerm(
            weight=weight,
            term=PodAffinityTerm(topology_key=topology_key,
                                 label_selector=LabelSelector(match_labels=dict(match_labels))))
        self._pod_affinity_target(anti).preferred.append(wterm)
        return self

    def spread(self, max_skew: int, topology_key: str, when_unsatisfiable: str,
               match_labels: Optional[dict[str, str]] = None,
               min_domains: Optional[int] = None,
               node_affinity_policy: str = "Honor",
               node_taints_policy: str = "Ignore",
               match_label_keys: Optional[list] = None) -> "PodWrapper":
        self.pod.spec.topology_spread_constraints.append(TopologySpreadConstraint(
            max_skew=max_skew, topology_key=topology_key, when_unsatisfiable=when_unsatisfiable,
            label_selector=LabelSelector(match_labels=dict(match_labels or {})),
            min_domains=min_domains, node_affinity_policy=node_affinity_policy,
            node_taints_policy=node_taints_policy,
            match_label_keys=list(match_label_keys or [])))
        return self

    def scheduling_gate(self, name: str) -> "PodWrapper":
        self.pod.spec.scheduling_gates.append(name)
        return self


class NodeWrapper:
    def __init__(self, name: str = "node"):
        self.node_obj = Node(metadata=ObjectMeta(name=name, namespace=""))
        self.node_obj.metadata.labels["kubernetes.io/hostname"] = name

    def obj(self) -> Node:
        return self.node_obj

    def name(self, n: str) -> "NodeWrapper":
        self.node_obj.metadata.name = n
        self.node_obj.metadata.labels["kubernetes.io/hostname"] = n
        return self

    def label(self, k: str, v: str) -> "NodeWrapper":
        self.node_obj.metadata.labels[k] = v
        return self

    def capacity(self, resources: dict[str, str]) -> "NodeWrapper":
        self.node_obj.status.capacity.update(resources)
        self.node_obj.status.allocatable.update(resources)
        return self

    def allocatable(self, resources: dict[str, str]) -> "NodeWrapper":
        self.node_obj.status.allocatable.update(resources)
        return self

    def taint(self, key: str, value: str = "", effect: str = "NoSchedule") -> "NodeWrapper":
        self.node_obj.spec.taints.append(Taint(key=key, value=value, effect=effect))
        return self

    def unschedulable(self, flag: bool = True) -> "NodeWrapper":
        self.node_obj.spec.unschedulable = flag
        return self

    def image(self, name: str, size_bytes: int) -> "NodeWrapper":
        from kubernetes_tpu_torch.api.types import ContainerImage
        self.node_obj.status.images.append(ContainerImage(names=[name], size_bytes=size_bytes))
        return self


def make_pod(name: str = "pod", namespace: str = "default") -> PodWrapper:
    return PodWrapper(name, namespace)


def make_node(name: str = "node") -> NodeWrapper:
    return NodeWrapper(name)
