"""Typed API objects — the subset of core/v1 the scheduler consumes.

Reference semantics: ``staging/src/k8s.io/api/core/v1/types.go`` (``Pod``,
``Node``, ``Affinity``, ``Toleration``, ``Taint``, ``TopologySpreadConstraint``).
Objects are plain dataclasses with ``from_dict``/``to_dict`` against the
Kubernetes JSON wire shape (camelCase), so YAML manifests written for the
reference parse unchanged. The store layer (etcd analog) persists raw dicts;
typed objects materialize at the informer boundary.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from kubernetes_tpu_torch.api.resource import canonical

_uid_counter = itertools.count(1)


def _gen_uid() -> str:
    return f"uid-{next(_uid_counter)}"


def _parse_time(v) -> Optional[float]:
    """Accept epoch numbers or RFC3339 strings ("2024-06-01T10:00:00Z")."""
    if v is None:
        return None
    if isinstance(v, (int, float)):
        return float(v)
    import datetime
    return datetime.datetime.fromisoformat(str(v).replace("Z", "+00:00")).timestamp()


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = field(default_factory=_gen_uid)
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    resource_version: str = ""
    creation_timestamp: float = field(default_factory=time.time)
    owner_references: list[dict[str, Any]] = field(default_factory=list)
    deletion_timestamp: Optional[float] = None
    finalizers: list[str] = field(default_factory=list)
    generation: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "ObjectMeta":
        return cls(
            name=d.get("name", ""),
            namespace=d.get("namespace", "default"),
            uid=d.get("uid") or _gen_uid(),
            labels=dict(d.get("labels") or {}),
            annotations=dict(d.get("annotations") or {}),
            resource_version=str(d.get("resourceVersion", "")),
            creation_timestamp=(_parse_time(d["creationTimestamp"])
                                if "creationTimestamp" in d else time.time()),
            owner_references=list(d.get("ownerReferences") or []),
            deletion_timestamp=_parse_time(d.get("deletionTimestamp")),
            finalizers=list(d.get("finalizers") or []),
            generation=int(d.get("generation", 0)),
        )

    def to_dict(self) -> dict:
        d: dict[str, Any] = {
            "name": self.name,
            "namespace": self.namespace,
            "uid": self.uid,
            "resourceVersion": self.resource_version,
            "creationTimestamp": self.creation_timestamp,
        }
        if self.labels:
            d["labels"] = dict(self.labels)
        if self.annotations:
            d["annotations"] = dict(self.annotations)
        if self.owner_references:
            d["ownerReferences"] = list(self.owner_references)
        if self.deletion_timestamp is not None:
            d["deletionTimestamp"] = self.deletion_timestamp
        if self.finalizers:
            d["finalizers"] = list(self.finalizers)
        if self.generation:
            d["generation"] = self.generation
        return d


# --------------------------------------------------------------------------
# Selectors / affinity
# --------------------------------------------------------------------------

# Node selector operators — reference: core/v1 NodeSelectorOperator.
OP_IN = "In"
OP_NOT_IN = "NotIn"
OP_EXISTS = "Exists"
OP_DOES_NOT_EXIST = "DoesNotExist"
OP_GT = "Gt"
OP_LT = "Lt"


@dataclass
class Requirement:
    """A single match expression (node selector or label selector flavor)."""

    key: str
    operator: str
    values: list[str] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict) -> "Requirement":
        return cls(key=d["key"], operator=d["operator"], values=list(d.get("values") or []))

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"key": self.key, "operator": self.operator}
        if self.values:
            d["values"] = list(self.values)
        return d


@dataclass
class NodeSelectorTerm:
    match_expressions: list[Requirement] = field(default_factory=list)
    # matchFields: selectors over node fields (in practice only metadata.name —
    # the daemonset pin-to-node shape).
    match_fields: list[Requirement] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict) -> "NodeSelectorTerm":
        return cls(
            match_expressions=[Requirement.from_dict(e) for e in d.get("matchExpressions") or []],
            match_fields=[Requirement.from_dict(e) for e in d.get("matchFields") or []],
        )

    def to_dict(self) -> dict:
        d: dict[str, Any] = {}
        if self.match_expressions:
            d["matchExpressions"] = [e.to_dict() for e in self.match_expressions]
        if self.match_fields:
            d["matchFields"] = [e.to_dict() for e in self.match_fields]
        return d


@dataclass
class PreferredSchedulingTerm:
    weight: int
    preference: NodeSelectorTerm

    @classmethod
    def from_dict(cls, d: dict) -> "PreferredSchedulingTerm":
        return cls(weight=int(d["weight"]), preference=NodeSelectorTerm.from_dict(d.get("preference") or {}))

    def to_dict(self) -> dict:
        return {"weight": self.weight, "preference": self.preference.to_dict()}


@dataclass
class NodeAffinity:
    # requiredDuringSchedulingIgnoredDuringExecution: OR of terms, each an AND of exprs.
    required: list[NodeSelectorTerm] = field(default_factory=list)
    preferred: list[PreferredSchedulingTerm] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict) -> "NodeAffinity":
        req = d.get("requiredDuringSchedulingIgnoredDuringExecution") or {}
        return cls(
            required=[NodeSelectorTerm.from_dict(t) for t in req.get("nodeSelectorTerms") or []],
            preferred=[PreferredSchedulingTerm.from_dict(t)
                       for t in d.get("preferredDuringSchedulingIgnoredDuringExecution") or []],
        )

    def to_dict(self) -> dict:
        d: dict[str, Any] = {}
        if self.required:
            d["requiredDuringSchedulingIgnoredDuringExecution"] = {
                "nodeSelectorTerms": [t.to_dict() for t in self.required]}
        if self.preferred:
            d["preferredDuringSchedulingIgnoredDuringExecution"] = [t.to_dict() for t in self.preferred]
        return d


@dataclass
class LabelSelector:
    """metav1.LabelSelector: matchLabels AND matchExpressions. None = match nothing
    (k8s: a nil selector matches no objects; an empty selector matches all)."""

    match_labels: dict[str, str] = field(default_factory=dict)
    match_expressions: list[Requirement] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> Optional["LabelSelector"]:
        if d is None:
            return None
        return cls(
            match_labels=dict(d.get("matchLabels") or {}),
            match_expressions=[Requirement.from_dict(e) for e in d.get("matchExpressions") or []],
        )

    def to_dict(self) -> dict:
        d: dict[str, Any] = {}
        if self.match_labels:
            d["matchLabels"] = dict(self.match_labels)
        if self.match_expressions:
            d["matchExpressions"] = [e.to_dict() for e in self.match_expressions]
        return d

    def requirements(self) -> list[Requirement]:
        """Fold matchLabels into In-requirements (k8s LabelSelectorAsSelector)."""
        reqs = [Requirement(k, OP_IN, [v]) for k, v in sorted(self.match_labels.items())]
        return reqs + list(self.match_expressions)


@dataclass
class PodAffinityTerm:
    """core/v1 PodAffinityTerm. ``namespaces`` + ``namespaceSelector`` pick the
    target namespaces (both empty/nil = the term-owning pod's own namespace; a
    set namespaceSelector ORs with the explicit list; an EMPTY selector {}
    matches all namespaces). ``matchLabelKeys``/``mismatchLabelKeys`` merge the
    owning pod's label values into the selector as In/NotIn requirements at
    scheduling time (MatchLabelKeysInPodAffinity)."""

    topology_key: str
    label_selector: Optional[LabelSelector] = None
    namespaces: list[str] = field(default_factory=list)  # empty = pod's own namespace
    namespace_selector: Optional[LabelSelector] = None
    match_label_keys: list[str] = field(default_factory=list)
    mismatch_label_keys: list[str] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict) -> "PodAffinityTerm":
        return cls(
            topology_key=d.get("topologyKey", ""),
            label_selector=LabelSelector.from_dict(d.get("labelSelector")),
            namespaces=list(d.get("namespaces") or []),
            namespace_selector=LabelSelector.from_dict(d.get("namespaceSelector")),
            match_label_keys=list(d.get("matchLabelKeys") or []),
            mismatch_label_keys=list(d.get("mismatchLabelKeys") or []),
        )

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"topologyKey": self.topology_key}
        if self.label_selector is not None:
            d["labelSelector"] = self.label_selector.to_dict()
        if self.namespaces:
            d["namespaces"] = list(self.namespaces)
        if self.namespace_selector is not None:
            d["namespaceSelector"] = self.namespace_selector.to_dict()
        if self.match_label_keys:
            d["matchLabelKeys"] = list(self.match_label_keys)
        if self.mismatch_label_keys:
            d["mismatchLabelKeys"] = list(self.mismatch_label_keys)
        return d


@dataclass
class WeightedPodAffinityTerm:
    weight: int
    term: PodAffinityTerm

    @classmethod
    def from_dict(cls, d: dict) -> "WeightedPodAffinityTerm":
        return cls(weight=int(d["weight"]), term=PodAffinityTerm.from_dict(d.get("podAffinityTerm") or {}))

    def to_dict(self) -> dict:
        return {"weight": self.weight, "podAffinityTerm": self.term.to_dict()}


@dataclass
class PodAffinity:
    required: list[PodAffinityTerm] = field(default_factory=list)
    preferred: list[WeightedPodAffinityTerm] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict) -> "PodAffinity":
        return cls(
            required=[PodAffinityTerm.from_dict(t)
                      for t in d.get("requiredDuringSchedulingIgnoredDuringExecution") or []],
            preferred=[WeightedPodAffinityTerm.from_dict(t)
                       for t in d.get("preferredDuringSchedulingIgnoredDuringExecution") or []],
        )

    def to_dict(self) -> dict:
        d: dict[str, Any] = {}
        if self.required:
            d["requiredDuringSchedulingIgnoredDuringExecution"] = [t.to_dict() for t in self.required]
        if self.preferred:
            d["preferredDuringSchedulingIgnoredDuringExecution"] = [t.to_dict() for t in self.preferred]
        return d


def with_added_node_affinity(pod: "Pod", added) -> "Pod":
    """Pod with a profile-level NodeAffinity folded in (NodeAffinityArgs.
    addedAffinity; reference ``pkg/scheduler/framework/plugins/nodeaffinity/
    node_affinity.go``): the pod must satisfy BOTH its own affinity and the
    added one. Required selectors are OR-of-terms, so AND of two selectors
    is the cross product of their term lists (each merged term carries both
    sides' expressions); preferred terms simply append. ``added``: a
    NodeAffinity or its wire dict. Returns a new Pod sharing every
    untouched subtree."""
    import dataclasses
    add = (added if isinstance(added, NodeAffinity)
           else NodeAffinity.from_dict(added))
    aff = pod.spec.affinity
    own = aff.node_affinity if aff else None
    if own is None or not own.required:
        req = list(add.required)
    elif not add.required:
        req = list(own.required)
    else:
        req = [NodeSelectorTerm(
            match_expressions=a.match_expressions + b.match_expressions,
            match_fields=a.match_fields + b.match_fields)
            for a in own.required for b in add.required]
    merged = NodeAffinity(
        required=req,
        preferred=(own.preferred if own else []) + list(add.preferred))
    new_aff = (dataclasses.replace(aff, node_affinity=merged) if aff
               else Affinity(node_affinity=merged))
    return dataclasses.replace(
        pod, spec=dataclasses.replace(pod.spec, affinity=new_aff))


@dataclass
class Affinity:
    node_affinity: Optional[NodeAffinity] = None
    pod_affinity: Optional[PodAffinity] = None
    pod_anti_affinity: Optional[PodAffinity] = None

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> Optional["Affinity"]:
        if not d:
            return None
        return cls(
            node_affinity=NodeAffinity.from_dict(d["nodeAffinity"]) if d.get("nodeAffinity") else None,
            pod_affinity=PodAffinity.from_dict(d["podAffinity"]) if d.get("podAffinity") else None,
            pod_anti_affinity=PodAffinity.from_dict(d["podAntiAffinity"]) if d.get("podAntiAffinity") else None,
        )

    def to_dict(self) -> dict:
        d: dict[str, Any] = {}
        if self.node_affinity is not None:
            d["nodeAffinity"] = self.node_affinity.to_dict()
        if self.pod_affinity is not None:
            d["podAffinity"] = self.pod_affinity.to_dict()
        if self.pod_anti_affinity is not None:
            d["podAntiAffinity"] = self.pod_anti_affinity.to_dict()
        return d


# --------------------------------------------------------------------------
# Taints / tolerations
# --------------------------------------------------------------------------

EFFECT_NO_SCHEDULE = "NoSchedule"
EFFECT_PREFER_NO_SCHEDULE = "PreferNoSchedule"
EFFECT_NO_EXECUTE = "NoExecute"

TOL_OP_EXISTS = "Exists"
TOL_OP_EQUAL = "Equal"


@dataclass
class Taint:
    key: str
    value: str = ""
    effect: str = EFFECT_NO_SCHEDULE

    @classmethod
    def from_dict(cls, d: dict) -> "Taint":
        return cls(key=d["key"], value=d.get("value", ""), effect=d.get("effect", EFFECT_NO_SCHEDULE))

    def to_dict(self) -> dict:
        return {"key": self.key, "value": self.value, "effect": self.effect}


@dataclass
class Toleration:
    key: str = ""  # empty key + Exists tolerates everything
    operator: str = TOL_OP_EQUAL
    value: str = ""
    effect: str = ""  # empty = all effects
    toleration_seconds: Optional[int] = None

    @classmethod
    def from_dict(cls, d: dict) -> "Toleration":
        return cls(
            key=d.get("key", ""),
            operator=d.get("operator", TOL_OP_EQUAL),
            value=d.get("value", ""),
            effect=d.get("effect", ""),
            toleration_seconds=d.get("tolerationSeconds"),
        )

    def to_dict(self) -> dict:
        d: dict[str, Any] = {}
        if self.key:
            d["key"] = self.key
        d["operator"] = self.operator
        if self.value:
            d["value"] = self.value
        if self.effect:
            d["effect"] = self.effect
        if self.toleration_seconds is not None:
            d["tolerationSeconds"] = self.toleration_seconds
        return d

    def tolerates(self, taint: Taint) -> bool:
        """Reference: staging/src/k8s.io/api/core/v1/toleration.go (ToleratesTaint)."""
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        if self.operator == TOL_OP_EXISTS:
            return True
        return self.value == taint.value


# --------------------------------------------------------------------------
# Topology spread
# --------------------------------------------------------------------------

UNSATISFIABLE_DO_NOT_SCHEDULE = "DoNotSchedule"
UNSATISFIABLE_SCHEDULE_ANYWAY = "ScheduleAnyway"


NODE_INCLUSION_HONOR = "Honor"
NODE_INCLUSION_IGNORE = "Ignore"


@dataclass
class TopologySpreadConstraint:
    """core/v1 TopologySpreadConstraint. ``min_domains`` (DoNotSchedule only):
    if fewer eligible domains exist, the global minimum is treated as 0.
    ``node_affinity_policy``/``node_taints_policy`` control whether nodes
    failing the pod's nodeSelector/nodeAffinity (default: Honor = excluded)
    or carrying untolerated taints (default: Ignore = included) count when
    computing skew. ``match_label_keys`` merge the pod's own label values
    into the selector as In requirements."""

    max_skew: int
    topology_key: str
    when_unsatisfiable: str = UNSATISFIABLE_DO_NOT_SCHEDULE
    label_selector: Optional[LabelSelector] = None
    min_domains: Optional[int] = None
    node_affinity_policy: str = NODE_INCLUSION_HONOR
    node_taints_policy: str = NODE_INCLUSION_IGNORE
    match_label_keys: list[str] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict) -> "TopologySpreadConstraint":
        md = d.get("minDomains")
        return cls(
            max_skew=int(d.get("maxSkew", 1)),
            topology_key=d.get("topologyKey", ""),
            when_unsatisfiable=d.get("whenUnsatisfiable", UNSATISFIABLE_DO_NOT_SCHEDULE),
            label_selector=LabelSelector.from_dict(d.get("labelSelector")),
            min_domains=int(md) if md is not None else None,
            node_affinity_policy=d.get("nodeAffinityPolicy", NODE_INCLUSION_HONOR),
            node_taints_policy=d.get("nodeTaintsPolicy", NODE_INCLUSION_IGNORE),
            match_label_keys=list(d.get("matchLabelKeys") or []),
        )

    def to_dict(self) -> dict:
        d: dict[str, Any] = {
            "maxSkew": self.max_skew,
            "topologyKey": self.topology_key,
            "whenUnsatisfiable": self.when_unsatisfiable,
        }
        if self.label_selector is not None:
            d["labelSelector"] = self.label_selector.to_dict()
        if self.min_domains is not None:
            d["minDomains"] = self.min_domains
        if self.node_affinity_policy != NODE_INCLUSION_HONOR:
            d["nodeAffinityPolicy"] = self.node_affinity_policy
        if self.node_taints_policy != NODE_INCLUSION_IGNORE:
            d["nodeTaintsPolicy"] = self.node_taints_policy
        if self.match_label_keys:
            d["matchLabelKeys"] = list(self.match_label_keys)
        return d


# --------------------------------------------------------------------------
# Pod
# --------------------------------------------------------------------------


@dataclass
class ContainerPort:
    container_port: int = 0
    host_port: int = 0
    protocol: str = "TCP"
    host_ip: str = ""

    @classmethod
    def from_dict(cls, d: dict) -> "ContainerPort":
        return cls(
            container_port=int(d.get("containerPort", 0)),
            host_port=int(d.get("hostPort", 0)),
            protocol=d.get("protocol", "TCP"),
            host_ip=d.get("hostIP", ""),
        )

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"containerPort": self.container_port, "protocol": self.protocol}
        if self.host_port:
            d["hostPort"] = self.host_port
        if self.host_ip:
            d["hostIP"] = self.host_ip
        return d


@dataclass
class Container:
    name: str = "c"
    image: str = ""
    requests: dict[str, Any] = field(default_factory=dict)  # resource -> quantity
    limits: dict[str, Any] = field(default_factory=dict)
    ports: list[ContainerPort] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict) -> "Container":
        res = d.get("resources") or {}
        return cls(
            name=d.get("name", "c"),
            image=d.get("image", ""),
            requests=dict(res.get("requests") or {}),
            limits=dict(res.get("limits") or {}),
            ports=[ContainerPort.from_dict(p) for p in d.get("ports") or []],
        )

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"name": self.name}
        if self.image:
            d["image"] = self.image
        res: dict[str, Any] = {}
        if self.requests:
            res["requests"] = dict(self.requests)
        if self.limits:
            res["limits"] = dict(self.limits)
        if res:
            d["resources"] = res
        if self.ports:
            d["ports"] = [p.to_dict() for p in self.ports]
        return d


@dataclass
class PodSpec:
    node_name: str = ""
    scheduler_name: str = "default-scheduler"
    node_selector: dict[str, str] = field(default_factory=dict)
    affinity: Optional[Affinity] = None
    tolerations: list[Toleration] = field(default_factory=list)
    containers: list[Container] = field(default_factory=list)
    init_containers: list[Container] = field(default_factory=list)
    priority: int = 0
    priority_class_name: str = ""
    topology_spread_constraints: list[TopologySpreadConstraint] = field(default_factory=list)
    scheduling_gates: list[str] = field(default_factory=list)
    overhead: dict[str, Any] = field(default_factory=dict)
    restart_policy: str = "Always"
    volumes: list[dict[str, Any]] = field(default_factory=list)
    # DRA (resource.k8s.io): [{"name", "resourceClaimName" |
    # "resourceClaimTemplateName"}] — pod-level device claims
    resource_claims: list[dict[str, Any]] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict) -> "PodSpec":
        return cls(
            node_name=d.get("nodeName", ""),
            scheduler_name=d.get("schedulerName", "default-scheduler"),
            node_selector=dict(d.get("nodeSelector") or {}),
            affinity=Affinity.from_dict(d.get("affinity")),
            tolerations=[Toleration.from_dict(t) for t in d.get("tolerations") or []],
            containers=[Container.from_dict(c) for c in d.get("containers") or []],
            init_containers=[Container.from_dict(c) for c in d.get("initContainers") or []],
            priority=int(d.get("priority", 0) or 0),
            priority_class_name=d.get("priorityClassName", ""),
            topology_spread_constraints=[TopologySpreadConstraint.from_dict(t)
                                         for t in d.get("topologySpreadConstraints") or []],
            scheduling_gates=[g.get("name", "") if isinstance(g, dict) else str(g)
                              for g in d.get("schedulingGates") or []],
            overhead=dict(d.get("overhead") or {}),
            restart_policy=d.get("restartPolicy", "Always"),
            volumes=list(d.get("volumes") or []),
            resource_claims=list(d.get("resourceClaims") or []),
        )

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"schedulerName": self.scheduler_name,
                             "restartPolicy": self.restart_policy}
        if self.node_name:
            d["nodeName"] = self.node_name
        if self.node_selector:
            d["nodeSelector"] = dict(self.node_selector)
        if self.affinity is not None:
            d["affinity"] = self.affinity.to_dict()
        if self.tolerations:
            d["tolerations"] = [t.to_dict() for t in self.tolerations]
        d["containers"] = [c.to_dict() for c in self.containers]
        if self.init_containers:
            d["initContainers"] = [c.to_dict() for c in self.init_containers]
        if self.priority:
            d["priority"] = self.priority
        if self.priority_class_name:
            d["priorityClassName"] = self.priority_class_name
        if self.topology_spread_constraints:
            d["topologySpreadConstraints"] = [t.to_dict() for t in self.topology_spread_constraints]
        if self.scheduling_gates:
            d["schedulingGates"] = [{"name": g} for g in self.scheduling_gates]
        if self.overhead:
            d["overhead"] = dict(self.overhead)
        if self.volumes:
            d["volumes"] = list(self.volumes)
        if self.resource_claims:
            d["resourceClaims"] = list(self.resource_claims)
        return d


@dataclass
class PodStatus:
    phase: str = "Pending"
    nominated_node_name: str = ""
    conditions: list[dict[str, Any]] = field(default_factory=list)
    start_time: Optional[float] = None
    pod_ip: str = ""
    host_ip: str = ""

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "PodStatus":
        d = d or {}
        return cls(
            phase=d.get("phase", "Pending"),
            nominated_node_name=d.get("nominatedNodeName", ""),
            conditions=list(d.get("conditions") or []),
            start_time=d.get("startTime"),
            pod_ip=d.get("podIP", ""),
            host_ip=d.get("hostIP", ""),
        )

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"phase": self.phase}
        if self.nominated_node_name:
            d["nominatedNodeName"] = self.nominated_node_name
        if self.conditions:
            d["conditions"] = list(self.conditions)
        if self.start_time is not None:
            d["startTime"] = self.start_time
        if self.pod_ip:
            d["podIP"] = self.pod_ip
        if self.host_ip:
            d["hostIP"] = self.host_ip
        return d

    def is_ready(self) -> bool:
        """PodReady condition True (pkg/api/v1/pod/util.go IsPodReady)."""
        return any(c.get("type") == "Ready" and c.get("status") == "True"
                   for c in self.conditions)


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    @classmethod
    def from_dict(cls, d: dict) -> "Pod":
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            spec=PodSpec.from_dict(d.get("spec") or {}),
            status=PodStatus.from_dict(d.get("status")),
        )

    def to_dict(self) -> dict:
        return {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": self.metadata.to_dict(),
            "spec": self.spec.to_dict(),
            "status": self.status.to_dict(),
        }

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    def resource_requests(self) -> dict[str, int]:
        """Effective scheduling requests in canonical units.

        Reference: pkg/api/v1/resource/helpers.go (PodRequests) —
        max(sum(containers), max(initContainers)) + overhead, plus the
        implicit "pods" resource (each pod consumes 1 slot).

        Memoized per instance: quantity-string parsing dominated fleet-scale
        host paths (every encode/oracle/preemption pass re-parsed every
        pod). Requests are spec-immutable upstream, and every mutation path
        here builds a fresh Pod (informers, dataclasses.replace), so the
        cache lives exactly as long as it is valid. Callers treat the
        result as read-only.
        """
        cached = self.__dict__.get("_requests_cache")
        if cached is not None:
            return cached
        total: dict[str, int] = {}
        for c in self.containers_all(init=False):
            for r, q in c.requests.items():
                total[r] = total.get(r, 0) + canonical(r, q)
        for c in self.spec.init_containers:
            for r, q in c.requests.items():
                total[r] = max(total.get(r, 0), canonical(r, q))
        for r, q in self.spec.overhead.items():
            total[r] = total.get(r, 0) + canonical(r, q)
        total["pods"] = 1
        self.__dict__["_requests_cache"] = total
        return total

    def containers_all(self, init: bool = True) -> list[Container]:
        return (self.spec.init_containers if init else []) + self.spec.containers

    def pvc_names(self) -> list[str]:
        """claimNames of persistentVolumeClaim volumes, in spec order."""
        return [v["persistentVolumeClaim"]["claimName"]
                for v in self.spec.volumes
                if isinstance(v.get("persistentVolumeClaim"), dict)
                and v["persistentVolumeClaim"].get("claimName")]

    def host_ports(self) -> list[tuple[str, str, int]]:
        """(hostIP, protocol, hostPort) triples with hostPort != 0."""
        out = []
        for c in self.spec.containers:
            for p in c.ports:
                if p.host_port:
                    out.append((p.host_ip or "0.0.0.0", p.protocol or "TCP", p.host_port))
        return out


# --------------------------------------------------------------------------
# Node
# --------------------------------------------------------------------------


@dataclass
class ContainerImage:
    names: list[str] = field(default_factory=list)
    size_bytes: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "ContainerImage":
        return cls(names=list(d.get("names") or []), size_bytes=int(d.get("sizeBytes", 0)))

    def to_dict(self) -> dict:
        return {"names": list(self.names), "sizeBytes": self.size_bytes}


@dataclass
class NodeSpec:
    unschedulable: bool = False
    taints: list[Taint] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "NodeSpec":
        d = d or {}
        return cls(
            unschedulable=bool(d.get("unschedulable", False)),
            taints=[Taint.from_dict(t) for t in d.get("taints") or []],
        )

    def to_dict(self) -> dict:
        d: dict[str, Any] = {}
        if self.unschedulable:
            d["unschedulable"] = True
        if self.taints:
            d["taints"] = [t.to_dict() for t in self.taints]
        return d


@dataclass
class NodeStatus:
    allocatable: dict[str, Any] = field(default_factory=dict)
    capacity: dict[str, Any] = field(default_factory=dict)
    images: list[ContainerImage] = field(default_factory=list)
    conditions: list[dict[str, Any]] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "NodeStatus":
        d = d or {}
        return cls(
            allocatable=dict(d.get("allocatable") or {}),
            capacity=dict(d.get("capacity") or {}),
            images=[ContainerImage.from_dict(i) for i in d.get("images") or []],
            conditions=list(d.get("conditions") or []),
        )

    def to_dict(self) -> dict:
        d: dict[str, Any] = {}
        if self.allocatable:
            d["allocatable"] = dict(self.allocatable)
        if self.capacity:
            d["capacity"] = dict(self.capacity)
        if self.images:
            d["images"] = [i.to_dict() for i in self.images]
        if self.conditions:
            d["conditions"] = list(self.conditions)
        return d


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)

    @classmethod
    def from_dict(cls, d: dict) -> "Node":
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            spec=NodeSpec.from_dict(d.get("spec")),
            status=NodeStatus.from_dict(d.get("status")),
        )

    def to_dict(self) -> dict:
        return {
            "apiVersion": "v1",
            "kind": "Node",
            "metadata": self.metadata.to_dict(),
            "spec": self.spec.to_dict(),
            "status": self.status.to_dict(),
        }

    @property
    def name(self) -> str:
        return self.metadata.name

    def allocatable_canonical(self) -> dict[str, int]:
        return {r: canonical(r, q) for r, q in self.status.allocatable.items()}


def deep_copy(obj):
    """Structural copy of a dataclass tree (runtime.Object.DeepCopyObject analog)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return type(obj)(**{f.name: deep_copy(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: deep_copy(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [deep_copy(v) for v in obj]
    return obj
