"""Node groups — the cloudprovider.NodeGroup abstraction.

Reference: ``cluster-autoscaler/cloudprovider/cloud_provider.go``
(``NodeGroup``: MinSize/MaxSize/TargetSize/IncreaseSize/DeleteNodes +
``TemplateNodeInfo`` for groups that can scale from zero). Two providers:

  StaticNodeGroupProvider  pure API objects — creates Node objects through
                           the apiserver with no kubelet behind them
                           (integration tests, benchmarks).
  HollowNodeGroupProvider  provisions hollow-kubelet nodes (kubemark) so
                           scaled-up capacity heartbeats, admits, and runs
                           pods like the rest of the fleet.

The PyTorch port of ``kubernetes_tpu/autoscaler/nodegroup.py``. kubemark
is not ported (ROADMAP Queue A item 15): ``HollowNodeGroupProvider``
raises at construction.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Optional

from kubernetes_tpu_torch.api.types import Node

# every provisioned node carries its group here (the reference reads the
# analogous cloud-provider tag to map nodes back to groups)
NODE_GROUP_LABEL = "kubernetes-tpu.io/node-group"


@dataclass
class NodeGroup:
    """One scalable pool of identical nodes."""

    name: str
    min_size: int
    max_size: int
    template: Node                      # shape of every node this group adds
    priority: int = 0                   # priority expander rank (higher wins)
    cooldown_s: float = 0.0             # min gap between scale-ups
    backoff_s: float = 30.0             # hold-off after a failed provision
    # tenant-scoped pool: templates stamp the tenant label, so a scale-up
    # simulation for tenant A's pending pods only matches A's templates
    # (the tenant-pair filter vetoes cross-tenant placements device-side
    # and cold-side identically)
    tenant: Optional[str] = None
    # DRA device classes this group's nodes expose: class -> device count.
    # Stamped as dra:<class> allocatable, so scale-up simulation answers
    # claim-carrying pending pods — a group without the device never looks
    # like relief for a pod that needs it.
    device_capacity: dict = field(default_factory=dict)

    def template_node(self, node_name: str) -> Node:
        """A concrete Node stamped from the template (labels copied so the
        caller can't alias the template's dicts)."""
        import dataclasses
        from kubernetes_tpu_torch.encode.snapshot import TENANT_LABEL
        labels = {**self.template.metadata.labels,
                  "kubernetes.io/hostname": node_name,
                  NODE_GROUP_LABEL: self.name}
        if self.tenant:
            labels[TENANT_LABEL] = self.tenant
        meta = dataclasses.replace(
            self.template.metadata, name=node_name, labels=labels)
        node = dataclasses.replace(self.template, metadata=meta)
        if self.device_capacity:
            alloc = dict(node.status.allocatable)
            for cls, count in self.device_capacity.items():
                alloc[f"dra:{cls}"] = str(count)
            node = dataclasses.replace(
                node, status=dataclasses.replace(node.status,
                                                 allocatable=alloc))
        return node


def load_node_group(d: dict) -> NodeGroup:
    """NodeGroup from its YAML/dict shape (benchmarks/config/templates)."""
    return NodeGroup(
        name=d["name"],
        min_size=int(d.get("minSize", 0)),
        max_size=int(d.get("maxSize", 1)),
        template=Node.from_dict(d["template"]),
        priority=int(d.get("priority", 0)),
        cooldown_s=float(d.get("cooldownSeconds", 0.0)),
        backoff_s=float(d.get("backoffSeconds", 30.0)),
        tenant=d.get("tenant") or None,
        device_capacity={str(k): int(v)
                         for k, v in (d.get("deviceCapacity") or {}).items()},
    )


class NodeGroupProvider:
    """Provider base: group registry + provisioned-node bookkeeping.

    Subclasses implement ``_provision``/``_deprovision``; size accounting,
    name allocation, and group lookup live here.
    """

    def __init__(self, groups: list[NodeGroup]):
        self._groups = {g.name: g for g in groups}
        self._members: dict[str, set[str]] = {g.name: set() for g in groups}
        self._seq = itertools.count()
        self._lock = threading.Lock()

    def groups(self) -> list[NodeGroup]:
        return list(self._groups.values())

    def group(self, name: str) -> Optional[NodeGroup]:
        return self._groups.get(name)

    def target_size(self, name: str) -> int:
        with self._lock:
            return len(self._members.get(name, ()))

    def group_of(self, node_name: str) -> Optional[str]:
        with self._lock:
            for g, members in self._members.items():
                if node_name in members:
                    return g
        return None

    def adopt(self, name: str, node_names: list[str]) -> None:
        """Record pre-existing nodes as group members (a restarted
        autoscaler re-adopts its fleet from the group label)."""
        with self._lock:
            self._members.setdefault(name, set()).update(node_names)

    def scale_up(self, name: str, delta: int) -> list[str]:
        """Provision ``delta`` nodes (clamped to max_size). Returns the new
        node names; raises on provision failure (caller backs the group
        off)."""
        group = self._groups[name]
        with self._lock:
            room = group.max_size - len(self._members[name])
            n = max(0, min(delta, room))
            names = [f"{name}-{next(self._seq)}" for _ in range(n)]
            self._members[name].update(names)
        if not names:
            return []
        try:
            self._provision(group, names)
        except Exception:
            with self._lock:
                self._members[name] -= set(names)
            raise
        return names

    def scale_down(self, name: str, node_names: list[str]) -> None:
        group = self._groups[name]
        self._deprovision(group, node_names)
        with self._lock:
            self._members[name] -= set(node_names)

    # -- subclass surface --------------------------------------------------

    def _provision(self, group: NodeGroup, names: list[str]) -> None:
        raise NotImplementedError

    def _deprovision(self, group: NodeGroup, names: list[str]) -> None:
        raise NotImplementedError


class StaticNodeGroupProvider(NodeGroupProvider):
    """API-object-only provider: nodes exist but nothing runs their pods.
    Marks fresh nodes Ready so the scheduler's view matches a cloud node
    that registered (integration tests fake readiness the same way)."""

    def __init__(self, client, groups: list[NodeGroup]):
        super().__init__(groups)
        self.client = client

    def _provision(self, group: NodeGroup, names: list[str]) -> None:
        objs = []
        for name in names:
            d = group.template_node(name).to_dict()
            d.setdefault("status", {})["conditions"] = [
                {"type": "Ready", "status": "True"}]
            objs.append(d)
        self.client.nodes().create_many(objs)

    def _deprovision(self, group: NodeGroup, names: list[str]) -> None:
        from kubernetes_tpu_torch.client.clientset import ApiError
        for name in names:
            try:
                self.client.nodes().delete(name)
            except ApiError as e:
                if e.code != 404:
                    raise


class HollowNodeGroupProvider(NodeGroupProvider):
    """Each scale-up would add hollow kubelets (kubemark) to a dynamic
    HollowCluster. kubemark is ROADMAP Queue A item 15: construction
    raises until it is ported."""

    def __init__(self, client, groups: list[NodeGroup],
                 heartbeat_period: float = 5.0):
        from kubernetes_tpu_torch.config.types import not_ported
        raise not_ported("HollowNodeGroupProvider (kubemark)", "15")
