"""TTL controller — size-tiered node annotation for secret/configmap TTLs.

Reference: ``pkg/controller/ttl/ttl_controller.go``: annotate every node
with ``node.alpha.kubernetes.io/ttl`` according to cluster size, so
kubelets cache secrets/configmaps longer in big clusters (0s <=100 nodes,
15s <=500, 30s <=1000, 60s <=2000, 300s above — upstream's ttlBoundaries).
"""

from __future__ import annotations

from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.controllers.base import Controller

TTL_ANNOTATION = "node.alpha.kubernetes.io/ttl"
# (max cluster size, ttl seconds) — ttl_controller.go ttlBoundaries
_BOUNDARIES = ((100, 0), (500, 15), (1000, 30), (2000, 60))
_MAX_TTL = 300


class TTLController(Controller):
    name = "ttl"
    workers = 1

    def register(self, factory: InformerFactory) -> None:
        self.node_informer = factory.informer("nodes", None)
        self._last_ttl: int | None = None
        self.node_informer.add_event_handler(self._on_node)

    def _on_node(self, type_, obj, old) -> None:
        if type_ in ("ADDED", "DELETED"):
            # the fleet is re-enqueued only when the cluster-size TIER
            # changes (ttl_controller enqueues everything on boundary
            # crossings, not on every membership event — at fleet scale
            # per-event fan-out is O(N^2))
            ttl = self._desired_ttl()
            if ttl != self._last_ttl:
                self._last_ttl = ttl
                for n in self.node_informer.store.list():
                    self.enqueue(n)
                return
        if type_ != "DELETED":
            self.enqueue(obj)

    def _desired_ttl(self) -> int:
        n = len(self.node_informer.store)
        for bound, ttl in _BOUNDARIES:
            if n <= bound:
                return ttl
        return _MAX_TTL

    def sync(self, key: str) -> None:
        res = self.client.resource("nodes", None)
        try:
            node = res.get(key)
        except ApiError as e:
            if e.code == 404:
                return
            raise
        want = str(self._desired_ttl())
        ann = (node.get("metadata") or {}).get("annotations") or {}
        if ann.get(TTL_ANNOTATION) == want:
            return
        node.setdefault("metadata", {}).setdefault(
            "annotations", {})[TTL_ANNOTATION] = want
        try:
            res.update(node)
        except ApiError as e:
            if e.code not in (404, 409):
                raise
