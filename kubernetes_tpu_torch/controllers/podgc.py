"""Pod garbage collector.

Reference: ``pkg/controller/podgc/gc_controller.go``: periodically delete
(a) terminated pods beyond ``terminatedPodThreshold`` (oldest first;
upstream kube-controller-manager defaults the threshold to 12500),
(b) orphaned pods bound to nodes that no longer exist, and (c) unscheduled
pods that are terminating (deletionTimestamp set, no node).

Safety deviations that matter:
- Orphan deletion requires BOTH a quarantine period (upstream's
  ``quarantineTime`` ~40s) and a live apiserver GET confirming the node is
  really gone — a stale or unsynced informer cache must never mass-delete
  healthy pods.
- The terminated sweep skips pods still owned by a controller: Job
  completion counting here recounts live pods (no job-tracking finalizers),
  so reaping a Job's Succeeded pods would erase completed work. Owned
  terminated pods are the TTL / cascade controllers' jurisdiction.
"""

from __future__ import annotations

import time

from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.controllers.base import Controller, controller_of


class PodGCController(Controller):
    name = "podgc"
    workers = 1
    tick_interval = 2.0  # upstream gcCheckPeriod 20s

    def __init__(self, client, terminated_threshold: int = 12500,
                 quarantine_s: float = 40.0):
        super().__init__(client)
        self.terminated_threshold = terminated_threshold
        self.quarantine_s = quarantine_s
        # node name -> first time the informer reported it missing
        self._missing_since: dict[str, float] = {}

    def register(self, factory: InformerFactory) -> None:
        self.pod_informer = factory.informer("pods", None)
        self.node_informer = factory.informer("nodes", None)

    def sync(self, key: str) -> None:
        pass  # purely tick-driven (upstream runs gc() on a timer, no queue)

    def tick(self) -> None:
        pods = self.pod_informer.store.list()
        nodes = {(n.get("metadata") or {}).get("name", "")
                 for n in self.node_informer.store.list()}
        self._gc_terminated(pods)
        self._gc_orphaned(pods, nodes)
        self._gc_unscheduled_terminating(pods)

    def _delete(self, pod: dict) -> None:
        md = pod.get("metadata") or {}
        try:
            self.client.pods(md.get("namespace", "default")).delete(
                md.get("name", ""))
        except ApiError as e:
            if e.code != 404:
                raise

    def _gc_terminated(self, pods: list[dict]) -> None:
        """Reap the oldest UNOWNED terminated pods beyond the threshold."""
        if self.terminated_threshold <= 0:
            return
        terminated = [p for p in pods
                      if (p.get("status") or {}).get("phase")
                      in ("Succeeded", "Failed")
                      and controller_of(p) is None]
        excess = len(terminated) - self.terminated_threshold
        if excess <= 0:
            return

        def created(p):
            return (p.get("metadata") or {}).get("creationTimestamp") or 0
        for p in sorted(terminated, key=created)[:excess]:
            self._delete(p)

    def _node_really_gone(self, name: str) -> bool:
        """Quarantine + live confirmation (gcOrphaned's discoverDeletedNodes):
        the informer's absence must persist for quarantine_s AND the
        apiserver itself must 404 the node."""
        now = time.time()
        since = self._missing_since.setdefault(name, now)
        if now - since < self.quarantine_s:
            return False
        try:
            self.client.nodes().get(name)
            return False  # cache was stale; the node exists
        except ApiError as e:
            return e.code == 404
        except Exception:  # ktpu-lint: disable=KTL002 -- apiserver unreachable: never delete on doubt (the fallback IS the safety decision)
            return False  # apiserver unreachable: never delete on doubt

    def _gc_orphaned(self, pods: list[dict], nodes: set) -> None:
        """Pods bound to a node that no longer exists (gcOrphaned)."""
        bound_to = {(p.get("spec") or {}).get("nodeName", "") for p in pods}
        for name in list(self._missing_since):
            if name in nodes or name not in bound_to:
                del self._missing_since[name]  # reappeared / nothing bound
        for p in pods:
            node = (p.get("spec") or {}).get("nodeName", "")
            if node and node not in nodes and self._node_really_gone(node):
                self._delete(p)

    def _gc_unscheduled_terminating(self, pods: list[dict]) -> None:
        """Terminating pods that never got a node (gcUnscheduledTerminating)."""
        for p in pods:
            md = p.get("metadata") or {}
            if md.get("deletionTimestamp") and \
                    not (p.get("spec") or {}).get("nodeName"):
                self._delete(p)
