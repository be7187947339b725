"""Disruption controller — keep PodDisruptionBudget status current.

Reference: ``pkg/controller/disruption/disruption.go`` (``trySync`` /
``updatePdbStatus``: count matching healthy pods, derive desiredHealthy from
minAvailable / maxUnavailable, publish disruptionsAllowed). The eviction
subresource reads these budgets (store/apiserver.py) and the scheduler's
preemption prefers victims whose budgets still allow disruption
(sched/preemption.py).
"""

from __future__ import annotations

from kubernetes_tpu_torch.api.policy import compute_pdb_status
from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.controllers.base import Controller, split_key


class DisruptionController(Controller):
    name = "disruption"

    def register(self, factory: InformerFactory) -> None:
        self.pdb_informer = factory.informer("poddisruptionbudgets", None)
        self.pdb_informer.add_event_handler(self.handler())
        self.pod_informer = factory.informer("pods", None)
        self.pod_informer.add_event_handler(self.handler(self._enqueue_pdbs))

    def _enqueue_pdbs(self, pod: dict) -> None:
        # getPdbsForPod: only budgets whose selector covers this pod resync
        # (a bind storm must not turn PDB maintenance quadratic)
        from kubernetes_tpu_torch.api.policy import _matches
        md = pod.get("metadata") or {}
        ns = md.get("namespace", "")
        labels = md.get("labels") or {}
        for pdb in self.pdb_informer.store.list():
            if (pdb.get("metadata") or {}).get("namespace", "") != ns:
                continue
            if _matches((pdb.get("spec") or {}).get("selector"), labels):
                self.enqueue(pdb)

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        pdb = self.pdb_informer.store.get(key)
        if pdb is None:
            return
        pods = [p for p in self.pod_informer.store.list()
                if (p.get("metadata") or {}).get("namespace", "") == ns]
        status = compute_pdb_status(pdb, pods)
        if (pdb.get("status") or {}) == status:
            return
        desired = dict(pdb)
        desired["status"] = status
        try:
            self.client.resource("poddisruptionbudgets", ns).update_status(desired)
        except ApiError as e:
            if e.code not in (404, 409):  # deleted / raced: requeue later
                raise
