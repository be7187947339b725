"""ResourceQuota controller — keep quota status.used in sync with reality.

Reference: ``pkg/controller/resourcequota/resource_quota_controller.go``:
the admission plugin ENFORCES quota at write time (store/admission.py
``resource_quota``); this controller RECALCULATES ``status.used`` from live
objects so users (and the admission fast path upstream) see current usage —
on quota add/update, on a full resync tick, and when pods churn.

Usage model mirrored from ``pkg/quota/v1/evaluator/core``: non-terminal
pods contribute ``pods``, ``requests.cpu``, ``requests.memory`` (and bare
``cpu``/``memory`` aliases); ``count/<plural>`` tracks object counts for
the common namespaced kinds served here.
"""

from __future__ import annotations

from kubernetes_tpu_torch.api.resource import canonical
from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.client.informer import InformerFactory, meta_namespace_key
from kubernetes_tpu_torch.controllers.base import Controller

_COUNTED = {"count/configmaps": "configmaps", "count/secrets": "secrets",
            "count/services": "services",
            "count/persistentvolumeclaims": "persistentvolumeclaims",
            "count/replicationcontrollers": "replicationcontrollers",
            "count/deployments.apps": "deployments",
            "count/jobs.batch": "jobs"}


def _fmt(resource: str, amount: int) -> str:
    """Canonical units back to wire quantities (cpu millis -> 'Nm')."""
    key = resource.split("requests.", 1)[-1]
    if key == "cpu":
        return f"{amount}m"
    return str(amount)


class ResourceQuotaController(Controller):
    name = "resourcequota"
    workers = 1
    # upstream's full resync is every 5m; event-driven enqueues (quota
    # changes, pod churn) carry the steady state — tests override this
    tick_interval = 300.0

    def register(self, factory: InformerFactory) -> None:
        self.quota_informer = factory.informer("resourcequotas", None)
        self.quota_informer.add_event_handler(
            lambda t, obj, old: self.enqueue(obj))
        # pod churn re-syncs the owning namespace's quotas
        self.pod_informer = factory.informer("pods", None)
        self.pod_informer.add_event_handler(self._on_pod)

    def _on_pod(self, type_, obj, old) -> None:
        ns = (obj.get("metadata") or {}).get("namespace", "default")
        for q in self.quota_informer.store.list():
            if (q.get("metadata") or {}).get("namespace") == ns:
                self.enqueue(q)

    def tick(self) -> None:
        for q in self.quota_informer.store.list():
            self.enqueue(q)

    def sync(self, key: str) -> None:
        ns, _, name = key.partition("/")
        res = self.client.resource("resourcequotas", ns)
        try:
            quota = res.get(name)
        except ApiError as e:
            if e.code == 404:
                return
            raise
        hard = (quota.get("spec") or {}).get("hard") or {}
        used: dict[str, str] = {}
        pods = [p for p in self.pod_informer.store.list()
                if (p.get("metadata") or {}).get("namespace") == ns
                and (p.get("status") or {}).get("phase")
                not in ("Succeeded", "Failed")]
        for r in hard:
            if r == "pods":
                used[r] = str(len(pods))
            elif r in ("cpu", "memory", "requests.cpu", "requests.memory"):
                key_r = r.split("requests.", 1)[-1]
                total = 0
                for p in pods:
                    for c in ((p.get("spec") or {}).get("containers") or []):
                        req = ((c.get("resources") or {})
                               .get("requests") or {})
                        if key_r in req:
                            total += canonical(key_r, req[key_r])
                used[r] = _fmt(r, total)
            elif r in _COUNTED:
                try:
                    n = len(self.client.resource(_COUNTED[r], ns).list())
                except ApiError:
                    n = 0
                used[r] = str(n)
        status = quota.get("status") or {}
        if status.get("used") == used and status.get("hard") == hard:
            return
        quota["status"] = {"hard": dict(hard), "used": used}
        try:
            res.update_status(quota)
        except ApiError as e:
            if e.code not in (404, 409):  # 409: raced; requeue via churn
                raise
