"""TTL-after-finished controller — delete finished Jobs past their TTL.

Reference: ``pkg/controller/ttlafterfinished/ttlafterfinished_controller.go``
(``processJob``: a Job with ``spec.ttlSecondsAfterFinished`` whose finish
time + TTL has passed is deleted; cascading deletion of its pods is the
garbage collector's business via ownerReferences).
"""

from __future__ import annotations

import time

from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.controllers.base import Controller, split_key
from kubernetes_tpu_torch.controllers.job import job_finished


def _finish_time(job: dict) -> float:
    st = job.get("status") or {}
    if st.get("completionTime"):
        return float(st["completionTime"])
    for c in st.get("conditions") or []:
        if c.get("type") in ("Complete", "Failed") and c.get("status") == "True":
            if c.get("lastTransitionTime"):
                return float(c["lastTransitionTime"])
    return float((job.get("metadata") or {}).get("creationTimestamp") or 0)


class TTLAfterFinishedController(Controller):
    name = "ttlafterfinished"
    tick_interval = 1.0

    def register(self, factory: InformerFactory) -> None:
        self.job_informer = factory.informer("jobs", None)
        self.job_informer.add_event_handler(self.handler())

    def tick(self) -> None:
        for j in self.job_informer.store.list():
            if (j.get("spec") or {}).get("ttlSecondsAfterFinished") is not None:
                self.enqueue(j)

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        job = self.job_informer.store.get(key)
        if job is None:
            return
        ttl = (job.get("spec") or {}).get("ttlSecondsAfterFinished")
        if ttl is None or not job_finished(job):
            return
        if time.time() - _finish_time(job) < float(ttl):
            return
        try:
            self.client.resource("jobs", ns).delete(name)
        except ApiError as e:
            if e.code != 404:
                raise
