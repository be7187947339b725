"""Job controller — run pods to completion.

Reference: ``pkg/controller/job/job_controller.go`` (``syncJob``: count
active/succeeded/failed pods, create up to parallelism, stop at completions,
fail the job past backoffLimit).
"""

from __future__ import annotations

import time

from kubernetes_tpu_torch.api.selectors import label_selector_matches
from kubernetes_tpu_torch.api.types import LabelSelector
from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.controllers.base import (
    Controller,
    active_pods,
    is_controlled_by,
    split_key,
)
from kubernetes_tpu_torch.controllers.replicaset import pod_from_template


def _condition(job: dict, type_: str) -> bool:
    return any(c.get("type") == type_ and c.get("status") == "True"
               for c in (job.get("status") or {}).get("conditions") or [])


def job_finished(job: dict) -> bool:
    return _condition(job, "Complete") or _condition(job, "Failed")


class JobController(Controller):
    name = "job"

    def register(self, factory: InformerFactory) -> None:
        self.job_informer = factory.informer("jobs", None)
        self.job_informer.add_event_handler(self.handler())
        self.pod_informer = factory.informer("pods", None)
        self.pod_informer.add_event_handler(
            self.handler(lambda obj: self.enqueue_owner(obj, "Job")))

    def _owned_pods(self, job: dict) -> list[dict]:
        ns = (job.get("metadata") or {}).get("namespace", "")
        sel = LabelSelector.from_dict((job.get("spec") or {}).get("selector"))
        out = []
        for p in self.pod_informer.store.list():
            md = p.get("metadata") or {}
            if md.get("namespace", "") != ns:
                continue
            if sel is not None and not label_selector_matches(sel, md.get("labels") or {}):
                continue
            if is_controlled_by(p, job):
                out.append(p)
        return out

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        job = self.job_informer.store.get(key)
        if job is None or (job.get("metadata") or {}).get("deletionTimestamp"):
            return
        if job_finished(job):
            return
        spec = job.get("spec") or {}
        parallelism = int(spec.get("parallelism", 1))
        completions = spec.get("completions")  # None = work-queue semantics
        backoff_limit = int(spec.get("backoffLimit", 6))

        pods = self._owned_pods(job)
        active = active_pods(pods)
        succeeded = sum(1 for p in pods
                        if (p.get("status") or {}).get("phase") == "Succeeded")
        failed = sum(1 for p in pods
                     if (p.get("status") or {}).get("phase") == "Failed")

        conditions = list((job.get("status") or {}).get("conditions") or [])
        now = time.time()
        if failed > backoff_limit:
            conditions.append({"type": "Failed", "status": "True",
                               "reason": "BackoffLimitExceeded",
                               "lastTransitionTime": now})
            for p in active:
                self._delete_pod(p)
            active = []
        elif completions is not None and succeeded >= int(completions):
            conditions.append({"type": "Complete", "status": "True",
                               "lastTransitionTime": now})
            for p in active:
                self._delete_pod(p)
            active = []
        else:
            want_active = parallelism
            if completions is not None:
                want_active = min(parallelism, int(completions) - succeeded)
            diff = want_active - len(active)
            if diff > 0:
                pods_api = self.client.pods(ns)
                tpl_job = {**job, "apiVersion": "batch/v1"}
                for _ in range(diff):
                    pod = pod_from_template(tpl_job, kind="Job")
                    pod["spec"]["restartPolicy"] = (job.get("spec", {})
                                                    .get("template", {})
                                                    .get("spec", {})
                                                    .get("restartPolicy", "Never"))
                    pods_api.create(pod)
            elif diff < 0:
                for p in active[:(-diff)]:
                    self._delete_pod(p)

        status = {
            "active": len(active),
            "succeeded": succeeded,
            "failed": failed,
            "conditions": conditions,
        }
        if job.get("status") != status:
            try:
                self.client.resource("jobs", ns).update_status({**job, "status": status})
            except ApiError as e:
                if e.code not in (404, 409):
                    raise

    def _delete_pod(self, p: dict) -> None:
        try:
            self.client.pods(p["metadata"].get("namespace", "default")) \
                .delete(p["metadata"]["name"])
        except ApiError as e:
            if e.code != 404:
                raise
