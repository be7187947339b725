"""StatefulSet controller — ordered, identity-stable replicas.

Reference: ``pkg/controller/statefulset/stateful_set.go`` +
``stateful_set_control.go`` (``UpdateStatefulSet``: ordinal pods
``<name>-<i>``, OrderedReady semantics — create ordinal i only when i-1 is
Running+Ready, scale down from the top, also only one at a time).
"""

from __future__ import annotations

import json

from kubernetes_tpu_torch.api.types import PodStatus
from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.controllers.base import (
    Controller,
    is_controlled_by,
    owner_reference,
    split_key,
)


def _ordinal(pod_name: str, set_name: str) -> int:
    prefix = set_name + "-"
    if not pod_name.startswith(prefix):
        return -1
    try:
        return int(pod_name[len(prefix):])
    except ValueError:
        return -1


class StatefulSetController(Controller):
    name = "statefulset"

    def register(self, factory: InformerFactory) -> None:
        self.ss_informer = factory.informer("statefulsets", None)
        self.ss_informer.add_event_handler(self.handler())
        self.pod_informer = factory.informer("pods", None)
        self.pod_informer.add_event_handler(
            self.handler(lambda obj: self.enqueue_owner(obj, "StatefulSet")))

    def _ordinal_pod(self, ss: dict, i: int) -> dict:
        tpl = (ss.get("spec") or {}).get("template") or {}
        md = ss.get("metadata") or {}
        return {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": f"{md.get('name', 'x')}-{i}",
                "namespace": md.get("namespace", "default"),
                "labels": dict((tpl.get("metadata") or {}).get("labels") or {}),
                "ownerReferences": [owner_reference(ss, "StatefulSet")],
            },
            "spec": json.loads(json.dumps(tpl.get("spec") or {})),
            "status": {"phase": "Pending"},
        }

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        ss = self.ss_informer.store.get(key)
        if ss is None or (ss.get("metadata") or {}).get("deletionTimestamp"):
            return
        replicas = int((ss.get("spec") or {}).get("replicas", 1))
        owned = {_ordinal(p["metadata"]["name"], name): p
                 for p in self.pod_informer.store.list()
                 if (p.get("metadata") or {}).get("namespace", "") == ns
                 and is_controlled_by(p, ss)
                 and _ordinal(p["metadata"]["name"], name) >= 0}
        pods_api = self.client.pods(ns)

        # monotonic scale-up: first missing/unready ordinal gates the rest
        ready = 0
        for i in range(replicas):
            p = owned.get(i)
            if p is None:
                pods_api.create(self._ordinal_pod(ss, i))
                break
            st = PodStatus.from_dict(p.get("status"))
            if st.phase == "Failed" or (p.get("metadata") or {}).get("deletionTimestamp"):
                if not (p.get("metadata") or {}).get("deletionTimestamp"):
                    pods_api.delete(p["metadata"]["name"])  # replace next sync
                break
            if not (st.phase == "Running" and st.is_ready()):
                break  # OrderedReady: wait before creating i+1
            ready += 1

        # scale-down from the top, one at a time, only when all ≤replicas-1
        # are stable (condemned ordering in stateful_set_control.go)
        above = sorted((i for i in owned if i >= replicas), reverse=True)
        if above and ready == replicas:
            try:
                pods_api.delete(owned[above[0]]["metadata"]["name"])
            except ApiError as e:
                if e.code != 404:
                    raise

        status = {
            "replicas": len([i for i in owned if i < replicas]),
            "readyReplicas": ready,
            "currentReplicas": len([i for i in owned if i < replicas]),
            "observedGeneration": (ss.get("metadata") or {}).get("generation", 0),
        }
        if ss.get("status") != status:
            try:
                self.client.resource("statefulsets", ns).update_status(
                    {**ss, "status": status})
            except ApiError as e:
                if e.code not in (404, 409):
                    raise
