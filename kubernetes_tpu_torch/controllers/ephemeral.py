"""Ephemeral-volume controller — PVCs for generic ephemeral volumes.

Reference: ``pkg/controller/volume/ephemeral/controller.go``: a pod volume
with ``ephemeral.volumeClaimTemplate`` gets a PersistentVolumeClaim named
``<pod>-<volume>``, owned by the pod (so it dies with it); the controller
refuses to adopt a same-named claim that is NOT owned by the pod
(conflict -> event, pod stays pending) exactly like upstream's
ephemeral_controller conflict check.
"""

from __future__ import annotations

from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.controllers.base import Controller, split_key


class EphemeralVolumeController(Controller):
    name = "ephemeral"
    workers = 1

    def __init__(self, client):
        super().__init__(client)
        from kubernetes_tpu_torch.utils.events import EventRecorder
        self.recorder = EventRecorder(client, "ephemeral-volume-controller")

    def register(self, factory: InformerFactory) -> None:
        self.pod_informer = factory.informer("pods", None)
        self.pod_informer.add_event_handler(self.handler())
        self.pvc_informer = factory.informer("persistentvolumeclaims", None)

    def sync(self, key: str) -> None:
        ns, _name = split_key(key)
        pod = self.pod_informer.store.get(key)
        if pod is None:
            return
        md = pod.get("metadata") or {}
        if md.get("deletionTimestamp"):
            return  # claims are owned: GC reaps them with the pod
        pvcs = self.client.resource("persistentvolumeclaims", ns)
        for vol in (pod.get("spec") or {}).get("volumes") or []:
            eph = vol.get("ephemeral") or {}
            tmpl = eph.get("volumeClaimTemplate")
            if not tmpl:
                continue
            claim_name = f"{md.get('name', '')}-{vol.get('name', '')}"
            existing = self.pvc_informer.store.get(f"{ns}/{claim_name}")
            if existing is not None:
                if not self._owned_by(existing, pod):
                    # same-named foreign claim: NEVER adopt (data of
                    # another workload); surface and leave the pod pending
                    self.recorder_event(pod, claim_name)
                continue
            claim = {
                "kind": "PersistentVolumeClaim",
                "metadata": {
                    "name": claim_name, "namespace": ns,
                    "labels": dict((tmpl.get("metadata") or {})
                                   .get("labels") or {}),
                    "annotations": dict((tmpl.get("metadata") or {})
                                        .get("annotations") or {}),
                    "ownerReferences": [{
                        "apiVersion": "v1", "kind": "Pod",
                        "name": md.get("name", ""),
                        "uid": md.get("uid", ""),
                        "controller": True,
                        "blockOwnerDeletion": True}],
                },
                "spec": dict(tmpl.get("spec") or {}),
            }
            try:
                pvcs.create(claim)
            except ApiError as e:
                if e.code != 409:
                    raise

    @staticmethod
    def _owned_by(claim: dict, pod: dict) -> bool:
        pod_uid = (pod.get("metadata") or {}).get("uid", "")
        return any(ref.get("kind") == "Pod" and ref.get("uid") == pod_uid
                   for ref in (claim.get("metadata") or {})
                   .get("ownerReferences") or [])

    def recorder_event(self, pod: dict, claim_name: str) -> None:
        self.recorder.event(pod, "Warning", "ConflictingPVC",
                            f"PVC {claim_name!r} exists and is not owned "
                            "by the pod")
