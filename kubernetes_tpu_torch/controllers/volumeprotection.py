"""PVC/PV protection — finalizers against deleting storage in use.

Reference: ``pkg/controller/volume/pvcprotection`` and ``pvprotection``:
every PVC carries the ``kubernetes.io/pvc-protection`` finalizer (and PVs
``kubernetes.io/pv-protection``), so a user delete only marks the object
terminating; the finalizer comes off — letting the delete complete — when
no pod mounts the claim (resp. no claim binds the volume). Data in active
use can never vanish out from under its consumers.
"""

from __future__ import annotations

from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.controllers.base import Controller, split_key

PVC_FINALIZER = "kubernetes.io/pvc-protection"
PV_FINALIZER = "kubernetes.io/pv-protection"


def _update(res, obj: dict) -> None:
    """409/404-tolerant update: a conflict means fresher state is already
    on the way through the informer, which re-enqueues."""
    try:
        res.update(obj)
    except ApiError as e:
        if e.code not in (404, 409):
            raise


class PVCProtectionController(Controller):
    name = "pvc-protection"
    workers = 1

    def register(self, factory: InformerFactory) -> None:
        self.pvc_informer = factory.informer("persistentvolumeclaims", None)
        self.pvc_informer.add_event_handler(self.handler())
        self.pod_informer = factory.informer("pods", None)
        self.pod_informer.add_event_handler(self._on_pod)

    def _on_pod(self, type_, obj, old) -> None:
        """A pod releasing a claim may unblock its pending delete."""
        ns = (obj.get("metadata") or {}).get("namespace", "default")
        for vol in (obj.get("spec") or {}).get("volumes") or []:
            claim = (vol.get("persistentVolumeClaim") or {}).get(
                "claimName", "")
            if claim:
                self.queue.add(f"{ns}/{claim}")

    def _in_use(self, ns: str, name: str) -> bool:
        for pod in self.pod_informer.store.list():
            md = pod.get("metadata") or {}
            if md.get("namespace", "default") != ns:
                continue
            if (pod.get("status") or {}).get("phase") in ("Succeeded",
                                                          "Failed"):
                continue
            for vol in (pod.get("spec") or {}).get("volumes") or []:
                if (vol.get("persistentVolumeClaim") or {}).get(
                        "claimName") == name:
                    return True
        return False

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        pvcs = self.client.resource("persistentvolumeclaims", ns)
        try:
            pvc = pvcs.get(name)
        except ApiError as e:
            if e.code == 404:
                return
            raise
        md = pvc.setdefault("metadata", {})
        fins = list(md.get("finalizers") or [])
        if md.get("deletionTimestamp"):
            if PVC_FINALIZER in fins and not self._in_use(ns, name):
                md["finalizers"] = [f for f in fins if f != PVC_FINALIZER]
                _update(pvcs, pvc)
        elif PVC_FINALIZER not in fins:
            md["finalizers"] = fins + [PVC_FINALIZER]
            _update(pvcs, pvc)


class PVProtectionController(Controller):
    name = "pv-protection"
    workers = 1

    def register(self, factory: InformerFactory) -> None:
        self.pv_informer = factory.informer("persistentvolumes", None)
        self.pv_informer.add_event_handler(self.handler())
        self.pvc_informer = factory.informer("persistentvolumeclaims", None)
        self.pvc_informer.add_event_handler(self._on_pvc)

    def _on_pvc(self, type_, obj, old) -> None:
        vol = (obj.get("spec") or {}).get("volumeName", "")
        if vol:
            self.queue.add(vol)

    def _bound(self, name: str) -> bool:
        for pvc in self.pvc_informer.store.list():
            if (pvc.get("spec") or {}).get("volumeName") == name:
                return True
        return False

    def sync(self, key: str) -> None:
        name = key.split("/")[-1]
        pvs = self.client.resource("persistentvolumes", None)
        try:
            pv = pvs.get(name)
        except ApiError as e:
            if e.code == 404:
                return
            raise
        md = pv.setdefault("metadata", {})
        fins = list(md.get("finalizers") or [])
        if md.get("deletionTimestamp"):
            if PV_FINALIZER in fins and not self._bound(name):
                md["finalizers"] = [f for f in fins if f != PV_FINALIZER]
                _update(pvs, pv)
        elif PV_FINALIZER not in fins:
            md["finalizers"] = fins + [PV_FINALIZER]
            _update(pvs, pv)
