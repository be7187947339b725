"""Attach/detach controller — VolumeAttachment reconciliation.

Reference: ``pkg/controller/volume/attachdetach/attach_detach_controller.go``
(desired-state-of-world from pods' volumes vs actual-state-of-world from
VolumeAttachment objects; the reconciler attaches what pods on a node need
and detaches what nothing needs) plus the storage.k8s.io/v1
``VolumeAttachment`` API (``csi-attacher`` sets ``status.attached``; played
in-process here, as pvbinder plays the external provisioner).

Desired: every (node, PV) pair where a pod bound to the node mounts a PVC
whose bound PV is attachable (CSI-backed). Reconcile:
- missing pair -> create VolumeAttachment {attacher, nodeName, source}
  and mark ``status.attached`` true;
- orphaned VolumeAttachment (no pod needs it) -> delete;
- node.status.volumesAttached mirrors the attached set (kubelets and the
  scheduler's NodeVolumeLimits read it upstream).

The port's copy of ``kubernetes_tpu/controllers/attachdetach.py``; its
``_desired`` skips the scan of every pod when no claim is bound to an
attachable volume (the same empty answer, without a walk per event).
"""

from __future__ import annotations

from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.controllers.base import Controller

RECONCILE_KEY = "_reconcile"


def attachment_name(pv_name: str, node_name: str) -> str:
    import hashlib
    h = hashlib.sha256(f"{pv_name}/{node_name}".encode()).hexdigest()[:12]
    return f"csi-{h}"


class AttachDetachController(Controller):
    name = "attachdetach"
    workers = 1

    def register(self, factory: InformerFactory) -> None:
        self.pod_informer = factory.informer("pods", None)
        self.pvc_informer = factory.informer("persistentvolumeclaims", None)
        self.pv_informer = factory.informer("persistentvolumes", None)
        self.va_informer = factory.informer("volumeattachments", None)
        self.node_informer = factory.informer("nodes", None)
        for inf in (self.pod_informer, self.pvc_informer, self.pv_informer,
                    self.va_informer, self.node_informer):
            inf.add_event_handler(
                lambda *_a: self.enqueue_key(RECONCILE_KEY))

    def enqueue_key(self, key: str) -> None:
        self.queue.add(key)

    # ---- desired / actual state ------------------------------------------

    def _attachable_pv(self, pv: dict) -> bool:
        spec = pv.get("spec") or {}
        return bool(spec.get("csi"))  # local/hostPath volumes never attach

    def _desired(self) -> dict[tuple[str, str], dict]:
        """(pv_name, node_name) -> pv object for every needed attachment."""
        pvc_to_pv: dict[tuple, dict] = {}
        pvs = {((p.get("metadata") or {}).get("name", "")): p
               for p in self.pv_informer.store.list()}
        for pvc in self.pvc_informer.store.list():
            md = pvc.get("metadata") or {}
            vol = (pvc.get("spec") or {}).get("volumeName", "")
            if vol and vol in pvs:
                pvc_to_pv[(md.get("namespace", "default"),
                           md.get("name", ""))] = pvs[vol]
        out: dict[tuple[str, str], dict] = {}
        if not any(self._attachable_pv(pv) for pv in pvc_to_pv.values()):
            return out  # no pod can need an attachment: skip the pod scan
        for pod in self.pod_informer.store.list():
            spec = pod.get("spec") or {}
            node = spec.get("nodeName", "")
            phase = (pod.get("status") or {}).get("phase", "")
            if not node or phase in ("Succeeded", "Failed"):
                continue
            ns = (pod.get("metadata") or {}).get("namespace", "default")
            for v in spec.get("volumes") or []:
                claim = (v.get("persistentVolumeClaim") or {}).get(
                    "claimName", "")
                if not claim:
                    continue
                pv = pvc_to_pv.get((ns, claim))
                if pv is not None and self._attachable_pv(pv):
                    name = (pv.get("metadata") or {}).get("name", "")
                    out[(name, node)] = pv
        return out

    # ---- reconcile -------------------------------------------------------

    def sync(self, key: str) -> None:
        desired = self._desired()
        vas = self.client.resource("volumeattachments", None)
        actual: dict[tuple[str, str], dict] = {}
        for va in self.va_informer.store.list():
            spec = va.get("spec") or {}
            pv_name = ((spec.get("source") or {})
                       .get("persistentVolumeName", ""))
            actual[(pv_name, spec.get("nodeName", ""))] = va

        for (pv_name, node), pv in desired.items():
            if (pv_name, node) in actual:
                continue
            driver = ((pv.get("spec") or {}).get("csi") or {}).get(
                "driver", "csi")
            try:
                created = vas.create({
                    "kind": "VolumeAttachment",
                    "metadata": {"name": attachment_name(pv_name, node)},
                    "spec": {"attacher": driver, "nodeName": node,
                             "source": {"persistentVolumeName": pv_name}}})
            except ApiError as e:
                if e.code != 409:
                    raise
                continue
            # play the external attacher: report attached
            created.setdefault("status", {})["attached"] = True
            try:
                vas.update_status(created)
            except ApiError as e:
                if e.code not in (404, 409):
                    raise

        for (pv_name, node), va in actual.items():
            if (pv_name, node) in desired:
                continue
            try:
                vas.delete((va.get("metadata") or {}).get("name", ""))
            except ApiError as e:
                if e.code != 404:
                    raise

        self._sync_node_status(desired)

    def _sync_node_status(self, desired: dict) -> None:
        """node.status.volumesAttached mirrors the attached set."""
        by_node: dict[str, list[str]] = {}
        for (pv_name, node) in desired:
            by_node.setdefault(node, []).append(pv_name)
        nodes = self.client.resource("nodes", None)
        for n in self.node_informer.store.list():
            name = (n.get("metadata") or {}).get("name", "")
            want = [{"name": f"kubernetes.io/csi/{pv}", "devicePath": ""}
                    for pv in sorted(by_node.get(name, []))]
            have = (n.get("status") or {}).get("volumesAttached") or []
            if have == want:
                continue
            try:
                node = nodes.get(name)
                node.setdefault("status", {})["volumesAttached"] = want
                nodes.update_status(node)
            except ApiError as e:
                if e.code not in (404, 409):
                    raise
