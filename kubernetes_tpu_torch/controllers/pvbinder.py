"""PersistentVolume controller — bind claims, provision dynamic volumes.

Reference: ``pkg/controller/volume/persistentvolume/pv_controller.go``
(``syncUnboundClaim``: Immediate-mode claims bind to the smallest matching
PV; WaitForFirstConsumer claims wait for the scheduler's selected-node
annotation) + the external-provisioner contract (claims annotated
``volume.kubernetes.io/selected-node`` with a provisioner-backed class get a
volume created for them — played in-process here).
"""

from __future__ import annotations

from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.controllers.base import Controller, split_key
from kubernetes_tpu_torch.sched.volumebinding import (
    SELECTED_NODE_ANNOTATION,
    WAIT_FOR_FIRST_CONSUMER,
    VolumeCatalog,
    find_matching_pvs,
)


class PersistentVolumeController(Controller):
    name = "pvbinder"

    def register(self, factory: InformerFactory) -> None:
        self.pvc_informer = factory.informer("persistentvolumeclaims", None)
        self.pvc_informer.add_event_handler(self.handler())
        self.pv_informer = factory.informer("persistentvolumes", None)
        self.pv_informer.add_event_handler(self.handler(self._requeue_unbound))
        self.sc_informer = factory.informer("storageclasses", None)

    def _requeue_unbound(self, _pv: dict) -> None:
        for pvc in self.pvc_informer.store.list():
            if not (pvc.get("spec") or {}).get("volumeName"):
                self.enqueue(pvc)

    def _catalog(self) -> VolumeCatalog:
        return VolumeCatalog.from_lists(
            pvcs=self.pvc_informer.store.list(),
            pvs=self.pv_informer.store.list(),
            storage_classes=self.sc_informer.store.list())

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        pvc = self.pvc_informer.store.get(key)
        if pvc is None:
            return
        spec = pvc.get("spec") or {}
        if spec.get("volumeName"):
            self._ensure_bound_status(pvc)
            return
        catalog = self._catalog()
        sc_name = spec.get("storageClassName", "") or ""
        sc = catalog.storage_classes.get(sc_name)
        selected = ((pvc.get("metadata") or {}).get("annotations") or {}) \
            .get(SELECTED_NODE_ANNOTATION, "")
        wait_mode = bool(sc) and sc.get("volumeBindingMode",
                                        "Immediate") == WAIT_FOR_FIRST_CONSUMER
        if wait_mode and not selected:
            return  # scheduler picks the node first
        matches = find_matching_pvs(pvc, catalog)
        if matches:
            self._bind(pvc, matches[0])
        elif sc and sc.get("provisioner") and (selected or not wait_mode):
            self._provision(pvc, sc, selected)

    # ---- binding ---------------------------------------------------------

    def _bind(self, pvc: dict, pv: dict) -> None:
        md = pvc["metadata"]
        pv = dict(pv)
        pv["spec"] = {**(pv.get("spec") or {}),
                      "claimRef": {"kind": "PersistentVolumeClaim",
                                   "namespace": md.get("namespace", "default"),
                                   "name": md["name"], "uid": md.get("uid", "")}}
        pv["status"] = {**(pv.get("status") or {}), "phase": "Bound"}
        self.client.resource("persistentvolumes", None).update(pv)
        pvc = dict(pvc)
        pvc["spec"] = {**(pvc.get("spec") or {}),
                       "volumeName": pv["metadata"]["name"]}
        self.client.resource("persistentvolumeclaims",
                             md.get("namespace", "default")).update(pvc)
        self._ensure_bound_status(
            self.client.resource("persistentvolumeclaims",
                                 md.get("namespace", "default")).get(md["name"]))

    def _ensure_bound_status(self, pvc: dict) -> None:
        if (pvc.get("status") or {}).get("phase") == "Bound":
            return
        try:
            self.client.resource("persistentvolumeclaims",
                                 pvc["metadata"].get("namespace", "default")) \
                .update_status({**pvc, "status": {"phase": "Bound"}})
        except ApiError as e:
            if e.code not in (404, 409):
                raise

    def _provision(self, pvc: dict, sc: dict, selected_node: str) -> None:
        md = pvc["metadata"]
        spec = pvc.get("spec") or {}
        req = ((spec.get("resources") or {}).get("requests") or {}) \
            .get("storage", "1Gi")
        pv = {
            "apiVersion": "v1", "kind": "PersistentVolume",
            "metadata": {"name": f"pvc-{md.get('uid', md['name'])}",
                         "labels": {}},
            "spec": {"capacity": {"storage": req},
                     "accessModes": list(spec.get("accessModes") or
                                         ["ReadWriteOnce"]),
                     "storageClassName": spec.get("storageClassName", ""),
                     "claimRef": {"kind": "PersistentVolumeClaim",
                                  "namespace": md.get("namespace", "default"),
                                  "name": md["name"],
                                  "uid": md.get("uid", "")}},
            "status": {"phase": "Bound"},
        }
        if selected_node:
            # provisioned volume is reachable only from the selected node's
            # topology (external-provisioner sets real accessible topology;
            # node-pinned is the strictest faithful choice)
            pv["spec"]["nodeAffinity"] = {"required": {"nodeSelectorTerms": [
                {"matchFields": [{"key": "metadata.name", "operator": "In",
                                  "values": [selected_node]}]}]}}
        try:
            self.client.resource("persistentvolumes", None).create(pv)
        except ApiError as e:
            if e.code != 409:
                raise
        pvc = dict(pvc)
        pvc["spec"] = {**spec, "volumeName": pv["metadata"]["name"]}
        self.client.resource("persistentvolumeclaims",
                             md.get("namespace", "default")).update(pvc)
