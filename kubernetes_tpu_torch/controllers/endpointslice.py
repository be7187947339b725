"""EndpointSlice controller — sharded endpoints (discovery.k8s.io/v1).

Reference: ``pkg/controller/endpointslice/endpointslice_controller.go`` +
``staging/src/k8s.io/endpointslice/reconciler.go``: for each Service, emit
EndpointSlice objects labeled ``kubernetes.io/service-name`` holding at most
``maxEndpointsPerSlice`` endpoints each, with per-endpoint ready condition
and per-slice resolved ports (named targetPorts resolve per pod, so pods
whose ports differ land in different slices — same grouping as the
Endpoints controller's subsets).

The port's copy of ``kubernetes_tpu/controllers/endpointslice.py``; a sync
reads its Service's pods from the pods informer's ``LABEL_INDEX`` (the
same pods as the reference's walk of the whole cache).
"""

from __future__ import annotations

from kubernetes_tpu_torch.api.types import PodStatus
from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.controllers.base import (
    LABEL_INDEX,
    Controller,
    namespace_labels,
    selected,
    split_key,
)
from kubernetes_tpu_torch.controllers.endpoints import _resolve_target_port

SERVICE_NAME_LABEL = "kubernetes.io/service-name"
MANAGED_BY_LABEL = "endpointslice.kubernetes.io/managed-by"
MANAGED_BY = "endpointslice-controller.k8s.io"
MAX_ENDPOINTS_PER_SLICE = 100


class EndpointSliceController(Controller):
    name = "endpointslice"

    def register(self, factory: InformerFactory) -> None:
        self.svc_informer = factory.informer("services", None)
        self.svc_informer.add_event_handler(self.handler())
        self.pod_informer = factory.informer("pods", None)
        self.pod_informer.add_indexers({LABEL_INDEX: namespace_labels})
        self.pod_informer.add_event_handler(self.handler(self._enqueue_services))
        self.slice_informer = factory.informer("endpointslices", None)

    def _enqueue_services(self, pod: dict) -> None:
        labels = (pod.get("metadata") or {}).get("labels") or {}
        ns = (pod.get("metadata") or {}).get("namespace", "")
        for svc in self.svc_informer.store.list():
            smd = svc.get("metadata") or {}
            if smd.get("namespace", "") != ns:
                continue
            sel = (svc.get("spec") or {}).get("selector") or {}
            if sel and all(labels.get(k) == v for k, v in sel.items()):
                self.enqueue(svc)

    def _desired_slices(self, svc: dict, ns: str, name: str) -> list[dict]:
        sel = (svc.get("spec") or {}).get("selector") or {}
        svc_ports = (svc.get("spec") or {}).get("ports") or []
        groups: dict[tuple, dict] = {}
        for p in selected(self.pod_informer.store, ns, sel) if sel else []:
            md = p.get("metadata") or {}
            if md.get("namespace", "") != ns:
                continue
            labels = md.get("labels") or {}
            if not sel or not all(labels.get(k) == v for k, v in sel.items()):
                continue
            st = PodStatus.from_dict(p.get("status"))
            if st.phase in ("Succeeded", "Failed") or not st.pod_ip:
                continue
            ports = []
            for sp in svc_ports:
                port = _resolve_target_port(sp, p)
                if port is not None:
                    ports.append({"name": sp.get("name", ""), "port": port,
                                  "protocol": sp.get("protocol", "TCP")})
            if svc_ports and not ports:
                continue
            gkey = tuple(sorted((pp["name"], pp["port"], pp["protocol"])
                                for pp in ports))
            g = groups.setdefault(gkey, {"ports": ports, "endpoints": []})
            g["endpoints"].append({
                "addresses": [st.pod_ip],
                "conditions": {"ready": st.is_ready()},
                "nodeName": (p.get("spec") or {}).get("nodeName", ""),
                "targetRef": {"kind": "Pod", "name": md.get("name", ""),
                              "namespace": ns, "uid": md.get("uid", "")}})
        slices = []
        idx = 0
        for gkey in sorted(groups):
            g = groups[gkey]
            eps = sorted(g["endpoints"], key=lambda e: e["addresses"][0])
            for off in range(0, len(eps), MAX_ENDPOINTS_PER_SLICE):
                slices.append({
                    "apiVersion": "discovery.k8s.io/v1",
                    "kind": "EndpointSlice",
                    "metadata": {"name": f"{name}-{idx}", "namespace": ns,
                                 "labels": {SERVICE_NAME_LABEL: name,
                                            MANAGED_BY_LABEL: MANAGED_BY}},
                    "addressType": "IPv4",
                    "ports": g["ports"],
                    "endpoints": eps[off:off + MAX_ENDPOINTS_PER_SLICE]})
                idx += 1
        return slices

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        svc = self.svc_informer.store.get(key)
        handle = self.client.resource("endpointslices", ns)
        existing = [
            s for s in self.slice_informer.store.list()
            if (s.get("metadata") or {}).get("namespace", "") == ns
            and ((s.get("metadata") or {}).get("labels") or {})
            .get(SERVICE_NAME_LABEL) == name
            # only slices THIS controller stamped are its to reconcile or
            # delete: a foreign manager's mirrors and a user's hand-made
            # unlabeled slices are both left alone (upstream contract)
            and ((s.get("metadata") or {}).get("labels") or {})
            .get(MANAGED_BY_LABEL) == MANAGED_BY]
        if svc is None or not (svc.get("spec") or {}).get("selector"):
            for s in existing:
                try:
                    handle.delete((s.get("metadata") or {}).get("name", ""))
                except ApiError as e:
                    if e.code != 404:
                        raise
            return
        desired = self._desired_slices(svc, ns, name)
        by_name = {(s.get("metadata") or {}).get("name"): s for s in existing}
        for d in desired:
            cur = by_name.pop(d["metadata"]["name"], None)
            if cur is None:
                try:
                    handle.create(d)
                except ApiError as e:
                    if e.code != 409:
                        raise
            elif (cur.get("endpoints") != d["endpoints"]
                  or cur.get("ports") != d["ports"]):
                d["metadata"]["resourceVersion"] = \
                    (cur.get("metadata") or {}).get("resourceVersion", "")
                handle.update(d)
        for stale in by_name.values():  # more slices than needed
            try:
                handle.delete((stale.get("metadata") or {}).get("name", ""))
            except ApiError as e:
                if e.code != 404:
                    raise
