"""Endpoints controller — Service selector -> ready pod addresses.

Reference: ``pkg/controller/endpoint/endpoints_controller.go``
(``syncService``: list pods matching .spec.selector, split into
ready/notReady addresses, write the Endpoints object the proxy consumes).
The EndpointSlice shape upstream adds is a sharded encoding of the same
data; one Endpoints object per service carries it here.

The port's copy of ``kubernetes_tpu/controllers/endpoints.py``; a sync
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


def _resolve_target_port(sp: dict, pod: dict):
    """targetPort may be a name — resolve it against THIS pod's container
    ports (endpoints_controller FindPort is per-pod: during a rolling update
    the same port name can map to different containerPorts on old and new
    pods, and each address must advertise its own). None = the pod does not
    expose the named port, so it is skipped for this service port."""
    tp = sp.get("targetPort", sp.get("port", 0))
    if isinstance(tp, int):
        return tp
    if isinstance(tp, str) and tp.isdigit():
        return int(tp)
    for c in (pod.get("spec") or {}).get("containers") or []:
        for port in c.get("ports") or []:
            if port.get("name") == tp and port.get("containerPort"):
                return int(port["containerPort"])
    return None


class EndpointsController(Controller):
    name = "endpoints"

    def register(self, factory: InformerFactory) -> None:
        self.svc_informer = factory.informer("services", None)
        self.svc_informer.add_event_handler(self.handler())
        self.pod_informer = factory.informer("pods", None)
        self.pod_informer.add_indexers({LABEL_INDEX: namespace_labels})
        self.pod_informer.add_event_handler(self.handler(self._enqueue_services))

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

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        svc = self.svc_informer.store.get(key)
        if svc is None:
            # service deleted -> delete its endpoints
            try:
                self.client.endpoints(ns).delete(name)
            except ApiError as e:
                if e.code != 404:
                    raise
            return
        sel = (svc.get("spec") or {}).get("selector") or {}
        if not sel:
            return  # selectorless services manage endpoints manually
        svc_ports = (svc.get("spec") or {}).get("ports") or []
        # Group addresses by their RESOLVED port set (RepackSubsets): pods
        # whose named targetPorts resolve differently land in separate
        # subsets, each advertising its own containerPort.
        groups: dict[tuple, dict] = {}
        for p in selected(self.pod_informer.store, ns, sel):
            md = p.get("metadata") or {}
            if md.get("namespace", "") != ns:
                continue
            labels = md.get("labels") or {}
            if not all(labels.get(k) == v for k, v in sel.items()):
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
                continue  # pod exposes none of the service's named ports
            gkey = tuple(sorted((pp["name"], pp["port"], pp["protocol"])
                                for pp in ports))
            g = groups.setdefault(gkey, {"ports": ports, "ready": [],
                                         "not_ready": []})
            addr = {"ip": st.pod_ip,
                    "nodeName": (p.get("spec") or {}).get("nodeName", ""),
                    "targetRef": {"kind": "Pod", "name": md.get("name", ""),
                                  "namespace": ns, "uid": md.get("uid", "")}}
            g["ready" if st.is_ready() else "not_ready"].append(addr)
        subsets = []
        for gkey in sorted(groups):
            g = groups[gkey]
            subset: dict = {"ports": g["ports"]}
            if g["ready"]:
                subset["addresses"] = sorted(g["ready"], key=lambda a: a["ip"])
            if g["not_ready"]:
                subset["notReadyAddresses"] = sorted(g["not_ready"],
                                                     key=lambda a: a["ip"])
            subsets.append(subset)
        ep_api = self.client.endpoints(ns)
        desired = {"apiVersion": "v1", "kind": "Endpoints",
                   "metadata": {"name": name, "namespace": ns,
                                "labels": dict((svc.get("metadata") or {})
                                               .get("labels") or {})},
                   "subsets": subsets}
        try:
            current = ep_api.get(name)
        except ApiError as e:
            if e.code != 404:
                raise
            ep_api.create(desired)
            return
        if current.get("subsets") != subsets:
            desired["metadata"]["resourceVersion"] = \
                (current.get("metadata") or {}).get("resourceVersion", "")
            ep_api.update(desired)  # 409 -> requeue with backoff
