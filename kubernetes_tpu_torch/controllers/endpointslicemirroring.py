"""EndpointSlice mirroring — custom Endpoints get mirrored slices.

Reference: ``pkg/controller/endpointslicemirroring``: Endpoints objects
maintained by USERS (no matching selector-driven controller — e.g. an
external database published as a Service without a selector) are mirrored
into EndpointSlices so slice-only consumers (kube-proxy's nftables
backend, topology-aware routing) see them. Endpoints managed by the
endpoints controller itself are skipped (the endpointslice controller
already covers those), via the ``endpointslice.kubernetes.io/skip-mirror``
label upstream's endpoints controller stamps.
"""

from __future__ import annotations

from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.controllers.base import Controller, split_key

SKIP_MIRROR_LABEL = "endpointslice.kubernetes.io/skip-mirror"
MANAGED_BY = "endpointslicemirroring-controller.k8s.io"


class EndpointSliceMirroringController(Controller):
    name = "endpointslicemirroring"
    workers = 1

    def register(self, factory: InformerFactory) -> None:
        self.ep_informer = factory.informer("endpoints", None)
        self.ep_informer.add_event_handler(self.handler())
        # Service create/delete/selector changes flip mirror eligibility
        self.svc_informer = factory.informer("services", None)
        self.svc_informer.add_event_handler(self.handler())
        # an out-of-band slice deletion must heal: re-enqueue the owner
        self.slice_informer = factory.informer("endpointslices", None)
        self.slice_informer.add_event_handler(self._on_slice)

    def _on_slice(self, type_, obj, old) -> None:
        md = obj.get("metadata") or {}
        labels = md.get("labels") or {}
        if labels.get("endpointslice.kubernetes.io/managed-by") \
                == MANAGED_BY:
            ns = md.get("namespace", "default")
            self.queue.add(f"{ns}/{labels.get('kubernetes.io/service-name', '')}")

    def _should_mirror(self, ep: dict, key: str) -> bool:
        labels = (ep.get("metadata") or {}).get("labels") or {}
        if labels.get(SKIP_MIRROR_LABEL) in ("true", "True"):
            return False
        svc = self.svc_informer.store.get(key)
        if svc is None:
            return False  # no backing Service: nothing to mirror for
        # selector-driven services are the endpointslice controller's job
        return not (svc.get("spec") or {}).get("selector")

    def _desired_slices(self, ep: dict, ns: str, name: str) -> list[dict]:
        """One mirror slice PER SUBSET: a subset binds its addresses to its
        ports (that is what subsets express), so flattening would advertise
        addresses on ports they do not serve — the sibling endpointslice
        controller groups by port set the same way."""
        out = []
        for i, subset in enumerate(ep.get("subsets") or []):
            ports = [{"name": p.get("name", ""), "port": p.get("port"),
                      "protocol": p.get("protocol", "TCP")}
                     for p in subset.get("ports") or []]
            endpoints = (
                [{"addresses": [a.get("ip", "")],
                  "conditions": {"ready": True}}
                 for a in subset.get("addresses") or []]
                + [{"addresses": [a.get("ip", "")],
                    "conditions": {"ready": False}}
                   for a in subset.get("notReadyAddresses") or []])
            out.append({
                "kind": "EndpointSlice",
                "metadata": {
                    "name": f"{name}-mirror-{i}", "namespace": ns,
                    "labels": {"kubernetes.io/service-name": name,
                               "endpointslice.kubernetes.io/managed-by":
                               MANAGED_BY},
                },
                "addressType": "IPv4",
                "endpoints": endpoints,
                "ports": ports,
            })
        return out

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        slices = self.client.resource("endpointslices", ns)
        existing = [
            s for s in self.slice_informer.store.list()
            if (s.get("metadata") or {}).get("namespace", "") == ns
            and ((s.get("metadata") or {}).get("labels") or {})
            .get("kubernetes.io/service-name") == name
            and ((s.get("metadata") or {}).get("labels") or {})
            .get("endpointslice.kubernetes.io/managed-by") == MANAGED_BY]
        ep = self.ep_informer.store.get(key)
        desired = ([] if ep is None or not self._should_mirror(ep, key)
                   else self._desired_slices(ep, ns, name))
        by_name = {(s.get("metadata") or {}).get("name"): s
                   for s in existing}
        for d in desired:
            cur = by_name.pop(d["metadata"]["name"], None)
            if cur is None:
                try:
                    slices.create(d)
                except ApiError as e:
                    if e.code != 409:
                        raise
            elif (cur.get("endpoints") != d["endpoints"]
                  or cur.get("ports") != d["ports"]):
                # optimistic concurrency: carry the precondition rv
                d["metadata"]["resourceVersion"] = \
                    (cur.get("metadata") or {}).get("resourceVersion", "")
                try:
                    slices.update(d)
                except ApiError as e:
                    if e.code not in (404, 409):
                        raise
        for stale in by_name.values():
            try:
                slices.delete((stale.get("metadata") or {}).get("name", ""))
            except ApiError as e:
                if e.code != 404:
                    raise
