"""ResourceClaim controller — DRA claim lifecycle.

Reference: ``pkg/controller/resourceclaim/controller.go``: for each pod
entry in ``spec.resourceClaims`` referencing a ``resourceClaimTemplateName``,
generate a per-pod ResourceClaim (named ``<pod>-<entry name>`` here, owned
by the pod so the GC cascades it); and release allocations whose consumer
pod is gone (drop ``status.allocation``/``reservedFor`` so the devices
return to the pool — the deallocate half of dynamicresources.go).

The PyTorch port's copy of ``kubernetes_tpu/controllers/resourceclaim.py``.
The port has no controller manager yet (ROADMAP Queue A item 14): whoever
runs the scheduler starts this controller itself — ``register`` on an
``InformerFactory``, start the factory, then ``start()``.
"""

from __future__ import annotations

from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.controllers.base import Controller, split_key
from kubernetes_tpu_torch.sched.dra import release_patch


class ResourceClaimController(Controller):
    name = "resourceclaim"
    tick_interval = 2.0  # release sweep (consumer-gone detection)

    def register(self, factory: InformerFactory) -> None:
        self.pod_informer = factory.informer("pods", None)
        self.pod_informer.add_event_handler(self.handler())
        self.claim_informer = factory.informer("resourceclaims", None)
        self.tpl_informer = factory.informer("resourceclaimtemplates", None)

    def tick(self) -> None:
        # release pass: any allocated claim whose reserving pod no longer
        # exists (or is terminal) gets its allocation dropped
        for claim in self.claim_informer.store.list():
            status = claim.get("status") or {}
            if not status.get("allocation"):
                continue
            ns = (claim.get("metadata") or {}).get("namespace", "default")
            holders = status.get("reservedFor") or []
            live = False
            for ref in holders:
                pod = self.pod_informer.store.get(f"{ns}/{ref.get('name', '')}")
                if pod is None:
                    continue
                # a recreated same-name pod is a DIFFERENT consumer: the
                # reservation must name this pod's uid (upstream validates
                # reservedFor uids)
                ref_uid = ref.get("uid", "")
                if ref_uid and ref_uid != (pod.get("metadata") or {}).get("uid"):
                    continue
                if (pod.get("status") or {}).get("phase") not in (
                        "Succeeded", "Failed"):
                    live = True
            if not live:  # incl. an allocation nobody reserves
                try:
                    self.client.resource("resourceclaims", ns).update_status(
                        release_patch(claim))
                except ApiError as e:
                    if e.code not in (404, 409):
                        raise

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        pod = self.pod_informer.store.get(key)
        if pod is None:
            return  # pod-owned claims cascade via the GC
        for entry in (pod.get("spec") or {}).get("resourceClaims") or []:
            tpl_name = entry.get("resourceClaimTemplateName")
            if not tpl_name:
                continue
            claim_name = f"{name}-{entry.get('name', '')}"
            if self.claim_informer.store.get(f"{ns}/{claim_name}") is not None:
                continue
            tpl = self.tpl_informer.store.get(f"{ns}/{tpl_name}")
            if tpl is None:
                raise RuntimeError(f"claim template {ns}/{tpl_name} not found")
            md = pod.get("metadata") or {}
            claim = {
                "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
                "metadata": {
                    "name": claim_name, "namespace": ns,
                    "ownerReferences": [{
                        "apiVersion": "v1", "kind": "Pod",
                        "name": md.get("name", ""), "uid": md.get("uid", ""),
                        "controller": True, "blockOwnerDeletion": True}],
                },
                "spec": dict(((tpl.get("spec") or {}).get("spec")) or {}),
            }
            try:
                self.client.resource("resourceclaims", ns).create(claim)
            except ApiError as e:
                if e.code != 409:
                    raise
