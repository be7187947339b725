"""CSR approving + cleaning — the other two certificate controllers.

Reference: ``pkg/controller/certificates/approver`` (auto-approve kubelet
client CSRs whose requestor is a node/bootstrapper identity — the
``sarapprove`` flow minus the SubjectAccessReview, which our RBAC layer
answers implicitly via group membership) and
``pkg/controller/certificates/cleaner`` (drop CSRs that are approved+issued,
denied, failed, or simply stale after an hour — the API is a request queue,
not a certificate store).
"""

from __future__ import annotations

import time

from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.controllers.base import Controller
from kubernetes_tpu_torch.controllers.certificates import _is_approved, _is_denied
from kubernetes_tpu_torch.utils.clock import rfc3339_now

SIGNER_KUBELET_CLIENT = "kubernetes.io/kube-apiserver-client-kubelet"
NODE_GROUPS = ("system:nodes", "system:bootstrappers")


class CSRApprovingController(Controller):
    """Auto-approve kubelet client certificate requests from node
    identities (csrapproving)."""

    name = "csrapproving"
    workers = 1

    def register(self, factory: InformerFactory) -> None:
        self.csr_informer = factory.informer("certificatesigningrequests",
                                             None)
        self.csr_informer.add_event_handler(self.handler())

    def _eligible(self, csr: dict) -> bool:
        spec = csr.get("spec") or {}
        if spec.get("signerName") != SIGNER_KUBELET_CLIENT:
            return False
        groups = set(spec.get("groups") or [])
        username = spec.get("username", "")
        return bool(groups & set(NODE_GROUPS)) \
            or username.startswith("system:node:")

    def sync(self, key: str) -> None:
        res = self.client.resource("certificatesigningrequests", None)
        try:
            csr = res.get(key)
        except ApiError as e:
            if e.code == 404:
                return
            raise
        if _is_approved(csr) or _is_denied(csr) or not self._eligible(csr):
            return
        status = csr.setdefault("status", {})
        status.setdefault("conditions", []).append(
            {"type": "Approved", "status": "True",
             "reason": "AutoApproved",
             "message": "Auto approving kubelet client certificate after "
                        "SubjectAccessReview.",
             "lastUpdateTime": rfc3339_now()})
        try:
            res.update_status(csr)
        except ApiError as e:
            if e.code not in (404, 409):
                raise


class CSRCleanerController(Controller):
    """Garbage-collect finished or stale CSRs (cleaner.go: issued ones
    after 1h, denied/failed after 1h, unresolved after 24h; one tick
    interval here for all, configurable)."""

    name = "csrcleaner"
    workers = 1
    tick_interval = 60.0

    def __init__(self, client, issued_ttl: float = 3600.0,
                 stale_ttl: float = 24 * 3600.0):
        super().__init__(client)
        self.issued_ttl = issued_ttl
        self.stale_ttl = stale_ttl

    def register(self, factory: InformerFactory) -> None:
        self.csr_informer = factory.informer("certificatesigningrequests",
                                             None)

    @staticmethod
    def _age(csr: dict) -> float:
        created = (csr.get("metadata") or {}).get("creationTimestamp")
        try:
            return time.time() - float(created)
        except (TypeError, ValueError):
            return 0.0

    def _expired(self, csr: dict) -> bool:
        age = self._age(csr)
        status = csr.get("status") or {}
        finished = (status.get("certificate") or _is_denied(csr)
                    or any(c.get("type") == "Failed"
                           for c in status.get("conditions") or []))
        if finished:
            return age > self.issued_ttl
        return age > self.stale_ttl

    def tick(self) -> None:
        res = self.client.resource("certificatesigningrequests", None)
        for csr in self.csr_informer.store.list():
            if self._expired(csr):
                try:
                    res.delete((csr.get("metadata") or {}).get("name", ""))
                except ApiError as e:
                    if e.code != 404:
                        raise

    def sync(self, key: str) -> None:
        pass  # purely tick-driven
