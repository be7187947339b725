"""ServiceAccount + token controllers.

Reference: ``pkg/controller/serviceaccount/serviceaccounts_controller.go``
(ensure the ``default`` ServiceAccount exists in every namespace) and
``tokens_controller.go`` (legacy path: mint a
``kubernetes.io/service-account-token`` Secret per ServiceAccount and record
it in ``sa.secrets``). The apiserver's TokenAuthenticator resolves these
secrets into ``system:serviceaccount:<ns>:<name>`` identities
(store/auth.py), closing the loop: create a namespace -> default SA ->
token secret -> authenticated API access for the namespace's workloads.
"""

from __future__ import annotations

import secrets as _secrets

from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.controllers.base import Controller, owner_reference, split_key
from kubernetes_tpu_torch.store.auth import SA_NAME_ANNOTATION, SA_TOKEN_TYPE


class ServiceAccountController(Controller):
    """Every active namespace gets a ``default`` ServiceAccount."""

    name = "serviceaccount"
    workers = 1

    def register(self, factory: InformerFactory) -> None:
        self.ns_informer = factory.informer("namespaces", None)
        self.ns_informer.add_event_handler(self.handler())
        self.sa_informer = factory.informer("serviceaccounts", None)
        # recreate the default SA if somebody deletes it
        self.sa_informer.add_event_handler(self.handler(self._enqueue_ns))

    def _enqueue_ns(self, sa: dict) -> None:
        ns = (sa.get("metadata") or {}).get("namespace", "")
        if ns:
            self.queue.add(ns)

    def sync(self, key: str) -> None:
        if self.ns_informer.store.get(key) is None:
            return  # namespace gone; its contents are being purged
        if self.sa_informer.store.get(f"{key}/default") is not None:
            return
        try:
            self.client.resource("serviceaccounts", key).create({
                "apiVersion": "v1", "kind": "ServiceAccount",
                "metadata": {"name": "default", "namespace": key}})
        except ApiError as e:
            if e.code != 409:
                raise


class TokenController(Controller):
    """Every ServiceAccount gets a token Secret it owns."""

    name = "serviceaccount-token"
    workers = 1

    def register(self, factory: InformerFactory) -> None:
        self.sa_informer = factory.informer("serviceaccounts", None)
        self.sa_informer.add_event_handler(self.handler())
        self.secret_informer = factory.informer("secrets", None)
        self.secret_informer.add_event_handler(
            self.handler(lambda obj: self.enqueue_owner(obj, "ServiceAccount")))

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        sa = self.sa_informer.store.get(key)
        if sa is None:
            return  # GC cascades the owned secret
        secret_name = f"{name}-token"
        existing = self.secret_informer.store.get(f"{ns}/{secret_name}")
        if existing is None:
            secret = {
                "apiVersion": "v1", "kind": "Secret",
                "metadata": {
                    "name": secret_name, "namespace": ns,
                    "annotations": {SA_NAME_ANNOTATION: name},
                    "ownerReferences": [owner_reference(sa, "ServiceAccount")],
                },
                "type": SA_TOKEN_TYPE,
                "data": {"token": f"ktpu-sa-{_secrets.token_hex(16)}"},
            }
            try:
                self.client.resource("secrets", ns).create(secret)
            except ApiError as e:
                if e.code != 409:
                    raise
        if secret_name not in [s.get("name") for s in sa.get("secrets") or []]:
            desired = dict(sa)
            desired["secrets"] = (list(sa.get("secrets") or [])
                                  + [{"name": secret_name}])
            try:
                self.client.resource("serviceaccounts", ns).update(desired)
            except ApiError as e:
                if e.code not in (404, 409):
                    raise
