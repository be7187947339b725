"""Root-CA publisher — kube-root-ca.crt in every namespace.

Reference: ``pkg/controller/certificates/rootcacertpublisher``: every
namespace gets (and keeps) a ``kube-root-ca.crt`` ConfigMap carrying the
cluster CA bundle so workloads can verify the apiserver; deletions and
drift are healed on the next sync. The CA pem comes from the cluster CA
(controllers/certificates.py ClusterCA) or any caller-supplied bundle.
"""

from __future__ import annotations

from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.controllers.base import Controller

CONFIGMAP_NAME = "kube-root-ca.crt"


class RootCAPublisher(Controller):
    name = "root-ca-cert-publisher"
    workers = 1

    def __init__(self, client, ca_pem: str = ""):
        super().__init__(client)
        if not ca_pem:
            from cryptography.hazmat.primitives import serialization
            from kubernetes_tpu_torch.controllers.certificates import generate_ca
            cert, _key = generate_ca()
            ca_pem = cert.public_bytes(serialization.Encoding.PEM).decode()
        self.ca_pem = ca_pem

    def register(self, factory: InformerFactory) -> None:
        self.ns_informer = factory.informer("namespaces", None)
        self.ns_informer.add_event_handler(self.handler())
        self.cm_informer = factory.informer("configmaps", None)
        self.cm_informer.add_event_handler(self._on_configmap)

    def _on_configmap(self, type_, obj, old) -> None:
        md = obj.get("metadata") or {}
        if md.get("name") == CONFIGMAP_NAME:
            # deleted or drifted bundle: re-enqueue the namespace to heal
            self.queue.add(md.get("namespace", "default"))

    def sync(self, key: str) -> None:
        ns = key.split("/")[-1]
        cms = self.client.resource("configmaps", ns)
        want = {"ca.crt": self.ca_pem}
        try:
            cm = cms.get(CONFIGMAP_NAME)
            if cm.get("data") == want:
                return
            cm["data"] = want
            cms.update(cm)  # ktpu-lint: disable=KTL006 -- reconcile, not status publish: failures must RAISE so the workqueue requeues; the best-effort upsert would swallow them
        except ApiError as e:
            if e.code != 404:
                raise
            try:
                # ktpu-lint: disable=KTL006 -- reconcile, not status publish: non-409 failures must RAISE so the workqueue requeues; the best-effort upsert would swallow them
                cms.create({"kind": "ConfigMap",
                            "metadata": {"name": CONFIGMAP_NAME,
                                         "namespace": ns},
                            "data": want})
            except ApiError as e2:
                if e2.code != 409:
                    raise
