"""Namespace lifecycle controller — purge a deleted namespace's contents.

Reference: ``pkg/controller/namespace/namespace_controller.go`` +
``deletion/namespaced_resources_deleter.go``: upstream holds the Namespace
in Terminating behind a finalizer while group-walking every namespaced
resource and deleting the contents. Our store deletes objects immediately,
so the analog runs the same group-walk as a reaction to the Namespace's
DELETED event (content left behind would otherwise be invisible garbage —
the GC only chases ownerReferences). Built on the base workqueue so a
failed purge retries with rate-limited backoff instead of hot-looping.
"""

from __future__ import annotations

from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.controllers.base import Controller
from kubernetes_tpu_torch.store.apiserver import ALL_RESOURCES


class NamespaceController(Controller):
    name = "namespace"
    workers = 1

    def register(self, factory: InformerFactory) -> None:
        self.ns_informer = factory.informer("namespaces", None)

        def on_event(type_, obj, old):
            if type_ == "DELETED":
                self.queue.add((obj.get("metadata") or {}).get("name", ""))
        self.ns_informer.add_event_handler(on_event)

    def sync(self, key: str) -> None:
        # Keys are only enqueued on DELETED; if the namespace reappeared
        # (recreated with the same name) leave its fresh contents alone.
        if self.ns_informer.store.get(key) is not None:
            return
        self.purge(key)

    def purge(self, ns: str) -> None:
        """Delete every namespaced object in ``ns`` (the deleter's
        deleteAllContent group-walk)."""
        for plural, (kind, namespaced) in ALL_RESOURCES.items():
            if not namespaced or plural == "namespaces":
                continue
            handle = self.client.resource(plural, ns)
            try:
                items = handle.list()
            except ApiError:
                continue
            for obj in items:
                md = obj.get("metadata") or {}
                if md.get("namespace", "") != ns:
                    continue
                try:
                    handle.delete(md.get("name", ""))
                except ApiError as e:
                    if e.code != 404:
                        raise
