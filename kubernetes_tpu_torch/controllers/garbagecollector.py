"""Garbage collector — cascade-delete orphans via ownerReferences.

Reference: ``pkg/controller/garbagecollector/garbagecollector.go`` (uid →
object dependency graph from informers; ``attemptToDeleteItem`` removes
objects whose owners are all gone; blockOwnerDeletion/foreground handled via
finalizers — here only the background-cascade core).
"""

from __future__ import annotations

from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.store.apiserver import ALL_RESOURCES

# kinds tracked in the ownership graph (plural -> kind, namespaced)
GC_RESOURCES = ("pods", "replicasets", "deployments", "statefulsets",
                "daemonsets", "jobs", "cronjobs", "endpoints",
                "endpointslices", "serviceaccounts", "secrets", "resourceclaims",
                "replicationcontrollers")


class GarbageCollector:
    """Periodic mark-and-sweep over informer caches: any object with
    ownerReferences whose referenced uids all no longer exist is deleted.
    Runs from the manager's resync tick rather than a workqueue — the graph
    is global, not per-key."""

    name = "garbagecollector"

    def __init__(self, client):
        self.client = client
        self._informers = {}

    def register(self, factory: InformerFactory) -> None:
        for plural in GC_RESOURCES:
            self._informers[plural] = factory.informer(plural, None)

    def _dependents_of(self, uid: str) -> list[tuple[str, dict]]:
        out = []
        for plural, inf in self._informers.items():
            for obj in inf.store.list():
                if any(r.get("uid") == uid for r in
                       (obj.get("metadata") or {})
                       .get("ownerReferences") or []):
                    out.append((plural, obj))
        return out

    def _finish_terminating(self) -> tuple[int, set]:
        """Foreground / orphan propagation (attemptToDeleteItem's finalizer
        half): a TERMINATING owner holding ``foregroundDeletion`` waits for
        its dependents to be deleted first; one holding ``orphan`` gets its
        ownerReferences stripped from dependents. Either finalizer comes
        off once its obligation is met, completing the delete."""
        acted = 0
        orphaning: set = set()
        for plural, inf in self._informers.items():
            kind, namespaced = ALL_RESOURCES[plural]
            for obj in inf.store.list():
                md = obj.get("metadata") or {}
                fins = md.get("finalizers") or []
                if not md.get("deletionTimestamp"):
                    continue
                uid = md.get("uid", "")
                ns = md.get("namespace") if namespaced else None
                res = self.client.resource(plural, ns)
                if "foregroundDeletion" in fins:
                    deps = self._dependents_of(uid)
                    if deps:
                        for dplural, dep in deps:
                            dmd = dep.get("metadata") or {}
                            if dmd.get("deletionTimestamp"):
                                continue  # already going
                            dns = (dmd.get("namespace")
                                   if ALL_RESOURCES[dplural][1] else None)
                            try:
                                self.client.resource(dplural, dns).delete(
                                    dmd.get("name", ""))
                                acted += 1
                            except ApiError as e:
                                if e.code != 404:
                                    raise
                        continue  # finalizer stays until they're gone
                    self._strip_finalizer(res, obj, "foregroundDeletion")
                    acted += 1
                elif "orphan" in fins:
                    orphaning.add(uid)
                    for dplural, dep in self._dependents_of(uid):
                        dmd = dep.get("metadata") or {}
                        refs = [r for r in dmd.get("ownerReferences") or []
                                if r.get("uid") != uid]
                        dep2 = {**dep, "metadata": {**dmd,
                                                    "ownerReferences": refs}}
                        if not refs:
                            dep2["metadata"].pop("ownerReferences", None)
                        dns = (dmd.get("namespace")
                               if ALL_RESOURCES[dplural][1] else None)
                        try:
                            self.client.resource(dplural, dns).update(dep2)
                        except ApiError as e:
                            if e.code not in (404, 409):
                                raise
                    self._strip_finalizer(res, obj, "orphan")
                    acted += 1
        return acted, orphaning

    @staticmethod
    def _strip_finalizer(res, obj: dict, fin: str) -> None:
        # copy before mutating: ``obj`` is the shared informer-cache entry
        # (every controller on the factory reads it); an in-place strip
        # followed by a swallowed 409 would both corrupt the cache and
        # suppress the next sweep's retry
        md = obj.get("metadata") or {}
        obj2 = {**obj, "metadata": {
            **md, "finalizers": [f for f in md.get("finalizers") or []
                                 if f != fin]}}
        try:
            res.update(obj2)
        except ApiError as e:
            if e.code not in (404, 409):
                raise

    def sweep(self) -> int:
        """One mark-and-sweep pass; returns number of deletions issued."""
        deleted, orphaning = self._finish_terminating()
        live_uids = set()
        for inf in self._informers.values():
            for obj in inf.store.list():
                # a PRESENT owner keeps its dependents — even terminating
                # (a custom finalizer may still need them); only the
                # foreground flow deletes dependents of a terminating
                # owner, and it does so explicitly above
                uid = (obj.get("metadata") or {}).get("uid")
                if uid:
                    live_uids.add(uid)
        tracked_kinds = {ALL_RESOURCES[p][0] for p in GC_RESOURCES}
        for plural, inf in self._informers.items():
            kind, namespaced = ALL_RESOURCES[plural]
            for obj in inf.store.list():
                md = obj.get("metadata") or {}
                refs = md.get("ownerReferences") or []
                if not refs:
                    continue
                # Owners of kinds outside the graph (Node, Service, ...) have
                # unknowable liveness here — never treat their dependents as
                # orphaned (upstream deletes only when ALL owners are
                # confirmed gone).
                if any(r.get("kind") not in tracked_kinds for r in refs):
                    continue
                if any(r.get("uid") in live_uids for r in refs):
                    continue
                if any(r.get("uid") in orphaning for r in refs):
                    # the owner is being ORPHANED: its reference strip is
                    # in flight, and this informer copy predates it — the
                    # dependent must survive, not be collected
                    continue
                ns = md.get("namespace") if namespaced else None
                try:
                    # attemptToDeleteItem verifies LIVE before deleting:
                    # the informer copy may predate an ownerReference strip
                    # (an orphaned dependent must never be collected on
                    # stale cache)
                    live = self.client.resource(plural, ns).get(md["name"])
                    live_refs = (live.get("metadata") or {})                         .get("ownerReferences") or []
                    if not live_refs or any(
                            r.get("uid") in live_uids for r in live_refs):
                        continue
                    self.client.resource(plural, ns).delete(md["name"])
                    deleted += 1
                except ApiError as e:
                    if e.code != 404:
                        raise
        return deleted
