"""ReplicaSet controller — keep N pod replicas alive.

Reference: ``pkg/controller/replicaset/replica_set.go`` (``syncReplicaSet``:
list matching active pods, adopt via controller-ref, diff against
spec.replicas, batch create/delete, then update status counters).

The port's copy of ``kubernetes_tpu/controllers/replicaset.py``; its
``_owned_pods`` reads the pods whose controller is the ReplicaSet from the
pods informer's ``CONTROLLER_INDEX`` (the same pods as the reference's
walk of the whole cache).
"""

from __future__ import annotations

from kubernetes_tpu_torch.api.selectors import label_selector_matches
from kubernetes_tpu_torch.api.types import LabelSelector, PodStatus
from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.controllers.base import (
    CONTROLLER_INDEX,
    Controller,
    active_pods,
    controller_uid,
    is_controlled_by,
    owner_reference,
    split_key,
)

BURST_REPLICAS = 500  # upstream burstReplicas cap per sync


def pod_from_template(rs: dict, kind: str = "ReplicaSet") -> dict:
    """Materialize a pod from .spec.template with owner ref + generateName."""
    tpl = (rs.get("spec") or {}).get("template") or {}
    md = rs.get("metadata") or {}
    pod = {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "generateName": f"{md.get('name', 'x')}-",
            "namespace": md.get("namespace", "default"),
            "labels": dict((tpl.get("metadata") or {}).get("labels") or {}),
            "ownerReferences": [owner_reference(rs, kind)],
        },
        "spec": dict(tpl.get("spec") or {}),
        "status": {"phase": "Pending"},
    }
    return pod


class ReplicaSetController(Controller):
    name = "replicaset"
    plural = "replicasets"
    kind = "ReplicaSet"

    def __init__(self, client):
        super().__init__(client)
        self.rs_informer = None
        self.pod_informer = None

    def register(self, factory: InformerFactory) -> None:
        self.rs_informer = factory.informer(self.plural, None)
        self.rs_informer.add_event_handler(self.handler())
        self.pod_informer = factory.informer("pods", None)
        self.pod_informer.add_indexers({CONTROLLER_INDEX: controller_uid})
        self.pod_informer.add_event_handler(
            self.handler(lambda obj: self.enqueue_owner(obj, self.kind)))

    def _selector(self, rs: dict):
        return LabelSelector.from_dict((rs.get("spec") or {}).get("selector"))

    # ---- syncReplicaSet --------------------------------------------------

    def _owned_pods(self, rs: dict) -> list[dict]:
        ns = (rs.get("metadata") or {}).get("namespace", "")
        sel = self._selector(rs)
        out = []
        uid = (rs.get("metadata") or {}).get("uid", "")
        for p in self.pod_informer.store.by_index(CONTROLLER_INDEX, uid):
            md = p.get("metadata") or {}
            if md.get("namespace", "") != ns:
                continue
            if not label_selector_matches(sel, md.get("labels") or {}):
                continue
            if is_controlled_by(p, rs):
                out.append(p)
        return out

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        rs = self.rs_informer.store.get(key)
        if rs is None or (rs.get("metadata") or {}).get("deletionTimestamp"):
            return
        owned = self._owned_pods(rs)
        alive = active_pods(owned)
        want = int((rs.get("spec") or {}).get("replicas", 1))
        diff = want - len(alive)
        pods_api = self.client.pods(ns)
        if diff > 0:
            for _ in range(min(diff, BURST_REPLICAS)):
                pods_api.create(pod_from_template(rs, self.kind))
        elif diff < 0:
            # delete highest-cost pods first: unscheduled, then not-ready,
            # then youngest (getPodsToDelete ranking, simplified)
            def rank(p):
                st = PodStatus.from_dict(p.get("status"))
                return (bool((p.get("spec") or {}).get("nodeName")),
                        st.is_ready(),
                        (p.get("metadata") or {}).get("creationTimestamp", 0.0))
            for p in sorted(alive, key=rank)[:min(-diff, BURST_REPLICAS)]:
                try:
                    pods_api = self.client.pods((p["metadata"].get("namespace", ns)))
                    pods_api.delete(p["metadata"]["name"])
                except ApiError as e:
                    if e.code != 404:
                        raise
        self._update_status(rs, alive)

    def _update_status(self, rs: dict, alive: list[dict]) -> None:
        ready = sum(1 for p in alive
                    if PodStatus.from_dict(p.get("status")).is_ready())
        available = ready  # no minReadySeconds tracking
        new_status = {
            "replicas": len(alive),
            "readyReplicas": ready,
            "availableReplicas": available,
            "observedGeneration": (rs.get("metadata") or {}).get("generation", 0),
        }
        if rs.get("status") != new_status:
            obj = {**rs, "status": new_status}
            try:
                self.client.resource(self.plural,
                                     rs["metadata"].get("namespace")).update_status(obj)
            except ApiError as e:
                if e.code not in (404, 409):
                    raise


class ReplicationControllerController(ReplicaSetController):
    """Legacy ReplicationController — same reconcile with v1 semantics.

    Reference: ``pkg/controller/replication`` (a thin adapter over the
    ReplicaSet logic upstream too). RC selectors are plain label MAPS, not
    LabelSelectors, and default to the template's labels when unset.
    """

    name = "replicationcontroller"
    plural = "replicationcontrollers"
    kind = "ReplicationController"

    def _selector(self, rc: dict):
        sel = (rc.get("spec") or {}).get("selector")
        if not sel:
            tpl = ((rc.get("spec") or {}).get("template") or {})
            sel = (tpl.get("metadata") or {}).get("labels") or {}
        return LabelSelector(match_labels=dict(sel))
