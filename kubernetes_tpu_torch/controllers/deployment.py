"""Deployment controller — declarative rollouts over ReplicaSets.

Reference: ``pkg/controller/deployment/deployment_controller.go``
(``syncDeployment``) + ``sync.go`` (``getNewReplicaSet`` keyed by
pod-template-hash) + ``rolling.go`` (``reconcileNewReplicaSet`` /
``reconcileOldReplicaSets`` honoring maxSurge/maxUnavailable).
"""

from __future__ import annotations

import hashlib
import json

from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.controllers.base import (
    Controller,
    is_controlled_by,
    owner_reference,
    split_key,
)

HASH_LABEL = "pod-template-hash"


def template_hash(dep: dict) -> str:
    """Stable content hash of .spec.template (ComputeHash analog)."""
    tpl = (dep.get("spec") or {}).get("template") or {}
    blob = json.dumps(tpl, sort_keys=True).encode()
    return hashlib.sha1(blob).hexdigest()[:10]


def _resolve_bound(value, total: int, round_up: bool) -> int:
    """intstr percentage resolution (intstr.GetScaledValueFromIntOrPercent)."""
    if isinstance(value, str) and value.endswith("%"):
        frac = int(value[:-1]) / 100.0 * total
        return int(-(-frac // 1)) if round_up else int(frac)
    return int(value)


class DeploymentController(Controller):
    name = "deployment"

    def register(self, factory: InformerFactory) -> None:
        self.dep_informer = factory.informer("deployments", None)
        self.dep_informer.add_event_handler(self.handler())
        self.rs_informer = factory.informer("replicasets", None)
        self.rs_informer.add_event_handler(
            self.handler(lambda obj: self.enqueue_owner(obj, "Deployment")))

    # ---- syncDeployment --------------------------------------------------

    def _owned_rs(self, dep: dict) -> list[dict]:
        ns = (dep.get("metadata") or {}).get("namespace", "")
        return [rs for rs in self.rs_informer.store.list()
                if (rs.get("metadata") or {}).get("namespace", "") == ns
                and is_controlled_by(rs, dep)]

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        dep = self.dep_informer.store.get(key)
        if dep is None or (dep.get("metadata") or {}).get("deletionTimestamp"):
            return
        spec = dep.get("spec") or {}
        replicas = int(spec.get("replicas", 1))
        h = template_hash(dep)
        owned = self._owned_rs(dep)
        new_rs = next((rs for rs in owned
                       if ((rs.get("metadata") or {}).get("labels") or {})
                       .get(HASH_LABEL) == h), None)
        old_rses = [rs for rs in owned if rs is not new_rs]

        rs_api = self.client.resource("replicasets", ns)
        if new_rs is None:
            new_rs = rs_api.create(self._new_rs(dep, h, replicas=0))

        strategy = spec.get("strategy") or {}
        if strategy.get("type") == "Recreate":
            self._recreate(dep, new_rs, old_rses, replicas)
        else:
            self._rolling(dep, new_rs, old_rses, replicas, strategy)
        self._update_status(dep, [new_rs] + old_rses)

    def _new_rs(self, dep: dict, h: str, replicas: int) -> dict:
        tpl = json.loads(json.dumps((dep.get("spec") or {}).get("template") or {}))
        tpl.setdefault("metadata", {}).setdefault("labels", {})[HASH_LABEL] = h
        sel = json.loads(json.dumps((dep.get("spec") or {}).get("selector") or {}))
        sel.setdefault("matchLabels", {})[HASH_LABEL] = h
        md = dep.get("metadata") or {}
        return {
            "apiVersion": "apps/v1",
            "kind": "ReplicaSet",
            "metadata": {
                "name": f"{md.get('name', 'x')}-{h}",
                "namespace": md.get("namespace", "default"),
                "labels": {**(tpl.get("metadata", {}).get("labels") or {})},
                "ownerReferences": [owner_reference({**dep, "apiVersion": "apps/v1"},
                                                    "Deployment")],
            },
            "spec": {"replicas": replicas, "selector": sel, "template": tpl},
            "status": {},
        }

    def _scale_rs(self, rs: dict, replicas: int) -> dict:
        if int((rs.get("spec") or {}).get("replicas", 0)) == replicas:
            return rs
        obj = json.loads(json.dumps(rs))
        obj["spec"]["replicas"] = replicas
        ns = obj["metadata"].get("namespace")
        try:
            return self.client.resource("replicasets", ns).update(obj)
        except ApiError as e:
            if e.code == 409:
                raise  # requeue with backoff; informer will deliver fresh rv
            raise

    def _recreate(self, dep, new_rs, old_rses, replicas) -> None:
        # scale all old to 0; only when their pods are gone scale new up
        for rs in old_rses:
            self._scale_rs(rs, 0)
        if any(int((rs.get("status") or {}).get("replicas", 0)) > 0
               for rs in old_rses):
            raise RuntimeError("waiting for old replicas to terminate")  # requeue
        self._scale_rs(new_rs, replicas)

    def _rolling(self, dep, new_rs, old_rses, replicas, strategy) -> None:
        ru = strategy.get("rollingUpdate") or {}
        max_surge = _resolve_bound(ru.get("maxSurge", "25%"), replicas, round_up=True)
        max_unavail = _resolve_bound(ru.get("maxUnavailable", "25%"), replicas,
                                     round_up=False)
        if max_surge == 0 and max_unavail == 0:
            max_unavail = 1  # validation upstream forbids both-zero; be safe

        def spec_n(rs): return int((rs.get("spec") or {}).get("replicas", 0))
        def ready_n(rs): return int((rs.get("status") or {}).get("readyReplicas", 0))

        total = spec_n(new_rs) + sum(spec_n(rs) for rs in old_rses)
        # reconcileNewReplicaSet (rolling.go): above spec -> scale straight
        # down to spec (covers `ktpu scale` lowering replicas mid/post
        # rollout); below -> grow up to replicas + surge - total.
        if spec_n(new_rs) > replicas:
            new_rs = self._scale_rs(new_rs, replicas)
        else:
            grow = min(replicas - spec_n(new_rs), replicas + max_surge - total)
            if grow > 0:
                new_rs = self._scale_rs(new_rs, spec_n(new_rs) + grow)
        # reconcileOldReplicaSets: shrink old while staying above min-available
        ready_total = ready_n(new_rs) + sum(ready_n(rs) for rs in old_rses)
        can_remove = ready_total - (replicas - max_unavail)
        for rs in sorted(old_rses, key=spec_n, reverse=True):
            if can_remove <= 0:
                break
            cut = min(spec_n(rs), can_remove)
            if cut > 0:
                self._scale_rs(rs, spec_n(rs) - cut)
                can_remove -= cut
        # garbage-collect fully scaled-down, fully drained old RSes beyond
        # revisionHistoryLimit (simplified: always keep them at 0, like
        # upstream with default limit 10 — deletion left to GC/explicit)

    def _update_status(self, dep: dict, rses: list[dict]) -> None:
        def n(rs, f): return int((rs.get("status") or {}).get(f, 0))
        status = {
            "replicas": sum(n(rs, "replicas") for rs in rses),
            "readyReplicas": sum(n(rs, "readyReplicas") for rs in rses),
            "availableReplicas": sum(n(rs, "availableReplicas") for rs in rses),
            "updatedReplicas": n(rses[0], "replicas"),
            "observedGeneration": (dep.get("metadata") or {}).get("generation", 0),
        }
        if dep.get("status") != status:
            try:
                self.client.resource("deployments",
                                     dep["metadata"].get("namespace")) \
                    .update_status({**dep, "status": status})
            except ApiError as e:
                if e.code not in (404, 409):
                    raise
