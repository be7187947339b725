"""ClusterRole aggregation controller.

Reference: ``pkg/controller/clusterroleaggregation/clusterroleaggregation_
controller.go``: a ClusterRole carrying ``aggregationRule.
clusterRoleSelectors`` gets its ``rules`` REPLACED by the union of rules
from every ClusterRole matching any selector (this is how admin/edit/view
absorb CRD permission grants labeled ``rbac.authorization.k8s.io/
aggregate-to-admin`` etc.).
"""

from __future__ import annotations

import json

from kubernetes_tpu_torch.api.policy import _matches
from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.controllers.base import Controller


class ClusterRoleAggregationController(Controller):
    name = "clusterroleaggregation"
    workers = 1

    def register(self, factory: InformerFactory) -> None:
        self.role_informer = factory.informer("clusterroles", None)
        self.role_informer.add_event_handler(self._on_role)

    def _on_role(self, type_, obj, old) -> None:
        # any labeled-role change can feed any aggregating role: enqueue
        # every aggregator (upstream enqueues all on each change too)
        for role in self.role_informer.store.list():
            if (role.get("aggregationRule") or {}).get("clusterRoleSelectors"):
                self.enqueue(role)

    def sync(self, key: str) -> None:
        res = self.client.resource("clusterroles", None)
        try:
            role = res.get(key)
        except ApiError as e:
            if e.code == 404:
                return
            raise
        selectors = (role.get("aggregationRule") or {}).get(
            "clusterRoleSelectors") or []
        if not selectors:
            return
        rules: list[dict] = []
        seen: set[str] = set()
        for other in sorted(self.role_informer.store.list(),
                            key=lambda r: (r.get("metadata") or {})
                            .get("name", "")):
            omd = other.get("metadata") or {}
            if omd.get("name") == key:
                continue
            labels = omd.get("labels") or {}
            if not any(_matches(sel, labels) for sel in selectors):
                continue
            for rule in other.get("rules") or []:
                fp = json.dumps(rule, sort_keys=True)
                if fp not in seen:
                    seen.add(fp)
                    rules.append(rule)
        if role.get("rules") == rules:
            return
        role["rules"] = rules
        try:
            res.update(role)
        except ApiError as e:
            if e.code not in (404, 409):
                raise
