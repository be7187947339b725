"""Route controller — cloud routes for node pod CIDRs.

Reference: ``staging/src/k8s.io/cloud-provider/controllers/route``
(``reconcile``: CreateRoute for every node's podCIDR, DeleteRoute for
routes whose node is gone, then flip the node's NetworkUnavailable
condition to False — kubelets refuse pods until that happens). The cloud
route table is an in-process dict; the node-condition side effect is the
part the rest of the cluster observes.
"""

from __future__ import annotations

import threading

from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.controllers.base import Controller
from kubernetes_tpu_torch.utils.clock import rfc3339_now

RECONCILE_KEY = "_routes"


class RouteController(Controller):
    name = "route"
    workers = 1

    def __init__(self, client):
        super().__init__(client)
        self.routes: dict[str, str] = {}  # node -> cidr (the cloud table)
        self._lock = threading.Lock()

    def register(self, factory: InformerFactory) -> None:
        self.node_informer = factory.informer("nodes", None)
        self.node_informer.add_event_handler(
            lambda *_a: self.queue.add(RECONCILE_KEY))

    def sync(self, key: str) -> None:
        nodes = {(n.get("metadata") or {}).get("name", ""): n
                 for n in self.node_informer.store.list()}
        with self._lock:
            # delete routes for vanished nodes or changed CIDRs
            for name in [n for n, cidr in self.routes.items()
                         if (n not in nodes
                             or (nodes[n].get("spec") or {})
                             .get("podCIDR", "") != cidr)]:
                del self.routes[name]
            created = []
            for name, node in nodes.items():
                cidr = (node.get("spec") or {}).get("podCIDR", "")
                if cidr and self.routes.get(name) != cidr:
                    self.routes[name] = cidr  # CreateRoute
                    created.append(name)
        res = self.client.resource("nodes", None)
        for name in created:
            ok = False
            try:
                node = res.get(name)
                st = node.setdefault("status", {})
                conds = [c for c in st.get("conditions") or []
                         if c.get("type") != "NetworkUnavailable"]
                conds.append({"type": "NetworkUnavailable",
                              "status": "False",
                              "reason": "RouteCreated",
                              "message": "RouteController created a route",
                              "lastTransitionTime": rfc3339_now()})
                st["conditions"] = conds
                res.update_status(node)
                ok = True
            except ApiError as e:
                if e.code == 404:
                    continue  # node gone; the delete pass reaps the route
            if not ok:
                # the condition flip is the externally-observable half of
                # CreateRoute: un-record the route so the requeue retries
                # it (a 409 against a heartbeat would otherwise leave the
                # node NetworkUnavailable forever)
                with self._lock:
                    self.routes.pop(name, None)
                self.queue.add(RECONCILE_KEY)
