"""DaemonSet controller — one pod per eligible node.

Reference: ``pkg/controller/daemon/daemon_controller.go`` (``syncDaemonSet``,
``podsShouldBeOnNode``) and ``util/daemonset_util.go``. Pods are pinned with
a required nodeAffinity ``matchFields metadata.name`` term and flow through
the regular scheduler (the ≥1.12 ScheduleDaemonSetPods behavior), with the
standard auto-added not-ready/unreachable NoExecute tolerations.
"""

from __future__ import annotations

from kubernetes_tpu_torch.api.selectors import (
    label_selector_matches,
    node_fields,
    node_selector_matches,
)
from kubernetes_tpu_torch.api.types import (
    EFFECT_NO_SCHEDULE,
    NodeSelectorTerm,
    Pod,
    Requirement,
    Taint,
    Toleration,
)
from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.controllers.base import (
    Controller,
    active_pods,
    is_controlled_by,
    split_key,
)
from kubernetes_tpu_torch.controllers.replicaset import pod_from_template

# AddOrUpdateDaemonPodTolerations (pkg/controller/daemon/util/daemonset_util.go)
DAEMON_TOLERATIONS = [
    {"key": "node.kubernetes.io/not-ready", "operator": "Exists", "effect": "NoExecute"},
    {"key": "node.kubernetes.io/unreachable", "operator": "Exists", "effect": "NoExecute"},
    {"key": "node.kubernetes.io/unschedulable", "operator": "Exists", "effect": "NoSchedule"},
]


def daemon_pod_for_node(ds: dict, node_name: str) -> dict:
    pod = pod_from_template(ds, kind="DaemonSet")
    spec = pod["spec"]
    aff = spec.setdefault("affinity", {})
    na = aff.setdefault("nodeAffinity", {})
    req = na.setdefault("requiredDuringSchedulingIgnoredDuringExecution", {})
    req["nodeSelectorTerms"] = [{
        "matchFields": [{"key": "metadata.name", "operator": "In",
                         "values": [node_name]}]}]
    tols = list(spec.get("tolerations") or [])
    have = {(t.get("key"), t.get("effect")) for t in tols}
    for t in DAEMON_TOLERATIONS:
        if (t["key"], t["effect"]) not in have:
            tols.append(dict(t))
    spec["tolerations"] = tols
    return pod


class DaemonSetController(Controller):
    name = "daemonset"

    def register(self, factory: InformerFactory) -> None:
        self.ds_informer = factory.informer("daemonsets", None)
        self.ds_informer.add_event_handler(self.handler())
        self.node_informer = factory.informer("nodes", None)
        self.node_informer.add_event_handler(self.handler(self._enqueue_all))
        self.pod_informer = factory.informer("pods", None)
        self.pod_informer.add_event_handler(
            self.handler(lambda obj: self.enqueue_owner(obj, "DaemonSet")))

    def _enqueue_all(self, _obj: dict) -> None:
        # node add/remove re-evaluates every daemonset
        for key in self.ds_informer.store.keys():
            self.queue.add(key)

    # ---- eligibility (nodeShouldRunDaemonPod) ----------------------------

    def _node_eligible(self, ds: dict, node: dict) -> bool:
        tpl_spec = ((ds.get("spec") or {}).get("template") or {}).get("spec") or {}
        labels = (node.get("metadata") or {}).get("labels") or {}
        name = (node.get("metadata") or {}).get("name", "")
        sel = tpl_spec.get("nodeSelector") or {}
        if sel and not all(labels.get(k) == v for k, v in sel.items()):
            return False
        na = ((tpl_spec.get("affinity") or {}).get("nodeAffinity") or {})
        req = (na.get("requiredDuringSchedulingIgnoredDuringExecution") or {})
        terms = [NodeSelectorTerm.from_dict(t)
                 for t in req.get("nodeSelectorTerms") or []]
        if terms and not node_selector_matches(terms, labels, node_fields(name)):
            return False
        # NoSchedule/NoExecute taints must be tolerated (daemon tolerations
        # are auto-added to the pod, so include them here)
        tols = [Toleration.from_dict(t) for t in
                list(tpl_spec.get("tolerations") or []) + DAEMON_TOLERATIONS]
        for td in (node.get("spec") or {}).get("taints") or []:
            taint = Taint.from_dict(td)
            if taint.effect == "PreferNoSchedule":
                continue
            if not any(t.tolerates(taint) for t in tols):
                return False
        return True

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        ds = self.ds_informer.store.get(key)
        if ds is None or (ds.get("metadata") or {}).get("deletionTimestamp"):
            return
        owned = [p for p in self.pod_informer.store.list()
                 if (p.get("metadata") or {}).get("namespace", "") == ns
                 and is_controlled_by(p, ds)]
        by_node: dict[str, list[dict]] = {}
        for p in active_pods(owned):
            n = _pinned_node(p)
            if n:
                by_node.setdefault(n, []).append(p)
            else:
                self._delete(p)  # un-pinned daemon pod is malformed
        pods_api = self.client.pods(ns)
        desired = 0
        ready = 0
        for node in self.node_informer.store.list():
            node_name = (node.get("metadata") or {}).get("name", "")
            eligible = self._node_eligible(ds, node)
            have = by_node.get(node_name, [])
            if eligible:
                desired += 1
                if not have:
                    pods_api.create(daemon_pod_for_node(ds, node_name))
                else:
                    for extra in have[1:]:
                        self._delete(extra)
                    if Pod.from_dict(have[0]).status.is_ready():
                        ready += 1
            else:
                for p in have:
                    self._delete(p)
        # pods pinned to vanished nodes
        node_names = {(n.get("metadata") or {}).get("name", "")
                      for n in self.node_informer.store.list()}
        for n, pods in by_node.items():
            if n not in node_names:
                for p in pods:
                    self._delete(p)
        status = {
            "desiredNumberScheduled": desired,
            "currentNumberScheduled": sum(len(v) for k, v in by_node.items()
                                          if k in node_names),
            "numberReady": ready,
            "observedGeneration": (ds.get("metadata") or {}).get("generation", 0),
        }
        if ds.get("status") != status:
            try:
                self.client.resource("daemonsets", ns).update_status(
                    {**ds, "status": status})
            except ApiError as e:
                if e.code not in (404, 409):
                    raise

    def _delete(self, p: dict) -> None:
        try:
            self.client.pods(p["metadata"].get("namespace", "default")) \
                .delete(p["metadata"]["name"])
        except ApiError as e:
            if e.code != 404:
                raise


def _pinned_node(pod: dict) -> str:
    """Target node of a daemon pod: bound nodeName, else the matchFields pin."""
    spec = pod.get("spec") or {}
    if spec.get("nodeName"):
        return spec["nodeName"]
    na = ((spec.get("affinity") or {}).get("nodeAffinity") or {})
    for term in (na.get("requiredDuringSchedulingIgnoredDuringExecution") or {}) \
            .get("nodeSelectorTerms") or []:
        for mf in term.get("matchFields") or []:
            if mf.get("key") == "metadata.name" and mf.get("values"):
                return mf["values"][0]
    return ""
