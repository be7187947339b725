"""Volume scheduling — PVC/PV topology compiled to node-selector constraints.

The port's copy of ``kubernetes_tpu/sched/volumebinding.py``: the
compiler that the encoder calls, and the binder (Reserve/PreBind) that the
connected runner calls before a pod's binding.

Reference semantics, plugin by plugin:
  VolumeBinding      framework/plugins/volumebinding/volume_binding.go
                     (+ FindPodVolumes in volume/scheduling/scheduler_binder.go):
                     bound PVs constrain the pod to nodes matching the PV's
                     nodeAffinity; unbound PVCs need a matching unbound PV
                     whose affinity matches, or dynamic provisioning.
  VolumeZone         framework/plugins/volumezone/volume_zone.go: a PV's
                     zone/region labels must match the node's.
  VolumeRestrictions framework/plugins/volumerestrictions/: ReadWriteOncePod
                     claims exclude every other pod; single-attach volumes
                     conflict per node.
  NodeVolumeLimits   framework/plugins/nodevolumelimits/csi.go: count of
                     attachable volumes on the node vs its reported limit.

Every constraint above is *node-selector-shaped*, so the compiler below
emits per-PVC **groups of NodeSelectorTerms** — within a group OR (any
candidate PV works), across groups AND (every PVC must be satisfied) — and
the filter evaluates them with the same eval_term_set that NodeAffinity
uses (ops/filters.volume_mask). No per-node Go loop survives.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from kubernetes_tpu_torch.api.resource import canonical
from kubernetes_tpu_torch.api.selectors import (
    node_fields,
    node_selector_matches,
)
from kubernetes_tpu_torch.api.types import (
    OP_EXISTS,
    OP_IN,
    NodeSelectorTerm,
    Pod,
    Requirement,
)

ZONE_LABELS = ("topology.kubernetes.io/zone", "topology.kubernetes.io/region",
               "failure-domain.beta.kubernetes.io/zone",
               "failure-domain.beta.kubernetes.io/region")
SELECTED_NODE_ANNOTATION = "volume.kubernetes.io/selected-node"
WAIT_FOR_FIRST_CONSUMER = "WaitForFirstConsumer"

# a term that matches every node: metadata.name always exists
MATCH_ALL_TERM = NodeSelectorTerm(match_fields=[
    Requirement("metadata.name", OP_EXISTS)])


@dataclass
class VolumeCatalog:
    """Indexed PVC/PV/StorageClass state (the informer caches' view)."""

    pvcs: dict[tuple[str, str], dict] = field(default_factory=dict)  # (ns,name)
    pvs: dict[str, dict] = field(default_factory=dict)               # name
    storage_classes: dict[str, dict] = field(default_factory=dict)   # name

    @classmethod
    def from_lists(cls, pvcs=(), pvs=(), storage_classes=()) -> "VolumeCatalog":
        return cls(
            pvcs={((p.get("metadata") or {}).get("namespace", "default"),
                   (p.get("metadata") or {}).get("name", "")): p for p in pvcs},
            pvs={(p.get("metadata") or {}).get("name", ""): p for p in pvs},
            storage_classes={(s.get("metadata") or {}).get("name", ""): s
                             for s in storage_classes},
        )

    def empty(self) -> bool:
        return not self.pvcs and not self.pvs


@dataclass
class PodVolumeInfo:
    """Compiled volume constraints for one pod."""

    # One group per PVC: OR over the group's terms, AND across groups.
    # A group with zero terms is unsatisfiable (pod stays pending).
    groups: list[list[NodeSelectorTerm]] = field(default_factory=list)
    rwo_pv_names: list[str] = field(default_factory=list)  # node-exclusive PVs
    attach_count: int = 0
    # PVC names that still need binding once a node is chosen (Reserve/PreBind)
    claims_to_bind: list[str] = field(default_factory=list)


def _pv_terms(pv: dict) -> list[NodeSelectorTerm]:
    """A PV's reachable-nodes constraint: spec.nodeAffinity.required terms
    AND-folded with its zone/region labels (VolumeZone)."""
    req = (((pv.get("spec") or {}).get("nodeAffinity") or {})
           .get("required") or {})
    terms = [NodeSelectorTerm.from_dict(t)
             for t in req.get("nodeSelectorTerms") or []]
    zone_reqs = []
    for lbl in ZONE_LABELS:
        v = ((pv.get("metadata") or {}).get("labels") or {}).get(lbl)
        if v is not None:
            # VolumeZone: comma-separated value set -> In
            zone_reqs.append(Requirement(lbl, OP_IN, sorted(v.split("__")
                                                            if "__" in v
                                                            else v.split(","))))
    if not terms:
        terms = [MATCH_ALL_TERM] if not zone_reqs else [NodeSelectorTerm()]
    if zone_reqs:
        terms = [NodeSelectorTerm(
            match_expressions=list(t.match_expressions) + zone_reqs,
            match_fields=list(t.match_fields)) for t in terms]
    return terms


def _pv_capacity(pv: dict) -> int:
    cap = ((pv.get("spec") or {}).get("capacity") or {}).get("storage", 0)
    return canonical("storage", cap)


def _pvc_request(pvc: dict) -> int:
    req = ((((pvc.get("spec") or {}).get("resources") or {})
            .get("requests")) or {}).get("storage", 0)
    return canonical("storage", req)


def _access_modes(obj: dict) -> set[str]:
    return set((obj.get("spec") or {}).get("accessModes") or [])


def _pv_available(pv: dict, pvc_key: tuple[str, str]) -> bool:
    """Unbound, or already reserved for exactly this claim."""
    ref = (pv.get("spec") or {}).get("claimRef")
    if not ref:
        return True
    return (ref.get("namespace", "default"), ref.get("name", "")) == pvc_key


def find_matching_pvs(pvc: dict, catalog: VolumeCatalog) -> list[dict]:
    """FindMatchingVolume (pkg/volume/persistentvolume/util.go): capacity,
    access modes, storage class; smallest-first preference is applied by the
    binder, not the filter."""
    pvc_key = ((pvc.get("metadata") or {}).get("namespace", "default"),
               (pvc.get("metadata") or {}).get("name", ""))
    want_modes = _access_modes(pvc)
    want_cap = _pvc_request(pvc)
    sc = (pvc.get("spec") or {}).get("storageClassName", "") or ""
    out = []
    for pv in catalog.pvs.values():
        if (pv.get("status") or {}).get("phase") in ("Released", "Failed"):
            continue
        if not _pv_available(pv, pvc_key):
            continue
        if ((pv.get("spec") or {}).get("storageClassName", "") or "") != sc:
            continue
        if want_modes - _access_modes(pv):
            continue
        if _pv_capacity(pv) < want_cap:
            continue
        out.append(pv)
    return sorted(out, key=_pv_capacity)  # smallest fitting first


def _is_provisionable(pvc: dict, catalog: VolumeCatalog) -> bool:
    sc_name = (pvc.get("spec") or {}).get("storageClassName", "") or ""
    sc = catalog.storage_classes.get(sc_name)
    return bool(sc and sc.get("provisioner"))


def _pvc_bound_pv(pvc: dict) -> str:
    return (pvc.get("spec") or {}).get("volumeName", "") or ""


def _node_exclusive(obj: dict) -> bool:
    """RWO/RWOP volumes attach to one node at a time (the conflict the
    VolumeRestrictions filter guards)."""
    modes = _access_modes(obj)
    return bool(modes & {"ReadWriteOnce", "ReadWriteOncePod"})


def compile_pod_volumes(pod: Pod, catalog: Optional[VolumeCatalog],
                        in_use_rwop: Optional[set[str]] = None) -> PodVolumeInfo:
    """-> PodVolumeInfo; upstream's FindPodVolumes decomposed into
    selector-term groups. ``in_use_rwop`` = PV names claimed ReadWriteOncePod
    by other live pods (conflict = unschedulable anywhere)."""
    info = PodVolumeInfo()
    if catalog is None:
        return info
    ns = pod.metadata.namespace
    for claim in pod.pvc_names():
        pvc = catalog.pvcs.get((ns, claim))
        if pvc is None:
            info.groups.append([])  # missing PVC: unschedulable (wait)
            continue
        bound = _pvc_bound_pv(pvc)
        if bound:
            pv = catalog.pvs.get(bound)
            if pv is None:
                info.groups.append([])
                continue
            if "ReadWriteOncePod" in _access_modes(pvc) and \
                    in_use_rwop and bound in in_use_rwop:
                info.groups.append([])  # claim already in use by another pod
                continue
            info.groups.append(_pv_terms(pv))
            info.attach_count += 1
            if _node_exclusive(pvc) or _node_exclusive(pv):
                info.rwo_pv_names.append(bound)
            continue
        # unbound PVC
        candidates = find_matching_pvs(pvc, catalog)
        if candidates:
            terms = [t for pv in candidates for t in _pv_terms(pv)]
            info.groups.append(terms)
            info.claims_to_bind.append(claim)
            info.attach_count += 1
            if _node_exclusive(pvc):
                # whichever PV binds is exclusive, but its identity is
                # node-dependent; conflicts materialize post-bind
                pass
            continue
        if _is_provisionable(pvc, catalog):
            sc = catalog.storage_classes.get(
                (pvc.get("spec") or {}).get("storageClassName", "") or "")
            info.groups.append([MATCH_ALL_TERM])
            info.claims_to_bind.append(claim)
            info.attach_count += 1
            continue
        info.groups.append([])  # nothing matches, nothing provisions: wait
    return info


def cluster_volume_state(bound_pods: list[Pod], catalog: Optional[VolumeCatalog]
                         ) -> tuple[dict[str, list[str]], dict[str, int], set[str]]:
    """-> (rwo PVs in use per node, attach counts per node, RWOP PVs in use).

    Feeds ClusterTensors: the node side of VolumeRestrictions + NodeVolumeLimits.
    """
    per_node_rwo: dict[str, list[str]] = {}
    per_node_attach: dict[str, int] = {}
    rwop_in_use: set[str] = set()
    if catalog is None:
        return per_node_rwo, per_node_attach, rwop_in_use
    for p in bound_pods:
        node = p.spec.node_name
        if not node:
            continue
        for claim in p.pvc_names():
            pvc = catalog.pvcs.get((p.metadata.namespace, claim))
            if pvc is None:
                continue
            bound = _pvc_bound_pv(pvc)
            if not bound:
                continue
            pv = catalog.pvs.get(bound, {})
            per_node_attach[node] = per_node_attach.get(node, 0) + 1
            if _node_exclusive(pvc) or _node_exclusive(pv):
                per_node_rwo.setdefault(node, []).append(bound)
            if "ReadWriteOncePod" in _access_modes(pvc):
                rwop_in_use.add(bound)
    return per_node_rwo, per_node_attach, rwop_in_use


def node_attach_limit(node_allocatable: dict[str, Any]) -> int:
    """NodeVolumeLimits: sum of attachable-volumes-* allocatable entries
    (csi.go reads CSINode; kubelet reports them as node allocatable)."""
    total = 0
    found = False
    for k, v in node_allocatable.items():
        if k.startswith("attachable-volumes-"):
            total += int(canonical("pods", v))
            found = True
    return total if found else -1  # -1 = unlimited


class VolumeBinder:
    """Reserve/PreBind: bind unbound PVCs once a node is chosen.

    Reference: volume_binding.go Reserve (AssumePodVolumes) + PreBind
    (BindPodVolumes). Static PVs get claimRef/volumeName set; provisionable
    claims get the selected-node annotation for an external provisioner
    (pkg/controller/volume/persistentvolume/pv_controller.go analog lives in
    controllers/pvprovisioner.py).
    """

    def __init__(self, client):
        self.client = client

    def bind_pod_volumes(self, pod: Pod, node: "Any", catalog: VolumeCatalog,
                         node_labels: dict[str, str], node_name: str) -> bool:
        ns = pod.metadata.namespace
        ok = True
        for claim in pod.pvc_names():
            pvc = catalog.pvcs.get((ns, claim))
            if pvc is None or _pvc_bound_pv(pvc):
                continue
            chosen = None
            for pv in find_matching_pvs(pvc, catalog):
                if self._pv_matches_node(pv, node_labels, node_name):
                    chosen = pv
                    break
            try:
                if chosen is not None:
                    self._bind_static(pvc, chosen)
                elif _is_provisionable(pvc, catalog):
                    self._annotate_selected_node(pvc, node_name)
                else:
                    ok = False
            except Exception:  # ktpu-lint: disable=KTL002 -- provision-plugin failure = bind verdict False; the scheduler requeues the pod with backoff
                ok = False
        return ok

    @staticmethod
    def _pv_matches_node(pv: dict, node_labels: dict[str, str],
                         node_name: str) -> bool:
        terms = _pv_terms(pv)
        return node_selector_matches(terms, node_labels, node_fields(node_name))

    def _bind_static(self, pvc: dict, pv: dict) -> None:
        md = pvc["metadata"]
        pv = dict(pv)
        pv["spec"] = {**(pv.get("spec") or {}),
                      "claimRef": {"kind": "PersistentVolumeClaim",
                                   "namespace": md.get("namespace", "default"),
                                   "name": md["name"], "uid": md.get("uid", "")}}
        pv["status"] = {**(pv.get("status") or {}), "phase": "Bound"}
        self.client.resource("persistentvolumes", None).update(pv)
        pvc = dict(pvc)
        pvc["spec"] = {**(pvc.get("spec") or {}),
                       "volumeName": pv["metadata"]["name"]}
        pvc["status"] = {**(pvc.get("status") or {}), "phase": "Bound"}
        self.client.resource("persistentvolumeclaims",
                             md.get("namespace", "default")).update(pvc)

    def _annotate_selected_node(self, pvc: dict, node_name: str) -> None:
        pvc = dict(pvc)
        md = dict(pvc.get("metadata") or {})
        ann = dict(md.get("annotations") or {})
        if ann.get(SELECTED_NODE_ANNOTATION) == node_name:
            return
        ann[SELECTED_NODE_ANNOTATION] = node_name
        md["annotations"] = ann
        pvc["metadata"] = md
        self.client.resource("persistentvolumeclaims",
                             md.get("namespace", "default")).update(pvc)
