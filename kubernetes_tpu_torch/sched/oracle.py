"""Oracle scheduler — the serial, readable reference implementation.

Semantics mirror the reference's scheduling cycle
(``pkg/scheduler/schedule_one.go``: ``findNodesThatFitPod`` ->
``prioritizeNodes`` -> ``selectHost``) pod-by-pod over typed API objects. It
exists for three jobs:

1. Parity target: every tensor op in ops/ is tested against it.
2. CPU fallback path: clusters without a TPU run this scheduler.
3. Semantic documentation: this file is the plain-English statement of what
   the fused tensor program computes.

Resource arithmetic uses the SAME scaled integer units as the tensor path
(encode/scaling.py) and scores use float32, so parity is exact, not
approximate. Plugin weights default to the reference's
(pkg/scheduler/apis/config/v1/default_plugins.go).

The PyTorch port's copy of ``kubernetes_tpu/sched/oracle.py``. DRA device
claims fold in through a ``DraCatalog`` (sched/dra.py) as in the reference;
the slice-gang branches run the numpy twin of ``topology/carve.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from kubernetes_tpu_torch.api.selectors import (
    label_selector_matches,
    node_fields,
    node_selector_matches,
)
from kubernetes_tpu_torch.api.types import (
    EFFECT_NO_EXECUTE,
    EFFECT_NO_SCHEDULE,
    EFFECT_PREFER_NO_SCHEDULE,
    NODE_INCLUSION_HONOR,
    NODE_INCLUSION_IGNORE,
    Node,
    NodeSelectorTerm,
    Pod,
    Requirement,
    Taint,
    Toleration,
    TopologySpreadConstraint,
)
from kubernetes_tpu_torch.encode.scaling import UNLIMITED, scale_allocatable, scale_request
from kubernetes_tpu_torch.encode.snapshot import tenant_label_of
from kubernetes_tpu_torch.encode.termprep import (
    affinity_term_selector,
    resolve_term_namespaces,
    spread_selector,
)

UNSCHED_TAINT = Taint(key="node.kubernetes.io/unschedulable", effect=EFFECT_NO_SCHEDULE)

# Reference default plugin score weights (default_plugins.go).
DEFAULT_WEIGHTS = {
    "NodeResourcesFit": 1.0,
    "NodeResourcesBalancedAllocation": 1.0,
    "ImageLocality": 1.0,
    "NodeAffinity": 2.0,
    "TaintToleration": 3.0,
    "PodTopologySpread": 2.0,
    "InterPodAffinity": 2.0,
}

# ImageLocality constants (image_locality.go): mb, minThreshold, maxContainerThreshold.
_MB = 1024 * 1024
IMG_MIN_THRESHOLD = 23 * _MB
IMG_MAX_CONTAINER_THRESHOLD = 1000 * _MB


def tie_break(n: int, seed: int, salt: int = 0) -> int:
    """Deterministic tie-break among max-score nodes: the reference reservoir-
    samples with math/rand (schedule_one.go selectHost); we use a seeded
    multiplicative hash so TPU and oracle agree bit-for-bit. ``salt`` is the
    pod's batch position (ops/scores.select_host uses the same mixing)."""
    s = ((seed + salt) * 2246822519) & 0xFFFFFFFF
    return (((n * 2654435761) & 0xFFFFFFFF) ^ s) & 0x3FFFFFFF


@dataclass
class NodeState:
    node: Node
    allocatable: dict[str, int] = field(default_factory=dict)  # scaled units
    requested: dict[str, int] = field(default_factory=dict)
    pods: list[Pod] = field(default_factory=list)

    @classmethod
    def build(cls, node: Node) -> "NodeState":
        alloc = {r: scale_allocatable(r, q) for r, q in node.allocatable_canonical().items()}
        alloc.setdefault("pods", UNLIMITED)
        return cls(node=node, allocatable=alloc)

    def add_pod(self, pod: Pod):
        self.pods.append(pod)
        for r, q in pod.resource_requests().items():
            self.requested[r] = self.requested.get(r, 0) + scale_request(r, q)

    def remove_pod(self, pod: Pod):
        self.pods = [p for p in self.pods if p.metadata.uid != pod.metadata.uid]
        for r, q in pod.resource_requests().items():
            self.requested[r] = self.requested.get(r, 0) - scale_request(r, q)

    @property
    def labels(self) -> dict[str, str]:
        return self.node.metadata.labels


def tolerates_all(tolerations: list[Toleration], taints: list[Taint],
                  effects: tuple[str, ...]) -> bool:
    for t in taints:
        if t.effect in effects and not any(tol.tolerates(t) for tol in tolerations):
            return False
    return True


class FailReason:
    TENANT = "node(s) belonged to a different tenant"
    UNSCHEDULABLE = "node(s) were unschedulable"
    NODE_NAME = "node(s) didn't match the requested node name"
    RESOURCES = "Insufficient resources"
    AFFINITY = "node(s) didn't match Pod's node affinity/selector"
    TAINT = "node(s) had untolerated taint"
    PORTS = "node(s) didn't have free ports"
    SPREAD = "node(s) didn't satisfy topology spread constraints"
    POD_AFFINITY = "node(s) didn't match pod affinity rules"
    POD_ANTI_AFFINITY = "node(s) didn't satisfy existing pods anti-affinity rules"
    VOLUME = "node(s) had volume node affinity conflict"
    CLAIM = "pod has missing/unresolved ResourceClaims"
    SLICE_UNAVAILABLE = ("node(s) were outside every carveable slice of "
                         "the requested shape")


class OracleScheduler:
    """Serial scheduler over NodeState list. Mutating: ``assume`` folds
    assignments in, mirroring Cache.AssumePod optimism."""

    def __init__(self, nodes: list[Node], bound_pods: Optional[list[Pod]] = None,
                 weights: Optional[dict[str, float]] = None, seed: int = 0,
                 volumes=None, namespace_labels: Optional[dict] = None,
                 dra=None):
        self.states = [NodeState.build(n) for n in nodes]
        self.node_index = {n.metadata.name: i for i, n in enumerate(nodes)}
        # tenant-local tie-break ranks (ops/filters.tenant_local_rank's
        # host twin): node i's rank among ITS TENANT's nodes — arange for
        # single-tenant clusters, so tie-breaks are unchanged there and
        # bit-equal to standalone runs under a fleet
        _tcounts: dict = {}
        self._node_rank: list[int] = []
        for n in nodes:
            t = self._tenant_of(n.metadata.labels)
            r = _tcounts.get(t, 0)
            _tcounts[t] = r + 1
            self._node_rank.append(r)
        self.weights = dict(weights or DEFAULT_WEIGHTS)
        self.seed = seed
        self.volumes = volumes  # VolumeCatalog | None
        self.dra = dra          # sched/dra.DraCatalog | None
        # namespace name -> labels, for namespaceSelector resolution
        # (GetNamespaceLabelsSnapshot analog)
        self.namespace_labels = dict(namespace_labels or {})
        if dra is not None:
            # device slices extend node allocatable as dra:<class> counts —
            # the same synthetic-resource folding the encoder does
            for st in self.states:
                for r, q in dra.node_capacity(st.node.metadata.name).items():
                    st.allocatable[r] = scale_allocatable(r, q)
        # Count of bound pods carrying REQUIRED anti-affinity: the symmetry
        # veto scan in _pod_ctx walks every bound pod on every call, which
        # dominated preemption verification at fleet scale — when no bound
        # pod has such a term (the overwhelmingly common case) the scan is
        # skipped outright. Maintained by every mutation path.
        self._n_anti = 0
        for p in bound_pods or []:
            i = self.node_index.get(p.spec.node_name)
            if i is not None:
                self.states[i].add_pod(p)
                self._fold_demands(self.states[i], p)
                self._n_anti += self._has_required_anti(p)
        from kubernetes_tpu_torch.sched.volumebinding import cluster_volume_state
        self._vol_rwo, self._vol_attach, self._vol_rwop = cluster_volume_state(
            [p for st in self.states for p in st.pods], volumes)
        # topology slice carving (topology/): node coordinates + grid extent
        # for the oracle carver; the per-node SliceCarve explain gate is
        # OPT-IN (the explainer arms it) because preemption's per-node
        # re-filter frees a slice one cell at a time — a default-on gate
        # would veto its own repair
        from kubernetes_tpu_torch.topology.slicing import coords_of_labels, grid_dims
        self._coords = [coords_of_labels(n.metadata.labels) for n in nodes]
        self._dims = grid_dims([c for c in self._coords if c is not None])
        self.slice_explain = False

    @staticmethod
    def _has_required_anti(p: Pod) -> bool:
        aff = p.spec.affinity
        return bool(aff and aff.pod_anti_affinity
                    and aff.pod_anti_affinity.required)

    def _fold_demands(self, st: NodeState, pod: Pod, sign: int = 1):
        """Fold a pod's DRA device demands into the node's requested map."""
        if self.dra is None:
            return
        for r, q in self.dra.pod_demands(pod).items():
            st.requested[r] = st.requested.get(r, 0) + sign * scale_request(r, q)

    def _eff_requests(self, pod: Pod) -> dict:
        reqs = dict(pod.resource_requests())
        if self.dra is not None:
            reqs.update(self.dra.pod_demands(pod))
        return reqs

    def _volume_ok(self, pod: Pod, node: Node, vinfo) -> bool:
        """VolumeBinding/Zone/Restrictions/Limits, serial reference form."""
        from kubernetes_tpu_torch.api.selectors import node_fields, node_selector_matches
        from kubernetes_tpu_torch.sched.volumebinding import node_attach_limit
        name = node.metadata.name
        for group in vinfo.groups:
            if not group:
                return False  # unsatisfiable PVC
            if not node_selector_matches(group, node.metadata.labels,
                                         node_fields(name)):
                return False
        in_use = set(self._vol_rwo.get(name, []))
        if any(pv in in_use for pv in vinfo.rwo_pv_names):
            return False
        limit = node_attach_limit(node.status.allocatable)
        if limit >= 0 and self._vol_attach.get(name, 0) + vinfo.attach_count > limit:
            return False
        return True

    # ---- filters ---------------------------------------------------------

    _tenant_of = staticmethod(tenant_label_of)

    def _filter_one(self, pod: Pod, st: NodeState, ni: int, ctx: dict) -> Optional[str]:
        node = st.node
        # fleet visibility gate, FIRST (mirrors run_filters' validity gate
        # and explain's stack order): a pod only ever sees its own
        # tenant's nodes; untenanted == untenanted passes, so
        # single-tenant clusters are unaffected
        if self._tenant_of(pod.metadata.labels) != self._tenant_of(st.labels):
            return FailReason.TENANT
        if node.spec.unschedulable and not any(
                t.tolerates(UNSCHED_TAINT) for t in pod.spec.tolerations):
            return FailReason.UNSCHEDULABLE
        if pod.spec.node_name and pod.spec.node_name != node.metadata.name:
            return FailReason.NODE_NAME
        sl = ctx.get("slice_ok")
        if sl is not None and not sl[ni]:
            return FailReason.SLICE_UNAVAILABLE
        if self.dra is not None and pod.spec.resource_claims:
            if not self.dra.pod_claims_ready(pod):
                return FailReason.CLAIM  # template-generated claim not yet made
            pin = self.dra.pod_allocated_node(pod)
            if not pod.spec.node_name and pin and pin != node.metadata.name:
                return FailReason.NODE_NAME  # allocated claim pins the pod
        for r, q in self._eff_requests(pod).items():
            need = scale_request(r, q)
            if need > st.allocatable.get(r, 0) - st.requested.get(r, 0):
                return FailReason.RESOURCES
        if not self._node_affinity_ok(pod, node):
            return FailReason.AFFINITY
        if not tolerates_all(pod.spec.tolerations, node.spec.taints,
                             (EFFECT_NO_SCHEDULE, EFFECT_NO_EXECUTE)):
            return FailReason.TAINT
        if self._ports_conflict(pod, st):
            return FailReason.PORTS
        if ctx.get("vol") is not None and not self._volume_ok(pod, node, ctx["vol"]):
            return FailReason.VOLUME
        if not self._spread_ok(st, ctx):
            return FailReason.SPREAD
        r = self._interpod_ok(st, ctx)
        if r is not None:
            return r
        return None

    def _pod_ctx(self, pod: Pod) -> dict:
        """Node-independent precomputation for one pod (the PreFilter analog):
        per-constraint domain counts, affinity pair counts + bootstrap flag,
        and the symmetry veto set. Computed ONCE per pod, not per node."""
        aff = pod.spec.affinity
        pa = aff.pod_affinity if aff else None
        pan = aff.pod_anti_affinity if aff else None
        ns = pod.metadata.namespace
        spread = []
        for sc in pod.spec.topology_spread_constraints:
            if sc.when_unsatisfiable != "DoNotSchedule":
                continue
            eff = spread_selector(sc, pod.metadata.labels)
            counts = self._domain_counts(pod, sc, eff)
            self_match = label_selector_matches(eff, pod.metadata.labels)
            min_count = min(counts.values()) if counts else 0
            # minDomains: fewer eligible domains than required -> the global
            # minimum is treated as 0 (filtering.go minMatchNum).
            if sc.min_domains is not None and len(counts) < sc.min_domains:
                min_count = 0
            spread.append((sc, counts, min_count, self_match))
        aff_counts = []
        self_matches_all = True
        for term in (pa.required if pa else []):
            prep = self._prep_term(term, ns, pod.metadata.labels)
            counts: dict[str, int] = {}
            for st in self.states:
                dv = st.labels.get(term.topology_key)
                if dv is None:
                    continue
                for p in st.pods:
                    if self._prepped_matches(prep, ns, p):
                        counts[dv] = counts.get(dv, 0) + 1
            if not self._prepped_matches(prep, ns, pod):
                self_matches_all = False
            aff_counts.append((term, counts))
        # filtering.go bootstrap: NO term has a matching pair anywhere AND the
        # incoming pod matches ALL its own terms (incl. their namespace sets).
        bootstrap = (bool(aff_counts)
                     and all(not c for _, c in aff_counts)
                     and self_matches_all)
        anti_counts = []
        for term in (pan.required if pan else []):
            prep = self._prep_term(term, ns, pod.metadata.labels)
            counts = {}
            for st in self.states:
                dv = st.labels.get(term.topology_key)
                if dv is None:
                    continue
                for p in st.pods:
                    if self._prepped_matches(prep, ns, p):
                        counts[dv] = counts.get(dv, 0) + 1
            anti_counts.append((term, counts))
        # Symmetry: (topology_key, domain value) pairs where some existing
        # pod's required anti-affinity matches this pod. The term resolves
        # against the EXISTING pod's namespace + labels (it owns the term).
        sym_veto: set[tuple[str, str]] = set()
        for other_st in (self.states if self._n_anti else ()):
            for p in other_st.pods:
                paff = p.spec.affinity
                pananti = paff.pod_anti_affinity if paff else None
                for term in (pananti.required if pananti else []):
                    prep = self._prep_term(
                        term, p.metadata.namespace, p.metadata.labels)
                    if not self._prepped_matches(
                            prep, p.metadata.namespace, pod):
                        continue
                    dv = other_st.labels.get(term.topology_key)
                    if dv is not None:
                        sym_veto.add((term.topology_key, dv))
        from kubernetes_tpu_torch.sched.volumebinding import compile_pod_volumes
        vol = (compile_pod_volumes(pod, self.volumes, self._vol_rwop)
               if self.volumes is not None else None)
        slice_ok = None
        if self.slice_explain:
            shape = self._slice_shape_of(pod)
            if shape is not None:
                from kubernetes_tpu_torch.topology import carve as carve_mod
                slice_ok = carve_mod.covered_nodes(
                    self.oracle_carve([pod], shape, set()),
                    len(self.states))
        return dict(spread=spread, aff=aff_counts, bootstrap=bootstrap,
                    anti=anti_counts, sym=sym_veto, vol=vol,
                    slice_ok=slice_ok)

    def _node_affinity_ok(self, pod: Pod, node: Node) -> bool:
        labels, fields = node.metadata.labels, node_fields(node.metadata.name)
        for k, v in pod.spec.node_selector.items():
            if labels.get(k) != v:
                return False
        aff = pod.spec.affinity
        na = aff.node_affinity if aff else None
        if na and na.required:
            if not node_selector_matches(na.required, labels, fields):
                return False
        return True

    def _ports_conflict(self, pod: Pod, st: NodeState) -> bool:
        used = [hp for p in st.pods for hp in p.host_ports()]
        for (ip, proto, port) in pod.host_ports():
            for (uip, uproto, uport) in used:
                if port == uport and proto == uproto and (
                        ip == uip or ip == "0.0.0.0" or uip == "0.0.0.0"):
                    return True
        return False

    # ---- topology spread -------------------------------------------------

    def _spread_node_eligible(self, pod: Pod, sc: TopologySpreadConstraint,
                              st: NodeState) -> bool:
        """Does this node participate in the constraint's skew computation?
        (common.go: has the topology key + nodeAffinityPolicy [default Honor]
        + nodeTaintsPolicy [default Ignore])."""
        if sc.topology_key not in st.labels:
            return False
        # fleet scoping: a sibling tenant's nodes don't participate in skew
        # or the global minimum (tensor twin: _spread_policy_elig)
        if self._tenant_of(pod.metadata.labels) != self._tenant_of(st.labels):
            return False
        if (sc.node_affinity_policy != NODE_INCLUSION_IGNORE
                and not self._node_affinity_ok(pod, st.node)):
            return False
        if (sc.node_taints_policy == NODE_INCLUSION_HONOR
                and not tolerates_all(pod.spec.tolerations, st.node.spec.taints,
                                      (EFFECT_NO_SCHEDULE, EFFECT_NO_EXECUTE))):
            return False
        return True

    def _domain_counts(self, pod: Pod, sc: TopologySpreadConstraint, eff_sel):
        """Counts per domain value over *eligible* nodes only (see
        ``_spread_node_eligible``); pods on excluded nodes don't count and
        their domains don't participate in the global minimum. Counts include
        only pods matching ``eff_sel`` in the incoming pod's namespace."""
        counts: dict[str, int] = {}
        for st in self.states:
            if not self._spread_node_eligible(pod, sc, st):
                continue
            dv = st.labels[sc.topology_key]
            counts.setdefault(dv, 0)
            for p in st.pods:
                if (p.metadata.namespace == pod.metadata.namespace
                        and label_selector_matches(eff_sel, p.metadata.labels)):
                    counts[dv] += 1
        return counts

    def _spread_ok(self, st: NodeState, ctx: dict) -> bool:
        for sc, counts, min_count, self_match in ctx["spread"]:
            dv = st.labels.get(sc.topology_key)
            if dv is None:
                return False  # node without the key can't satisfy the constraint
            if counts.get(dv, 0) + (1 if self_match else 0) - min_count > sc.max_skew:
                return False
        return True

    # ---- inter-pod affinity ---------------------------------------------

    def _prep_term(self, term, owner_ns: str, owner_labels: dict):
        """-> (ns_set | None, effective selector) via encode/termprep.py."""
        return (resolve_term_namespaces(term, owner_ns, self.namespace_labels),
                affinity_term_selector(term, owner_labels))

    @staticmethod
    def _prepped_matches(prep, owner_ns: str, target: Pod) -> bool:
        ns_set, eff = prep
        tns = target.metadata.namespace
        if (tns != owner_ns) if ns_set is None else (tns not in ns_set):
            return False
        return label_selector_matches(eff, target.metadata.labels)

    def _interpod_ok(self, st: NodeState, ctx: dict) -> Optional[str]:
        # Required affinity (filtering.go satisfyPodAffinity): every term's
        # topology key must exist on the node; every term needs a matching pod
        # in the node's domain, OR the global bootstrap applies.
        if ctx["aff"]:
            sat = True
            for term, counts in ctx["aff"]:
                dv = st.labels.get(term.topology_key)
                if dv is None:
                    return FailReason.POD_AFFINITY
                if counts.get(dv, 0) <= 0:
                    sat = False
            if not sat and not ctx["bootstrap"]:
                return FailReason.POD_AFFINITY
        # Required anti-affinity: no matching existing pod in this domain
        # (node without the key satisfies trivially).
        for term, counts in ctx["anti"]:
            dv = st.labels.get(term.topology_key)
            if dv is not None and counts.get(dv, 0) > 0:
                return FailReason.POD_ANTI_AFFINITY
        # Symmetry: existing pods' required anti-affinity veto the newcomer.
        for key, dv in ctx["sym"]:
            if st.labels.get(key) == dv:
                return FailReason.POD_ANTI_AFFINITY
        return None

    # ---- incremental what-if support (preemption dry-run verification) ---

    def remove_bound(self, pod: Pod) -> None:
        """Temporarily evict a bound pod from the simulation (preemption
        what-if); O(node) instead of rebuilding the oracle."""
        i = self.node_index.get(pod.spec.node_name)
        if i is None:
            return
        self.states[i].remove_pod(pod)
        self._fold_demands(self.states[i], pod, sign=-1)
        self._n_anti -= self._has_required_anti(pod)
        self._refresh_volume_state()

    def restore_bound(self, pod: Pod) -> None:
        """Undo remove_bound (the reprieve pass re-adds victims)."""
        i = self.node_index.get(pod.spec.node_name)
        if i is None:
            return
        self.states[i].add_pod(pod)
        self._fold_demands(self.states[i], pod)
        self._n_anti += self._has_required_anti(pod)
        self._refresh_volume_state()

    def _refresh_volume_state(self) -> None:
        if self.volumes is None:
            return  # volume tensors unused without a catalog
        from kubernetes_tpu_torch.sched.volumebinding import cluster_volume_state
        self._vol_rwo, self._vol_attach, self._vol_rwop = cluster_volume_state(
            [p for st in self.states for p in st.pods], self.volumes)

    def feasible_one(self, pod: Pod, ni: int) -> bool:
        """Feasibility of ``pod`` on node index ``ni`` only — the per-node
        half of DryRunPreemption's re-filter, without scanning the fleet."""
        ctx = self._pod_ctx(pod)
        return self._filter_one(pod, self.states[ni], ni, ctx) is None

    def feasible(self, pod: Pod):
        """-> (mask list[bool], reasons dict node_name -> reason)."""
        ctx = self._pod_ctx(pod)
        mask, reasons = [], {}
        for i, st in enumerate(self.states):
            r = self._filter_one(pod, st, i, ctx)
            mask.append(r is None)
            if r is not None:
                reasons[st.node.metadata.name] = r
        return mask, reasons

    # ---- scores ----------------------------------------------------------

    def score(self, pod: Pod, mask: list[bool]) -> np.ndarray:
        """Weighted sum of normalized plugin scores; -inf for infeasible."""
        N = len(self.states)
        total = np.zeros(N, np.float32)
        fmask = np.asarray(mask, bool)
        for name, fn in [
            ("NodeResourcesFit", self._score_least_allocated),
            ("NodeResourcesBalancedAllocation", self._score_balanced),
            ("ImageLocality", self._score_image_locality),
            ("NodeAffinity", self._score_node_affinity),
            ("TaintToleration", self._score_taints),
            ("PodTopologySpread", self._score_spread),
            ("InterPodAffinity", self._score_interpod),
        ]:
            w = self.weights.get(name, 0.0)
            if w:
                total += np.float32(w) * fn(pod, fmask).astype(np.float32)
        return np.where(fmask, total, -np.inf).astype(np.float32)

    def _fractions(self, pod: Pod, st: NodeState):
        reqs = pod.resource_requests()
        out = []
        for r in ("cpu", "memory"):
            alloc = st.allocatable.get(r, 0)
            if alloc <= 0 or alloc >= UNLIMITED:
                out.append(np.float32(0) if r not in reqs else np.float32(1))
                continue
            used = st.requested.get(r, 0) + scale_request(r, reqs.get(r, 0))
            out.append(np.float32(used) / np.float32(alloc))
        return out

    def _score_least_allocated(self, pod: Pod, mask) -> np.ndarray:
        """least_allocated.go: mean over {cpu,memory} of 100*(alloc-used)/alloc."""
        out = np.zeros(len(self.states), np.float32)
        for i, st in enumerate(self.states):
            fr = self._fractions(pod, st)
            out[i] = np.float32(
                sum(np.float32(100) * (np.float32(1) - np.clip(f, 0, 1)) for f in fr)
                / np.float32(len(fr)))
        return out

    def _score_balanced(self, pod: Pod, mask) -> np.ndarray:
        """balanced_allocation.go: 100 * (1 - std(fractions))."""
        out = np.zeros(len(self.states), np.float32)
        for i, st in enumerate(self.states):
            fr = np.asarray(self._fractions(pod, st), np.float32)
            fr = np.clip(fr, 0, 1)
            mean = fr.mean(dtype=np.float32)
            std = np.sqrt(((fr - mean) ** 2).mean(dtype=np.float32))
            out[i] = np.float32(100) * (np.float32(1) - std)
        return out

    def _score_image_locality(self, pod: Pod, mask) -> np.ndarray:
        """image_locality.go: sum of scaled sizes of present images -> threshold ramp."""
        N = len(self.states)
        imgs = [c.image for c in pod.spec.containers if c.image]
        out = np.zeros(N, np.float32)
        if not imgs:
            return out
        # fleet scoping: the spread factor counts the POD'S TENANT'S nodes
        # only (tensor twin: ops/scores.image_locality) — a sibling fleet
        # growing must not shift this pod's locality ramp
        pt = self._tenant_of(pod.metadata.labels)
        visible = [self._tenant_of(st.labels) == pt for st in self.states]
        n_vis = sum(visible)
        have = [set(n.names[0] for n in st.node.status.images if n.names)
                for st in self.states]
        num_nodes_with = {im: sum(im in h for h, v in zip(have, visible)
                                  if v) for im in imgs}
        sizes = {}
        for st in self.states:
            for n in st.node.status.images:
                if n.names:
                    sizes[n.names[0]] = max(sizes.get(n.names[0], 0), n.size_bytes)
        max_threshold = IMG_MAX_CONTAINER_THRESHOLD * max(len(imgs), 1)
        for i, st in enumerate(self.states):
            ssum = np.float32(0)
            for im in imgs:
                if im in have[i]:
                    spread = np.float32(num_nodes_with[im]) / np.float32(
                        max(n_vis, 1))
                    ssum += np.float32(sizes.get(im, 0)) * spread
            val = (ssum - np.float32(IMG_MIN_THRESHOLD)) / np.float32(
                max_threshold - IMG_MIN_THRESHOLD)
            out[i] = np.clip(val, 0, 1) * np.float32(100)
        return out

    def _score_node_affinity(self, pod: Pod, mask) -> np.ndarray:
        """Sum of matching preferred-term weights, DefaultNormalizeScore to 0-100."""
        aff = pod.spec.affinity
        na = aff.node_affinity if aff else None
        raw = np.zeros(len(self.states), np.float32)
        for t in (na.preferred if na else []):
            for i, st in enumerate(self.states):
                from kubernetes_tpu_torch.api.selectors import node_selector_term_matches
                if node_selector_term_matches(t.preference, st.labels,
                                              node_fields(st.node.metadata.name)):
                    raw[i] += np.float32(t.weight)
        return _default_normalize(raw, mask, reverse=False)

    def _score_taints(self, pod: Pod, mask) -> np.ndarray:
        raw = np.zeros(len(self.states), np.float32)
        for i, st in enumerate(self.states):
            c = 0
            for t in st.node.spec.taints:
                if t.effect == EFFECT_PREFER_NO_SCHEDULE and not any(
                        tol.tolerates(t) for tol in pod.spec.tolerations):
                    c += 1
            raw[i] = c
        return _default_normalize(raw, mask, reverse=True)

    def _score_spread(self, pod: Pod, mask) -> np.ndarray:
        """ScheduleAnyway constraints only (scoring.go PreScore): fewer
        matching pods in the node's domain is better."""
        N = len(self.states)
        raw = np.zeros(N, np.float32)
        has_any = False
        for sc in pod.spec.topology_spread_constraints:
            if sc.when_unsatisfiable != "ScheduleAnyway":
                continue
            has_any = True
            eff = spread_selector(sc, pod.metadata.labels)
            counts = self._domain_counts(pod, sc, eff)
            for i, st in enumerate(self.states):
                dv = st.labels.get(sc.topology_key)
                raw[i] += np.float32(counts.get(dv, 0) if dv is not None else 0)
        if not has_any:
            return np.zeros(N, np.float32)
        return _default_normalize(raw, mask, reverse=True)

    def _score_interpod(self, pod: Pod, mask) -> np.ndarray:
        """Preferred inter-pod (anti)affinity of the incoming pod: +/- weight per
        matching existing pod in the node's domain."""
        aff = pod.spec.affinity
        pa = aff.pod_affinity if aff else None
        pan = aff.pod_anti_affinity if aff else None
        N = len(self.states)
        raw = np.zeros(N, np.float32)
        ns = pod.metadata.namespace
        terms = [(t.weight, t.term) for t in (pa.preferred if pa else [])]
        terms += [(-t.weight, t.term) for t in (pan.preferred if pan else [])]
        if not terms:
            return raw
        for w, term in terms:
            prep = self._prep_term(term, ns, pod.metadata.labels)
            # count matching pods per domain value
            counts: dict[str, int] = {}
            for st in self.states:
                dv = st.labels.get(term.topology_key)
                if dv is None:
                    continue
                counts.setdefault(dv, 0)
                for p in st.pods:
                    if self._prepped_matches(prep, ns, p):
                        counts[dv] += 1
            for i, st in enumerate(self.states):
                dv = st.labels.get(term.topology_key)
                if dv is not None:
                    raw[i] += np.float32(w) * np.float32(counts.get(dv, 0))
        return _minmax_normalize(raw, mask)

    # ---- topology slice carving (topology/) ------------------------------

    def _slice_shape_of(self, pod: Pod):
        """The pod's requested slice shape: the slice-shape label, else a
        slice-shaped ResourceClaim when a DRA catalog is attached."""
        from kubernetes_tpu_torch.topology.slicing import shape_of_labels
        s = shape_of_labels(pod.metadata.labels)
        if s is None and self.dra is not None:
            s = self.dra.pod_slice_shape(pod)
        return s

    def _slice_member_req(self, pods: list[Pod]) -> dict:
        """Conservative homogeneous gang view: elementwise MAX of the
        members' scaled requests (the device carver mirrors this over
        pb.requests rows)."""
        req: dict = {}
        for p in pods:
            for r, q in self._eff_requests(p).items():
                req[r] = max(req.get(r, 0), scale_request(r, q))
        return req

    def oracle_carve(self, members: list[Pod], shape: tuple,
                     claimed: set):
        """The numpy oracle carver: per-node host verdicts from the CURRENT
        NodeStates fed to topology/carve.numpy_grids — the bit-parity twin
        of the device's carve_step (asserted by the parity tests and the
        sentinel's carve site). ``claimed`` holds node indices earlier
        gangs of the same cycle already took."""
        from kubernetes_tpu_torch.topology import carve as carve_mod
        if self._dims is None or not members:
            return None
        member_req = self._slice_member_req(members)
        tenant = self._tenant_of(members[0].metadata.labels)
        free, evictable, n_pods = [], [], []
        for i, st in enumerate(self.states):
            usable = (self._coords[i] is not None
                      and tenant == self._tenant_of(st.labels)
                      and not st.node.spec.unschedulable
                      and i not in claimed)
            fits_free = all(q <= st.allocatable.get(r, 0)
                            - st.requested.get(r, 0)
                            for r, q in member_req.items())
            fits_alone = all(q <= st.allocatable.get(r, 0)
                             for r, q in member_req.items())
            free.append(usable and fits_free)
            evictable.append(usable and fits_alone)
            n_pods.append(len(st.pods))
        return carve_mod.numpy_grids(self._coords, free, evictable,
                                     n_pods, self._dims, shape)

    def plan_slices(self, pods: list[Pod], validate: bool = True) -> dict:
        """Carve every slice gang among ``pods`` in the device path's exact
        order (sorted gang ids; earlier gangs' cells claimed against later
        ones; members in sorted-key order <-> C-order box cells) ->
        {gang id: {pod key: node name} or None}. With ``validate`` every
        member must ALSO pass the full oracle filter stack on its cell
        (schedule_all uses this, so an oracle-mode cycle never places an
        infeasible member); the parity sentinel replays with
        validate=False to judge the CARVE alone — the device's gang
        program applies its own filters after the carve pins."""
        from kubernetes_tpu_torch.topology import carve as carve_mod
        from kubernetes_tpu_torch.topology.slicing import GANG_LABEL
        groups: dict[str, list[Pod]] = {}
        shapes: dict[str, tuple] = {}
        for p in pods:
            shape = self._slice_shape_of(p)
            if shape is None:
                continue
            g = (p.metadata.labels or {}).get(GANG_LABEL) or f"pod:{p.key}"
            groups.setdefault(g, []).append(p)
            shapes[g] = shape
        plans: dict[str, Optional[dict]] = {}
        claimed: set = set()
        for g in sorted(groups):
            members = sorted(groups[g], key=lambda p: p.key)
            shape = shapes[g]
            asg = None
            if len(members) == shape[0] * shape[1] * shape[2]:
                res = self.oracle_carve(members, shape, claimed)
                asg = carve_mod.select_assignment(res)
            if asg is not None and validate:
                for m, p in enumerate(members):
                    if self._filter_one(p, self.states[asg[m]], asg[m],
                                        self._pod_ctx(p)) is not None:
                        asg = None
                        break
            if asg is None:
                plans[g] = None
                continue
            claimed.update(asg)
            plans[g] = {p.key: self.states[asg[m]].node.metadata.name
                        for m, p in enumerate(members)}
        return plans

    # ---- cycle -----------------------------------------------------------

    def select_host(self, scores: np.ndarray, salt: int = 0) -> Optional[int]:
        if not np.isfinite(scores).any():
            return None
        best = np.max(scores)
        cands = [i for i in range(len(scores)) if scores[i] == best]
        return min(cands, key=lambda n: tie_break(self._node_rank[n],
                                                  self.seed, salt))

    def schedule_one(self, pod: Pod, salt: int = 0):
        """-> (node index or None, reasons). Does NOT assume; caller decides."""
        mask, reasons = self.feasible(pod)
        if not any(mask):
            return None, reasons
        scores = self.score(pod, mask)
        return self.select_host(scores, salt), reasons

    def assume(self, pod: Pod, node_idx: int):
        pod.spec.node_name = self.states[node_idx].node.metadata.name
        self.states[node_idx].add_pod(pod)
        self._fold_demands(self.states[node_idx], pod)
        self._n_anti += self._has_required_anti(pod)

    def schedule_all(self, pods: list[Pod]):
        """Serial loop over the batch (ScheduleOne x N) in activeQ order —
        priority desc, then arrival (list) order, exactly like the reference's
        PrioritySort queue and the gang batcher's rank. The tie-break salt
        stays the pod's original batch position. Results in input order."""
        order = sorted(range(len(pods)), key=lambda i: (-pods[i].spec.priority, i))
        out: list[Optional[int]] = [None] * len(pods)
        # slice gangs first: carve + assume up front, so no ordinary pod in
        # this batch can nibble a planned cell's capacity between the carve
        # and the member's turn in priority order (contiguous placements
        # are the scarcest resource in the batch)
        slice_nodes: dict[str, Optional[int]] = {}
        if any(self._slice_shape_of(p) is not None for p in pods):
            plans = self.plan_slices(pods)
            picked: dict[str, str] = {}
            for plan in plans.values():
                picked.update(plan or {})
            for p in pods:
                if self._slice_shape_of(p) is None:
                    continue
                ni = self.node_index.get(picked.get(p.key, ""))
                if ni is not None:
                    self.assume(p, ni)
                slice_nodes[p.key] = ni
        for i in order:
            if pods[i].key in slice_nodes:
                out[i] = slice_nodes[pods[i].key]
                continue
            ni, _ = self.schedule_one(pods[i], salt=i)
            if ni is not None:
                self.assume(pods[i], ni)
            out[i] = ni
        return out


def _default_normalize(raw: np.ndarray, mask: np.ndarray, reverse: bool) -> np.ndarray:
    """helper.DefaultNormalizeScore over feasible nodes: scale raw to 0-100 by
    max; reverse flips."""
    mx = np.max(raw[mask]) if mask.any() else np.float32(0)
    if mx <= 0:
        return np.full_like(raw, np.float32(100) if reverse else np.float32(0))
    s = raw * np.float32(100) / np.float32(mx)
    return np.float32(100) - s if reverse else s


def _minmax_normalize(raw: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """InterPodAffinity normalize over feasible nodes: min-max to 0-100
    (scoring.go NormalizeScore)."""
    if raw.size == 0 or not mask.any():
        return np.zeros_like(raw)
    mn, mx = np.min(raw[mask]), np.max(raw[mask])
    if mx == mn:
        return np.zeros_like(raw)
    return (raw - mn) * np.float32(100) / np.float32(mx - mn)
