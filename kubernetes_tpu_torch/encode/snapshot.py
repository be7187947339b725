"""Snapshot encoder: cluster objects -> bucketed static-shape tensors.

The PyTorch port of ``kubernetes_tpu/encode/snapshot.py``: the same
encoder, emitting the same arrays, so the two packages compare field for
field. The encoder fills numpy arrays on the host; ``.to(device)`` on a
container moves every field onto a torch device in one call.

  ClusterTensors  node-side state: allocatable/requested [N,R], labels [N,K],
                  taints, used host-ports, images, plus existing-pods tensors
                  [E,...] for relational plugins (spread / inter-pod affinity).
  PodBatch        pod-side state for the P pods being scheduled this step:
                  requests [P,R], tolerations, node-selector & affinity terms
                  compiled to int-set tables, spread constraints, host-ports.

All strings are interned (encode/dictionary.py); all comparisons downstream
are integer equality. All dims are bucketed to powers of two, as in the
reference, so shapes change only when the cluster crosses a bucket boundary.

Design notes:
- Node names are injected as a pseudo-label ``metadata.name`` so matchFields
  terms compile through the same expression machinery as matchExpressions.
- Topology domains need no dictionary: for a topology key k, two nodes are in
  the same domain iff ``node_labels[:, k]`` agree (see ops/topology.py).
- Of the reference encoder this module keeps ``encode_cluster``,
  ``encode_pods`` and the pod precompile cache they use, the patch
  bookkeeping (``_PatchState``) with ``apply_pod_deltas``,
  ``with_nominated``, and the planners' overlays ``with_hypothetical``
  and ``without_pods`` (on an encoding held in torch tensors they run
  through encode/overlay.py on the tensors' device). DRA (``set_dra``) is
  not ported yet (ROADMAP Queue A item 11).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field as dc_field
from typing import Any, Optional

import numpy as np
import torch

from kubernetes_tpu_torch.api.types import (
    EFFECT_NO_EXECUTE,
    EFFECT_NO_SCHEDULE,
    EFFECT_PREFER_NO_SCHEDULE,
    NODE_INCLUSION_HONOR,
    NODE_INCLUSION_IGNORE,
    OP_DOES_NOT_EXIST,
    OP_EXISTS,
    OP_GT,
    OP_IN,
    OP_LT,
    OP_NOT_IN,
    TOL_OP_EXISTS,
    LabelSelector,
    Node,
    NodeSelectorTerm,
    Pod,
    Requirement,
)
from kubernetes_tpu_torch.encode.dictionary import StringTable, next_bucket
from kubernetes_tpu_torch.encode.scaling import UNLIMITED, scale_allocatable, scale_request
from kubernetes_tpu_torch.encode.termprep import (
    affinity_term_selector,
    resolve_term_namespaces,
    spread_selector,
)

# --- integer op/effect codes used inside tensors -------------------------------

OPC = {OP_IN: 0, OP_NOT_IN: 1, OP_EXISTS: 2, OP_DOES_NOT_EXIST: 3, OP_GT: 4, OP_LT: 5}
EFFECTC = {EFFECT_NO_SCHEDULE: 0, EFFECT_PREFER_NO_SCHEDULE: 1, EFFECT_NO_EXECUTE: 2}
TOLOPC_EQUAL, TOLOPC_EXISTS = 0, 1
PROTOC = {"TCP": 0, "UDP": 1, "SCTP": 2}
NODE_NAME_LABEL = "metadata.name"
WILDCARD_IP = "0.0.0.0"
# Taint the NodeUnschedulable plugin synthesizes for .spec.unschedulable
# (reference: nodeunschedulable/node_unschedulable.go). Pre-interned so its
# key id is the Python-level constant UNSCHED_TAINT_KEY_ID.
UNSCHED_TAINT_KEY = "node.kubernetes.io/unschedulable"
# Fleet tenancy plane (sched/fleet.py): the fleet runner stamps every
# ingested pod/node/namespace with this label, and the label columns
# node_labels[:, TENANT_KEY_ID] / pod_labels[:, TENANT_KEY_ID] ARE the
# tenant_of_node / tenant_of_pod planes — no new tensor field, so churn
# patches, sharding specs, overlays and the staging arena all carry
# tenancy for free. Pre-interned so the id is a Python constant and the
# first tenant-labelled object can never cross a key bucket mid-run.
# Absent label = -1 on both sides, and -1 == -1 passes, so single-tenant
# clusters are bit-identical to the pre-fleet behavior.
TENANT_LABEL = "kubernetes-tpu.io/tenant"
# ICI-torus coordinate plane (topology/): nodes advertise their position
# on the wrap-around mesh via these labels, and — same trick as tenancy —
# the label COLUMNS node_labels[:, TOPO_*_KEY_ID] combined with the
# existing label_value_num numeric-parse plane ARE the coordinate fields.
# No new tensor member, so churn patches and overlays are untouched and the
# carver's occupancy grid is always current. Pre-interned so the ids are
# Python constants.
TOPO_X_LABEL = "kubernetes-tpu.io/topology-x"
TOPO_Y_LABEL = "kubernetes-tpu.io/topology-y"
TOPO_Z_LABEL = "kubernetes-tpu.io/topology-z"
NODE_NAME_KEY_ID = 0
UNSCHED_TAINT_KEY_ID = 1
TENANT_KEY_ID = 2
TOPO_X_KEY_ID = 3
TOPO_Y_KEY_ID = 4
TOPO_Z_KEY_ID = 5


def tenant_label_of(labels: Optional[dict]) -> Optional[str]:
    """The ONE way to read an object's tenant id from its labels (None =
    untenanted). Every consumer — oracle filter, victim guard, audit
    invariant, fleet queue — goes through here so the tenancy convention
    can never drift between them."""
    return (labels or {}).get(TENANT_LABEL)
EMPTY_VALUE_ID = 0  # "" pre-interned: empty taint values / tolerations compare to it

# batch-derived bucket dims of a PodBatch, in row-signature order (the
# row-pack cache keys on (resources, K, NSB) + these widths)
_ROW_DIMS = ("TREQ", "TPREF", "VT", "VG", "VB", "X", "VV", "S", "TOL",
             "PP", "CI", "AT", "BT", "CT", "SC", "AX", "AV")


class _Tensors:
    """Base of the tensor containers: ``replace`` and a device move.

    Fields hold numpy arrays as the encoder fills them, or torch tensors
    after ``to(device)``; nested containers move with their parent."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: _to_device(getattr(self, f.name), device)
            for f in dataclasses.fields(self)})


def _to_device(x, device):
    if isinstance(x, _Tensors):
        return x.to(device)
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return x.to(device)


@dataclass
class TermSet(_Tensors):
    """Compiled node-selector terms: OR over terms, AND over exprs within a term.

    Shapes: key/op/num/expr_valid [P,T,X]; vals [P,T,X,V]; term_valid [P,T];
    weight [P,T] (1.0 for required terms); has_any [P].
    """

    key: Any
    op: Any
    vals: Any
    num: Any
    expr_valid: Any
    term_valid: Any
    weight: Any
    has_any: Any


@dataclass
class SelectorSet(_Tensors):
    """Compiled label selectors (AND of exprs), e.g. pod-affinity term selectors
    or spread-constraint selectors. Shapes: key/op/expr_valid [..., X];
    vals [..., X, V]; valid [...] marks real (non-pad) selectors.
    A valid selector with zero exprs matches everything (empty selector);
    invalid (pad) selectors match nothing.
    """

    key: Any
    op: Any
    vals: Any
    expr_valid: Any
    valid: Any


def _selset_arrays(shape_prefix: tuple[int, ...], AX: int, AV: int) -> dict:
    return dict(
        key=np.full(shape_prefix + (AX,), -1, np.int32),
        op=np.zeros(shape_prefix + (AX,), np.int32),
        vals=np.full(shape_prefix + (AX, AV), -1, np.int32),
        expr_valid=np.zeros(shape_prefix + (AX,), bool),
        valid=np.zeros(shape_prefix, bool),
    )


def _selset_fill(arrs: dict, idx: tuple[int, ...], valid: bool, exprs: list):
    arrs["valid"][idx] = valid
    for x_idx, (kid, opc, vals, _num) in enumerate(exprs):
        arrs["key"][idx + (x_idx,)] = kid
        arrs["op"][idx + (x_idx,)] = opc
        arrs["expr_valid"][idx + (x_idx,)] = True
        for v_idx, v in enumerate(vals):
            arrs["vals"][idx + (x_idx, v_idx)] = v


@dataclass
class ClusterTensors(_Tensors):
    allocatable: Any      # [N,R] int32 (scaled units; missing "pods" -> UNLIMITED)
    requested: Any        # [N,R] int32
    node_valid: Any       # [N] bool
    unschedulable: Any    # [N] bool
    node_labels: Any      # [N,K] int32 value-id, -1 absent
    label_value_num: Any  # [V] float32 integer-parse of value strings (NaN if not)
    taint_key: Any        # [N,T] int32
    taint_val: Any        # [N,T] int32
    taint_effect: Any     # [N,T] int32
    taint_valid: Any      # [N,T] bool
    port_proto: Any       # [N,PRT] int32
    port_port: Any        # [N,PRT] int32
    port_ip: Any          # [N,PRT] int32 (0 = wildcard 0.0.0.0)
    port_valid: Any       # [N,PRT] bool
    node_images: Any      # [N,I] int32 image-id, -1 pad
    image_sizes: Any      # [IMG] float32 bytes
    epod_node: Any        # [E] int32 node index of existing pod
    epod_ns: Any          # [E] int32 namespace id
    epod_labels: Any      # [E,K] int32
    epod_valid: Any       # [E] bool
    # existing pods' REQUIRED anti-affinity terms (symmetry veto)
    ea_sel: "SelectorSet"  # [E,ET,...]
    ea_topo: Any           # [E,ET] int32
    ea_valid: Any          # [E,ET] bool
    # terms with explicit namespaces/namespaceSelector: resolved ns-id mask
    # (False rows = "owning pod's own namespace" semantics)
    ea_ns_explicit: Any    # [E,ET] bool
    ea_ns_mask: Any        # [E,ET,NSB] bool over interned namespace ids
    # volumes (VolumeRestrictions / NodeVolumeLimits node side)
    used_rwo: Any          # [N,VN] int32 pv-name id of node-exclusive PVs in use
    used_rwo_valid: Any    # [N,VN] bool
    attach_used: Any       # [N] int32 attachable volumes currently on node
    attach_limit: Any      # [N] int32 (UNLIMITED if node reports no limit)
    # nominated-but-unbound pods (preemption nominees): their requests are
    # reserved on nom_node against pods of LOWER priority
    # (RunFilterPluginsWithNominatedPods — schedule_one.go)
    nom_node: Any          # [M] int32 node index
    nom_prio: Any          # [M] int32
    nom_req: Any           # [M,R] int32
    nom_valid: Any         # [M] bool


@dataclass
class PodBatch(_Tensors):
    requests: Any      # [P,R] int32
    pod_valid: Any     # [P] bool
    priority: Any      # [P] int32
    forced_node: Any   # [P] int32: -1 none, -2 named node unknown
    pod_ns: Any        # [P] int32
    pod_labels: Any    # [P,K] int32
    tol_key: Any       # [P,TOL] int32 (-1 = empty key -> matches all keys)
    tol_op: Any        # [P,TOL] int32
    tol_val: Any       # [P,TOL] int32
    tol_effect: Any    # [P,TOL] int32 (-1 = all effects)
    tol_valid: Any     # [P,TOL] bool
    sel_key: Any       # [P,S] int32 nodeSelector (AND of equality)
    sel_val: Any       # [P,S] int32
    sel_valid: Any     # [P,S] bool
    req_terms: TermSet   # required node affinity (+ matchFields)
    pref_terms: TermSet  # preferred node affinity, weight per term
    port_proto: Any    # [P,PP] int32
    port_port: Any     # [P,PP] int32
    port_ip: Any       # [P,PP] int32
    port_valid: Any    # [P,PP] bool
    pod_images: Any    # [P,CI] int32
    image_bytes: Any   # [P] float32 total bytes of pod's images (ImageLocality cap)
    # --- relational terms (spread / inter-pod affinity), see ops/topology.py ---
    aff_sel: SelectorSet    # [P,AT,...] required pod-affinity selectors
    aff_topo: Any           # [P,AT] int32 topology key-id
    aff_valid: Any          # [P,AT] bool
    aff_ns_explicit: Any    # [P,AT] bool: term has explicit namespaces
    aff_ns_mask: Any        # [P,AT,NSB] bool: resolved namespace-id set
    anti_sel: SelectorSet   # [P,BT,...] required anti-affinity selectors
    anti_topo: Any          # [P,BT] int32
    anti_valid: Any         # [P,BT] bool
    anti_ns_explicit: Any   # [P,BT] bool
    anti_ns_mask: Any       # [P,BT,NSB] bool
    paff_sel: SelectorSet   # [P,CT,...] preferred pod-affinity selectors
    paff_topo: Any          # [P,CT] int32
    paff_weight: Any        # [P,CT] float32 (negative for preferred anti-affinity)
    paff_valid: Any         # [P,CT] bool
    paff_ns_explicit: Any   # [P,CT] bool
    paff_ns_mask: Any       # [P,CT,NSB] bool
    sc_sel: SelectorSet     # [P,SC,...] spread-constraint selectors
    sc_topo: Any            # [P,SC] int32
    sc_maxskew: Any         # [P,SC] int32
    sc_hard: Any            # [P,SC] bool (DoNotSchedule)
    sc_valid: Any           # [P,SC] bool
    sc_min_domains: Any     # [P,SC] int32 (0 = unset)
    sc_honor_affinity: Any  # [P,SC] bool: nodeAffinityPolicy == Honor
    sc_honor_taints: Any    # [P,SC] bool: nodeTaintsPolicy == Honor
    # volumes (VolumeBinding/VolumeZone as grouped node-selector terms:
    # OR within a group = any candidate PV; AND across groups = every PVC)
    vol_terms: TermSet      # [P,VT,...]
    vol_group: Any          # [P,VT] int32 group id of each term (-1 pad)
    vol_group_valid: Any    # [P,VG] bool real groups (a group with no terms
    #                         is unsatisfiable: valid here, no matching term)
    rwo_pv: Any             # [P,VB] int32 node-exclusive pv ids the pod mounts
    rwo_valid: Any          # [P,VB] bool
    attach_req: Any         # [P] int32 attachable volumes the pod adds


@dataclass
class _PatchState:
    """Book-keeping from the last full encode enabling in-place pod deltas
    (the analog of ``Cache.UpdateSnapshot``'s generation-counter incremental
    path — pkg/scheduler/internal/cache/cache.go): which existing-pod slot
    each bound pod occupies, free slots, and the bucket sizes that bound what
    a patch may grow."""

    generation: int
    resources: list[str]
    res_index: dict[str, int]
    node_index: dict[str, int]
    # bucket sizes bounding what a patch may add
    K: int
    ET: int
    EAX: int
    EAV: int
    NSB: int
    slot_of: dict[str, int] = dc_field(default_factory=dict)
    free: list[int] = dc_field(default_factory=list)
    slot_node: dict[str, int] = dc_field(default_factory=dict)
    slot_req: dict[str, Any] = dc_field(default_factory=dict)
    # pods whose encode contributed node port/volume state — removing or
    # replacing one requires a full re-encode
    unpatchable: set = dc_field(default_factory=set)
    # ---- node-side patch bookkeeping (drain-context churn patches:
    # encode/patch.py). Bucket widths of the node-axis arrays plus the free
    # node rows the N bucket left (node_valid False), so node ADD/REMOVE can
    # patch the encoding instead of forcing a full rebuild under churn.
    N: int = 0
    V: int = 0
    T: int = 0
    I: int = 0
    IMG: int = 0  # filled prefix of image_sizes: a NEW image id needs its
    #               size shipped, which patches don't do -> rebuild
    PRT: int = 0
    VN: int = 0
    E: int = 0
    node_free: list[int] = dc_field(default_factory=list)  # ascending rows
    row_pods: dict[int, int] = dc_field(default_factory=dict)  # row -> #pods


@dataclass
class SnapshotMeta:
    """Host-side static metadata accompanying the tensors (NOT a pytree)."""

    keys: StringTable
    values: StringTable
    namespaces: StringTable
    ips: StringTable
    images: StringTable
    resources: list[str] = dc_field(default_factory=list)
    node_names: list[str] = dc_field(default_factory=list)
    node_index: dict[str, int] = dc_field(default_factory=dict)
    pod_keys: list[str] = dc_field(default_factory=list)  # keys of the encoded batch
    topo_keys: tuple[int, ...] = ()  # distinct topology key-ids in play (static)
    generation: int = 0


def _is_device_backed(ct: ClusterTensors) -> bool:
    """True when the encoding's fields are torch tensors (a drain
    context's resident image, on the card or the CPU) rather than the
    encoder's numpy arrays — the overlay methods route these through
    encode/overlay.py so the image never round-trips."""
    return isinstance(ct.node_valid, torch.Tensor)


def _resource_union(nodes: list[Node], pods: list[Pod]) -> list[str]:
    seen = ["cpu", "memory", "pods"]
    seen_set = set(seen)
    for n in nodes:
        for r in n.status.allocatable:
            if r not in seen_set:
                seen.append(r)
                seen_set.add(r)
    for p in pods:
        for r in p.resource_requests():
            if r not in seen_set:
                seen.append(r)
                seen_set.add(r)
    return seen


class SnapshotEncoder:
    """Persistent encoder: intern tables survive across snapshots so ids are
    stable and incremental re-encoding stays cheap."""

    def __init__(self):
        self.keys = StringTable([NODE_NAME_LABEL, UNSCHED_TAINT_KEY,
                                 TENANT_LABEL, TOPO_X_LABEL, TOPO_Y_LABEL,
                                 TOPO_Z_LABEL])
        self.values = StringTable([""])
        self.namespaces = StringTable(["default"])
        self.ips = StringTable([WILDCARD_IP])
        self.images = StringTable()
        self.pv_names = StringTable()
        self._image_sizes: list[float] = []
        self._cluster_topo_keys: set[int] = set()
        self._volumes = None  # VolumeCatalog | None
        self._namespace_labels: dict[str, dict] = {}
        # does any encoded existing-pod anti term carry a namespaceSelector?
        # (only then does the cluster encoding depend on namespace labels)
        self._cluster_ns_selector_terms = False
        self._rwop_in_use: set = set()
        self._patch: Optional[_PatchState] = None
        self.generation = 0
        # bucket headroom so CHURN patches fit without re-encoding: free
        # node rows for node ADDs, spare label-value ids for the new values
        # they intern (every node interns its own name). 0 = tight buckets
        # (kernels/parity tests); the scheduler cache raises them.
        self.node_headroom = 0
        self.value_headroom = 0
        self.ns_headroom = 0
        # informer-event-time pod compile cache (precompile_pod): key ->
        # [pod object, epoch, compiled record, row sig, row pack]. Hits are
        # validated by OBJECT IDENTITY (informers build a fresh Pod per
        # event, so a new version never aliases a cached one) and by the
        # catalog epoch below — any volume/namespace/DRA catalog change
        # invalidates every record. The row pack is the pod's PRE-FILLED
        # numpy rows at the current bucket signature: encode_pods then
        # assembles the batch with one np.stack per field instead of the
        # per-pod Python fill loop (the 1136 ms encode residual the churn
        # bench showed with the compile cache already hot).
        self._pod_cache: dict[str, list] = {}
        self._pod_cache_max = 65536
        self._pod_epoch = 0
        # Per-tenant catalog epochs: namespace-label churn in one tenant
        # must not invalidate every OTHER tenant's precompiled pod records
        # (a fleet runs K tenants' churn through ONE encoder, and the
        # global epoch made any tenant's namespace update a fleet-wide
        # row-cache wipe). A record's effective epoch is the (global,
        # tenant) pair; volumes/DRA stay global — those catalogs are
        # genuinely shared.
        self._tenant_epochs: dict[Optional[str], int] = {}
        self.pod_cache_hits = 0
        self.pod_cache_misses = 0
        # sticky existing-pod slot bucket (see encode_cluster): E never
        # shrinks, so churn oscillating around a bucket boundary cannot
        # recompile the drain programs at alternating widths
        self._slot_floor = 0
        # sticky batch bucket widths (monotone max across encodes) so row
        # packs prebuilt at informer time keep matching the batch signature;
        # power-of-two buckets only ever grow, exactly like the intern
        # tables, so stickiness costs padding, never correctness
        self._row_widths: dict[str, int] = {}
        self._row_sig: Optional[tuple] = None
        self._row_env: Optional[tuple] = None  # (resources, K, NSB, widths)
        self.pod_rows_stacked = 0  # rows bulk-assembled from prebuilt packs
        self.pod_rows_filled = 0   # rows built by the per-pod fill loop

    def set_volumes(self, catalog) -> None:
        """Attach the PVC/PV/StorageClass catalog consulted by the next
        encode_cluster/encode_pods pair (sched/volumebinding.VolumeCatalog)."""
        self._volumes = catalog
        self._pod_epoch += 1  # precompiled pod records may embed stale state

    def set_namespaces(self, namespace_labels: dict[str, dict],
                       changed_tenants=None) -> None:
        """Attach the namespace-name -> labels snapshot used to resolve
        affinity terms' namespaceSelector (GetNamespaceLabelsSnapshot
        analog).

        ``changed_tenants``: optional iterable of tenant ids (values of the
        ``kubernetes-tpu.io/tenant`` label; None = untenanted) whose
        namespaces this update touched. When given, only those tenants'
        pod-record epochs bump — nsSelector resolution is tenant-scoped
        (encode/termprep.py), so a sibling tenant's records stay valid.
        Omitted/None = conservative global bump (pre-fleet behavior)."""
        self._namespace_labels = dict(namespace_labels or {})
        if changed_tenants is None:
            self._pod_epoch += 1  # term namespace resolution may change
        else:
            for t in changed_tenants:
                self._tenant_epochs[t] = self._tenant_epochs.get(t, 0) + 1

    def _epoch_for(self, p: Pod) -> tuple:
        """The (global, tenant) catalog epoch a pod's precompiled record is
        valid under — per-tenant so one tenant's namespace churn cannot
        wipe the whole fleet's row cache. Keyed by the POD'S NAMESPACE'S
        tenant (the same identity ``set_namespaces`` bumps and termprep's
        nsSelector scoping resolves against); the pod's own label is only
        the fallback for namespaces absent from the snapshot."""
        t = tenant_label_of(self._namespace_labels.get(p.metadata.namespace))
        if t is None:
            t = tenant_label_of(p.metadata.labels)
        # the tenant id itself is part of the key: a namespace RELABELLED
        # to another tenant must miss even when the two tenants' counters
        # happen to be numerically equal
        return (self._pod_epoch, t, self._tenant_epochs.get(t, 0))

    @property
    def volumes(self):
        """The attached volume catalog (or None)."""
        return self._volumes

    @property
    def cluster_depends_on_namespace_labels(self) -> bool:
        """True when the last cluster encoding resolved a namespaceSelector,
        i.e. namespace-label churn invalidates it (vs. only affecting future
        pod batches, which always read the fresh snapshot)."""
        return self._cluster_ns_selector_terms

    # -- small helpers ------------------------------------------------------

    def _intern_image(self, name: str, size: float = 0.0) -> int:
        i = self.images.intern(name)
        if i == len(self._image_sizes):
            self._image_sizes.append(float(size))
        elif size:
            self._image_sizes[i] = max(self._image_sizes[i], float(size))
        return i

    def _label_ids(self, labels: dict[str, str], extra: dict[str, str] | None = None):
        out = {}
        for k, v in {**labels, **(extra or {})}.items():
            out[self.keys.intern(k)] = self.values.intern(v)
        return out

    # -- cluster side -------------------------------------------------------

    def encode_cluster(self, nodes: list[Node], bound_pods: list[Pod],
                       pending_pods: Optional[list[Pod]] = None,
                       slot_headroom: int = 0,
                       pending_slots: bool = True,
                       ) -> tuple[ClusterTensors, SnapshotMeta]:
        """Encode node-side state. ``bound_pods`` are pods already assigned
        (their requests fold into ``requested`` and they populate the
        existing-pods tensors). ``pending_pods`` only widen the resource axis so
        cluster and batch tensors agree on R. ``slot_headroom``: reserve at
        least this many free existing-pod slots (typically the scheduler's
        total queue depth) so subsequent binds patch incrementally without
        growing the E bucket — keeping tensor shapes stable across the
        whole drain.
        ``pending_slots=False`` skips reserving epod slots for pending pods
        (gang_drain appends its own per-batch extension slots; double-
        reserving would widen every relational contraction for nothing)."""
        self.generation += 1
        resources = _resource_union(nodes, bound_pods + list(pending_pods or []))
        R = len(resources)
        N = next_bucket(len(nodes) + self.node_headroom, minimum=1)

        node_index = {n.metadata.name: i for i, n in enumerate(nodes)}
        # Pre-intern all labels so the key bucket covers everything.
        node_label_ids = [self._label_ids(n.metadata.labels, {NODE_NAME_LABEL: n.metadata.name})
                          for n in nodes]
        epods = [p for p in bound_pods if p.spec.node_name in node_index]
        epod_label_ids = [self._label_ids(p.metadata.labels) for p in epods]

        # existing pods' required anti-affinity terms (symmetry veto) — compile
        # before fixing K so their keys are covered by the bucket. Terms are
        # normalized host-side (encode/termprep.py): matchLabelKeys merged
        # into the selector using the OWNING pod's labels, namespaces +
        # namespaceSelector resolved to interned-id lists (None = own ns).
        self._cluster_ns_selector_terms = False

        def _anti_terms(p: Pod) -> list:
            aff = p.spec.affinity
            pan = aff.pod_anti_affinity if aff else None
            terms = []
            for t in (pan.required if pan else []):
                eff = affinity_term_selector(t, p.metadata.labels)
                valid, exprs = self._compile_selector(eff)
                if t.namespace_selector is not None:
                    self._cluster_ns_selector_terms = True
                ns_set = resolve_term_namespaces(
                    t, p.metadata.namespace, self._namespace_labels)
                ns_ids = (None if ns_set is None else
                          tuple(self.namespaces.intern(n) for n in sorted(ns_set)))
                terms.append((self.keys.intern(t.topology_key), valid, exprs,
                              ns_ids))
            return terms

        ea_terms = [_anti_terms(p) for p in epods]
        self._cluster_topo_keys = {k for ts in ea_terms for (k, _, _, _) in ts}
        # Pre-intern pending pods' labels + anti terms and leave slot headroom
        # so that when they bind, the incremental patch path (apply_pod_deltas)
        # fits them without a full re-encode.
        pend = list(pending_pods or [])
        pend_terms = []
        for p in pend:
            self._label_ids(p.metadata.labels)
            self.namespaces.intern(p.metadata.namespace)
            pend_terms.append(_anti_terms(p))
        for p in epods:
            self.namespaces.intern(p.metadata.namespace)
        K = next_bucket(len(self.keys), minimum=1)
        # namespace-mask width: covers every id interned so far (epods, pend
        # pods, and all resolved term sets), so patches stay in-bucket
        NSB = next_bucket(len(self.namespaces) + self.ns_headroom, minimum=1)

        allocatable = np.zeros((N, R), np.int32)
        requested = np.zeros((N, R), np.int32)
        node_valid = np.zeros(N, bool)
        unschedulable = np.zeros(N, bool)
        node_labels = np.full((N, K), -1, np.int32)
        T = next_bucket(max((len(n.spec.taints) for n in nodes), default=0))
        taint_key = np.full((N, T), -1, np.int32)
        taint_val = np.full((N, T), -1, np.int32)
        taint_effect = np.full((N, T), -1, np.int32)
        taint_valid = np.zeros((N, T), bool)

        ports_per_node: list[list[tuple[str, str, int]]] = [[] for _ in range(N)]
        for p in epods:
            ni = node_index[p.spec.node_name]
            for trip in p.host_ports():
                ports_per_node[ni].append(trip)
        PRT = next_bucket(max((len(x) for x in ports_per_node), default=0))
        port_proto = np.full((N, PRT), -1, np.int32)
        port_port = np.full((N, PRT), -1, np.int32)
        port_ip = np.full((N, PRT), -1, np.int32)
        port_valid = np.zeros((N, PRT), bool)

        I = next_bucket(max((len(n.status.images) for n in nodes), default=0))
        node_images = np.full((N, I), -1, np.int32)

        for i, n in enumerate(nodes):
            node_valid[i] = True
            unschedulable[i] = n.spec.unschedulable
            alloc = dict(n.allocatable_canonical())
            for r_idx, r in enumerate(resources):
                if r in alloc:
                    allocatable[i, r_idx] = min(scale_allocatable(r, alloc[r]), UNLIMITED)
                elif r == "pods":
                    allocatable[i, r_idx] = UNLIMITED
            for kid, vid in node_label_ids[i].items():
                node_labels[i, kid] = vid
            for t_idx, t in enumerate(n.spec.taints):
                taint_key[i, t_idx] = self.keys.intern(t.key)
                taint_val[i, t_idx] = self.values.intern(t.value)
                taint_effect[i, t_idx] = EFFECTC.get(t.effect, 0)
                taint_valid[i, t_idx] = True
            for img_idx, img in enumerate(n.status.images):
                if img.names:
                    node_images[i, img_idx] = self._intern_image(img.names[0], img.size_bytes)
            for pt_idx, (ip, proto, port) in enumerate(ports_per_node[i]):
                port_proto[i, pt_idx] = PROTOC.get(proto, 3)
                port_port[i, pt_idx] = port
                port_ip[i, pt_idx] = self.ips.intern(ip)
                port_valid[i, pt_idx] = True

        # Fold bound pods into requested[N,R].
        for p in epods:
            requested[node_index[p.spec.node_name]] += \
                self._request_vector(p, resources)

        # Sticky slot bucket: like the pod-batch row widths, E only ever
        # GROWS across this encoder's lifetime. The bound-pod count under
        # churn naturally oscillates around bucket boundaries, and E
        # flapping 64<->128 would change every relational shape on each
        # rebuild that crossed. It also keeps this encoder's shapes equal
        # to the reference encoder's. Stickiness costs padded rows, never
        # correctness: every slot past the fill is invalid.
        E = next_bucket(len(epods) + (max(len(pend), slot_headroom)
                                      if pending_slots else slot_headroom),
                        minimum=self._slot_floor)
        self._slot_floor = max(self._slot_floor, E)
        epod_node = np.full(E, -1, np.int32)
        epod_ns = np.full(E, -1, np.int32)
        epod_labels = np.full((E, K), -1, np.int32)
        epod_valid = np.zeros(E, bool)
        for e, p in enumerate(epods):
            epod_node[e] = node_index[p.spec.node_name]
            epod_ns[e] = self.namespaces.intern(p.metadata.namespace)
            for kid, vid in epod_label_ids[e].items():
                epod_labels[e, kid] = vid
            epod_valid[e] = True

        all_terms = ea_terms + pend_terms
        ET = next_bucket(max((len(t) for t in all_terms), default=0))
        EAX = next_bucket(max((len(ex) for ts in all_terms for (_, _, ex, _) in ts), default=0))
        EAV = next_bucket(max((len(v) for ts in all_terms for (_, _, ex, _) in ts
                               for (_, _, v, _) in ex), default=0))
        ea_arrs = _selset_arrays((E, ET), EAX, EAV)
        ea_topo = np.full((E, ET), -1, np.int32)
        ea_valid = np.zeros((E, ET), bool)
        ea_ns_explicit = np.zeros((E, ET), bool)
        ea_ns_mask = np.zeros((E, ET, NSB), bool)
        for e, terms in enumerate(ea_terms):
            for t_idx, (topo, valid, exprs, ns_ids) in enumerate(terms):
                ea_topo[e, t_idx] = topo
                ea_valid[e, t_idx] = True
                _selset_fill(ea_arrs, (e, t_idx), valid, exprs)
                if ns_ids is not None:
                    ea_ns_explicit[e, t_idx] = True
                    for nid in ns_ids:
                        ea_ns_mask[e, t_idx, nid] = True

        # volumes: node-side VolumeRestrictions / NodeVolumeLimits state
        from kubernetes_tpu_torch.sched.volumebinding import (
            cluster_volume_state,
            node_attach_limit,
        )
        per_node_rwo, per_node_attach, self._rwop_in_use = \
            cluster_volume_state(epods, self._volumes)
        VN = next_bucket(max((len(v) for v in per_node_rwo.values()), default=0))
        used_rwo = np.full((N, VN), -1, np.int32)
        used_rwo_valid = np.zeros((N, VN), bool)
        attach_used = np.zeros(N, np.int32)
        attach_limit = np.full(N, UNLIMITED, np.int32)
        for i, n in enumerate(nodes):
            lim = node_attach_limit(n.status.allocatable)
            if lim >= 0:
                attach_limit[i] = lim
            attach_used[i] = per_node_attach.get(n.metadata.name, 0)
            for v_idx, pv in enumerate(per_node_rwo.get(n.metadata.name, [])):
                used_rwo[i, v_idx] = self.pv_names.intern(pv)
                used_rwo_valid[i, v_idx] = True

        V = next_bucket(len(self.values) + self.value_headroom, minimum=1)
        label_value_num = np.full(V, np.nan, np.float32)
        nums = self.values.numeric_values()
        label_value_num[:len(nums)] = np.asarray(nums, np.float32)

        IMG = next_bucket(len(self._image_sizes), minimum=1)
        image_sizes = np.zeros(IMG, np.float32)
        image_sizes[:len(self._image_sizes)] = self._image_sizes

        meta = SnapshotMeta(
            keys=self.keys, values=self.values, namespaces=self.namespaces,
            ips=self.ips, images=self.images, resources=resources,
            node_names=[n.metadata.name for n in nodes], node_index=node_index,
            topo_keys=tuple(sorted(self._cluster_topo_keys)),
            generation=self.generation,
        )
        row_pods: dict[int, int] = {}
        for p in epods:
            ni = node_index[p.spec.node_name]
            row_pods[ni] = row_pods.get(ni, 0) + 1
        self._patch = _PatchState(
            generation=self.generation, resources=resources,
            res_index={r: i for i, r in enumerate(resources)},
            node_index=node_index, K=K, ET=ET, EAX=EAX, EAV=EAV, NSB=NSB,
            slot_of={p.key: e for e, p in enumerate(epods)},
            free=list(range(len(epods), E))[::-1],
            slot_node={p.key: node_index[p.spec.node_name] for p in epods},
            slot_req={p.key: self._request_vector(p, resources) for p in epods},
            unpatchable={p.key for p in epods
                         if p.spec.volumes or p.host_ports()},
            N=N, V=V, T=T, I=I, IMG=len(self._image_sizes),
            PRT=PRT, VN=VN, E=E,
            node_free=list(range(len(nodes), N)),
            row_pods=row_pods,
        )
        ct = ClusterTensors(
            allocatable=allocatable, requested=requested, node_valid=node_valid,
            unschedulable=unschedulable, node_labels=node_labels,
            label_value_num=label_value_num,
            taint_key=taint_key, taint_val=taint_val, taint_effect=taint_effect,
            taint_valid=taint_valid,
            port_proto=port_proto, port_port=port_port, port_ip=port_ip,
            port_valid=port_valid,
            node_images=node_images, image_sizes=image_sizes,
            epod_node=epod_node, epod_ns=epod_ns, epod_labels=epod_labels,
            epod_valid=epod_valid,
            ea_sel=SelectorSet(**ea_arrs), ea_topo=ea_topo, ea_valid=ea_valid,
            ea_ns_explicit=ea_ns_explicit, ea_ns_mask=ea_ns_mask,
            used_rwo=used_rwo, used_rwo_valid=used_rwo_valid,
            attach_used=attach_used, attach_limit=attach_limit,
            nom_node=np.zeros(0, np.int32), nom_prio=np.zeros(0, np.int32),
            nom_req=np.zeros((0, R), np.int32), nom_valid=np.zeros(0, bool),
        )
        return ct, meta

    def with_hypothetical(self, ct: ClusterTensors, meta: "SnapshotMeta",
                          nodes: list[Node],
                          ) -> tuple[ClusterTensors, list[int]]:
        """Overlay K hypothetical nodes onto an encoded snapshot — the
        cluster-autoscaler's "would the pending pods fit on a node from
        group g?" question, asked for every candidate group in ONE tensor
        program instead of K sequential binpacking passes (the reference
        delegates this to simulator.SchedulerBasedPredicateChecker in
        kubernetes/autoscaler).

        The overlay is ephemeral and copy-on-write: node-axis arrays widen
        to the next bucket past N+K and the template rows fill in after the
        existing bucket, so real rows (and the incremental-patch bookkeeping,
        which is NOT touched) keep their indices. Template labels/taints
        intern into the shared tables; node_labels' key axis and the
        label-value-number table widen if a template introduces new ids.
        Template resources outside the encoded resource axis are ignored —
        encode the cluster with the pending pods so R already covers them.

        Returns (overlaid tensors, row index per hypothetical node).

        Handed an encoding held in torch tensors (the scheduler's drain
        context), the overlay stays on their device: template planes are
        built host-side at the resident bucket widths and appended by one
        concatenate per field (encode/overlay.py). A template that
        overflows a resident bucket (new label key past K, more taints than
        T, a value past V) raises ``ValueError``: the tensors are not copied
        to the host to answer it (encode/overlay.py's planners decline
        there and run their cold encode instead).
        """
        K = len(nodes)
        if K == 0:
            return ct, []
        if _is_device_backed(ct):
            from kubernetes_tpu_torch.encode import overlay
            out = overlay.resident_with_hypothetical(self, ct, meta, nodes)
            if out is None:
                raise ValueError(
                    "a template overflows a bucket of the encoding held in "
                    "tensors (label key, taint or value): encode the "
                    "cluster again on the host")
            return out
        N = ct.node_valid.shape[0]
        N2 = next_bucket(N + K, minimum=1)
        rows = list(range(N, N + K))

        # intern template state first so every bucket decision sees it
        tmpl_labels = [self._label_ids(n.metadata.labels,
                                       {NODE_NAME_LABEL: n.metadata.name})
                       for n in nodes]
        tmpl_taints = [[(self.keys.intern(t.key), self.values.intern(t.value),
                         EFFECTC.get(t.effect, 0)) for t in n.spec.taints]
                       for n in nodes]

        def _widen(arr, axis, new, fill):
            arr = np.asarray(arr)
            if arr.shape[axis] >= new:
                return np.array(arr)
            pad = [(0, 0)] * arr.ndim
            pad[axis] = (0, new - arr.shape[axis])
            return np.pad(arr, pad, constant_values=fill)

        K2 = max(np.asarray(ct.node_labels).shape[1],
                 next_bucket(len(self.keys), minimum=1))
        T2 = max(np.asarray(ct.taint_key).shape[1],
                 next_bucket(max((len(t) for t in tmpl_taints), default=0)))
        allocatable = _widen(ct.allocatable, 0, N2, 0)
        requested = _widen(ct.requested, 0, N2, 0)
        node_valid = _widen(ct.node_valid, 0, N2, False)
        unschedulable = _widen(ct.unschedulable, 0, N2, False)
        node_labels = _widen(_widen(ct.node_labels, 1, K2, -1), 0, N2, -1)
        taint_key = _widen(_widen(ct.taint_key, 1, T2, -1), 0, N2, -1)
        taint_val = _widen(_widen(ct.taint_val, 1, T2, -1), 0, N2, -1)
        taint_effect = _widen(_widen(ct.taint_effect, 1, T2, -1), 0, N2, -1)
        taint_valid = _widen(_widen(ct.taint_valid, 1, T2, False), 0, N2, False)
        port_proto = _widen(ct.port_proto, 0, N2, -1)
        port_port = _widen(ct.port_port, 0, N2, -1)
        port_ip = _widen(ct.port_ip, 0, N2, -1)
        port_valid = _widen(ct.port_valid, 0, N2, False)
        node_images = _widen(ct.node_images, 0, N2, -1)
        used_rwo = _widen(ct.used_rwo, 0, N2, -1)
        used_rwo_valid = _widen(ct.used_rwo_valid, 0, N2, False)
        attach_used = _widen(ct.attach_used, 0, N2, 0)
        attach_limit = _widen(ct.attach_limit, 0, N2, UNLIMITED)

        from kubernetes_tpu_torch.sched.volumebinding import node_attach_limit
        for k, n in enumerate(nodes):
            i = rows[k]
            node_valid[i] = True
            unschedulable[i] = n.spec.unschedulable
            alloc = n.allocatable_canonical()
            for r_idx, r in enumerate(meta.resources):
                if r in alloc:
                    allocatable[i, r_idx] = min(
                        scale_allocatable(r, alloc[r]), UNLIMITED)
                elif r == "pods":
                    allocatable[i, r_idx] = UNLIMITED
            for kid, vid in tmpl_labels[k].items():
                node_labels[i, kid] = vid
            for t_idx, (tk, tv, te) in enumerate(tmpl_taints[k]):
                taint_key[i, t_idx] = tk
                taint_val[i, t_idx] = tv
                taint_effect[i, t_idx] = te
                taint_valid[i, t_idx] = True
            lim = node_attach_limit(n.status.allocatable)
            if lim >= 0:
                attach_limit[i] = lim

        # label values the templates interned may spill past the V bucket
        V2 = max(np.asarray(ct.label_value_num).shape[0],
                 next_bucket(len(self.values), minimum=1))
        label_value_num = np.full(V2, np.nan, np.float32)
        nums = self.values.numeric_values()
        label_value_num[:len(nums)] = np.asarray(nums, np.float32)

        return ct.replace(
            allocatable=allocatable, requested=requested,
            node_valid=node_valid, unschedulable=unschedulable,
            node_labels=node_labels, label_value_num=label_value_num,
            taint_key=taint_key, taint_val=taint_val,
            taint_effect=taint_effect, taint_valid=taint_valid,
            port_proto=port_proto, port_port=port_port, port_ip=port_ip,
            port_valid=port_valid, node_images=node_images,
            used_rwo=used_rwo, used_rwo_valid=used_rwo_valid,
            attach_used=attach_used, attach_limit=attach_limit,
        ), rows

    def without_pods(self, ct: ClusterTensors, meta: "SnapshotMeta",
                     pod_keys: list[str]) -> Optional[ClusterTensors]:
        """``with_hypothetical`` in reverse: mask bound pods OUT of an
        encoded snapshot — the descheduler's "what does the cluster look
        like after these evictions?" question. The victims' epod rows
        invalidate (their relational footprint — anti-affinity symmetry,
        spread counts — disappears) and their request vectors leave
        ``requested``; everything else is shared with the source encoding.

        Ephemeral and copy-on-write like the other overlays: the
        incremental-patch bookkeeping still considers the pods resident
        (use ``apply_pod_deltas`` for a real delete). Returns None when a
        key is outside the current patch state or carries port/volume node
        state an overlay cannot reconstruct — callers fall back to a full
        re-encode without the victims.

        An encoding held in torch tensors stays on their device: the
        subtraction runs as one scatter there (encode/overlay.py).
        """
        st = self._patch
        if st is None or st.generation != meta.generation:
            return None
        if any(k in st.unpatchable for k in pod_keys):
            return None
        if any(k not in st.slot_of for k in pod_keys):
            return None
        if _is_device_backed(ct):
            from kubernetes_tpu_torch.encode import overlay
            return overlay.resident_without_pods(st, ct, pod_keys)
        requested = np.array(ct.requested)
        epod_valid = np.array(ct.epod_valid)
        for k in set(pod_keys):
            requested[st.slot_node[k]] -= st.slot_req[k]
            epod_valid[st.slot_of[k]] = False
        return ct.replace(requested=requested, epod_valid=epod_valid)

    def with_nominated(self, ct: ClusterTensors, meta: "SnapshotMeta",
                       nominated: list, min_m: int = 0) -> ClusterTensors:
        """Overlay nominated-pod reservations onto an encoded snapshot.
        ``nominated``: [(node_name, priority, Pod)]. Cheap (tiny M-bucketed
        arrays), so it applies on every scheduling cycle without touching the
        incremental-patch bookkeeping. ``min_m`` pins the bucket: a
        preemption storm's nominee count varies per cycle, and a stable M
        keeps the batch shapes stable."""
        R = ct.nom_req.shape[1]
        entries = [(meta.node_index[n], prio,
                    self._request_vector(p, meta.resources))
                   for (n, prio, p) in nominated if n in meta.node_index]
        M = next_bucket(max(len(entries), min_m), minimum=1) \
            if entries or min_m else 0
        nom_node = np.full(M, -1, np.int32)
        nom_prio = np.zeros(M, np.int32)
        nom_req = np.zeros((M, R), np.int32)
        nom_valid = np.zeros(M, bool)
        for m, (ni, prio, vec) in enumerate(entries):
            nom_node[m] = ni
            nom_prio[m] = prio
            nom_req[m] = vec
            nom_valid[m] = True
        return ct.replace(nom_node=nom_node, nom_prio=nom_prio,
                          nom_req=nom_req, nom_valid=nom_valid)

    # -- incremental pod deltas --------------------------------------------

    def _effective_requests(self, p: Pod) -> dict:
        """resource -> canonical amount."""
        return dict(p.resource_requests())

    def _request_vector(self, p: Pod, resources: list[str]) -> np.ndarray:
        reqs = self._effective_requests(p)
        vec = np.zeros(len(resources), np.int32)
        for r_idx, r in enumerate(resources):
            if r in reqs:
                vec[r_idx] = scale_request(r, reqs[r])
        return vec

    def apply_pod_deltas(self, ct: ClusterTensors, meta: SnapshotMeta,
                         upserts: list[Pod], deletes: list[str],
                         ) -> Optional[ClusterTensors]:
        """Patch bound-pod deltas into an existing host encoding without a
        full re-encode (the reference's incremental ``Cache.UpdateSnapshot``).

        Returns the patched ClusterTensors (copy-on-write on touched arrays),
        or None when a delta doesn't fit the encoded buckets (new label key,
        more anti-affinity terms than reserved, pod with host ports/volumes,
        unknown node, no free slot) — the caller then falls back to a full
        encode_cluster.
        """
        st = self._patch
        if st is None or st.generation != meta.generation:
            return None
        if any(k in st.unpatchable for k in deletes) or \
                any(p.key in st.unpatchable for p in upserts):
            return None

        # ---- validate + compile everything before mutating anything ------
        compiled = []
        for p in upserts:
            if p.spec.volumes or p.host_ports():
                return None          # port/volume node state isn't patchable
            ni = st.node_index.get(p.spec.node_name, -1)
            if ni < 0:
                return None
            reqs = self._effective_requests(p)
            if any(r not in st.res_index for r in reqs):
                return None          # new resource kind widens R
            label_ids = self._label_ids(p.metadata.labels)
            if any(kid >= st.K for kid in label_ids):
                return None          # label key beyond the K bucket
            aff = p.spec.affinity
            pan = aff.pod_anti_affinity if aff else None
            terms = []
            for t in (pan.required if pan else []):
                eff = affinity_term_selector(t, p.metadata.labels)
                valid, exprs = self._compile_selector(eff)
                if t.namespace_selector is not None:
                    self._cluster_ns_selector_terms = True
                ns_set = resolve_term_namespaces(
                    t, p.metadata.namespace, self._namespace_labels)
                ns_ids = (None if ns_set is None else
                          tuple(self.namespaces.intern(n) for n in sorted(ns_set)))
                terms.append((self.keys.intern(t.topology_key), valid, exprs,
                              ns_ids))
            if (len(terms) > st.ET
                    or any(len(ex) > st.EAX for (_, _, ex, _) in terms)
                    or any(len(v) > st.EAV for (_, _, ex, _) in terms
                           for (_, _, v, _) in ex)
                    or any(nid >= st.NSB for (_, _, _, ns) in terms
                           if ns is not None for nid in ns)):
                return None  # ns beyond the NSB bucket widens the mask
            compiled.append((p, ni, label_ids, terms,
                             self._request_vector(p, st.resources)))

        freed = sum(1 for k in set(deletes) if k in st.slot_of)
        needed = sum(1 for (p, *_rest) in compiled if p.key not in st.slot_of)
        if needed > len(st.free) + freed:
            return None

        # ---- copy-on-write the arrays a pod delta touches ----------------
        requested = np.array(ct.requested)
        epod_node = np.array(ct.epod_node)
        epod_ns = np.array(ct.epod_ns)
        epod_labels = np.array(ct.epod_labels)
        epod_valid = np.array(ct.epod_valid)
        ea = {f: np.array(getattr(ct.ea_sel, f))
              for f in ("key", "op", "vals", "expr_valid", "valid")}
        ea_topo = np.array(ct.ea_topo)
        ea_valid = np.array(ct.ea_valid)
        ea_ns_explicit = np.array(ct.ea_ns_explicit)
        ea_ns_mask = np.array(ct.ea_ns_mask)

        def _clear(slot: int):
            epod_valid[slot] = False
            epod_labels[slot, :] = -1
            ea_topo[slot, :] = -1
            ea_valid[slot, :] = False
            ea["valid"][slot, :] = False
            ea["expr_valid"][slot, :, :] = False
            ea["key"][slot, :, :] = -1
            ea["vals"][slot, :, :, :] = -1
            ea_ns_explicit[slot, :] = False
            ea_ns_mask[slot, :, :] = False

        for k in set(deletes):
            slot = st.slot_of.pop(k, None)
            if slot is None:
                continue
            requested[st.slot_node.pop(k)] -= st.slot_req.pop(k)
            _clear(slot)
            st.free.append(slot)

        new_topo: set[int] = set()
        for p, ni, label_ids, terms, req_vec in compiled:
            key = p.key
            slot = st.slot_of.get(key)
            if slot is not None:
                requested[st.slot_node[key]] -= st.slot_req[key]
                _clear(slot)
            else:
                slot = st.free.pop()
                st.slot_of[key] = slot
            epod_node[slot] = ni
            epod_ns[slot] = self.namespaces.intern(p.metadata.namespace)
            for kid, vid in label_ids.items():
                epod_labels[slot, kid] = vid
            epod_valid[slot] = True
            for t_idx, (topo, valid, exprs, ns_ids) in enumerate(terms):
                ea_topo[slot, t_idx] = topo
                ea_valid[slot, t_idx] = True
                _selset_fill(ea, (slot, t_idx), valid, exprs)
                if ns_ids is not None:
                    ea_ns_explicit[slot, t_idx] = True
                    for nid in ns_ids:
                        ea_ns_mask[slot, t_idx, nid] = True
                new_topo.add(topo)
            requested[ni] += req_vec
            st.slot_node[key] = ni
            st.slot_req[key] = req_vec

        if new_topo - set(meta.topo_keys):
            self._cluster_topo_keys |= new_topo
            meta.topo_keys = tuple(sorted(set(meta.topo_keys) | new_topo))
        return ct.replace(
            requested=requested, epod_node=epod_node, epod_ns=epod_ns,
            epod_labels=epod_labels, epod_valid=epod_valid,
            ea_sel=SelectorSet(**ea), ea_topo=ea_topo, ea_valid=ea_valid,
            ea_ns_explicit=ea_ns_explicit, ea_ns_mask=ea_ns_mask,
        )

    # -- selector compilation ----------------------------------------------

    def _compile_requirement(self, req: Requirement):
        kid = self.keys.intern(req.key)
        opc = OPC[req.operator]
        vals = [self.values.intern(v) for v in req.values]
        num = math.nan
        if req.operator in (OP_GT, OP_LT) and req.values:
            try:
                num = float(int(req.values[0]))
            except (TypeError, ValueError):
                num = math.nan
        return kid, opc, vals, num

    def _compile_terms(self, term_weight_pairs: list[tuple[NodeSelectorTerm, float]],
                       caps: tuple[int, int, int]):
        """-> per-pod lists ready for array fill: [(weight, [exprs...])]."""
        out = []
        for term, weight in term_weight_pairs:
            exprs = []
            for e in term.match_expressions:
                exprs.append(self._compile_requirement(e))
            for e in term.match_fields:
                # matchFields address node fields; metadata.name is the only
                # field the reference supports. It rides the pseudo-label.
                exprs.append(self._compile_requirement(
                    Requirement(NODE_NAME_LABEL, e.operator, e.values)))
            out.append((weight, exprs))
        return out

    def _compile_selector(self, sel: Optional[LabelSelector]):
        """LabelSelector -> (valid, [compiled exprs]); None -> invalid
        (nil matches nothing), empty -> valid with no exprs (matches all)."""
        if sel is None:
            return (False, [])
        return (True, [self._compile_requirement(r) for r in sel.requirements()])

    # -- pod side -----------------------------------------------------------

    def _compile_pod(self, p: Pod) -> dict:
        """Host-side compile of ONE pod: selectors/affinity terms to int-set
        tables, tolerations/ports/images interned. This is the expensive
        half of ``encode_pods`` (the array fill is cheap); it only reads the
        intern tables (append-only) and the volume/namespace/DRA catalogs,
        so it can run at informer-event time (``precompile_pod``) instead of
        on the drain hot path."""
        aff = p.spec.affinity
        na = aff.node_affinity if aff else None
        req_pairs = [(t, 1.0) for t in (na.required if na else [])]
        pref_pairs = [(t.preference, float(t.weight)) for t in (na.preferred if na else [])]
        req_terms = self._compile_terms(req_pairs, (0, 0, 0))
        pref_terms = self._compile_terms(pref_pairs, (0, 0, 0))
        sel = [(self.keys.intern(k), self.values.intern(v))
               for k, v in sorted(p.spec.node_selector.items())]
        tols = []
        for t in p.spec.tolerations:
            tols.append((
                self.keys.intern(t.key) if t.key else -1,
                TOLOPC_EXISTS if t.operator == TOL_OP_EXISTS else TOLOPC_EQUAL,
                self.values.intern(t.value) if t.value else self.values.intern(""),
                EFFECTC[t.effect] if t.effect else -1,
            ))
        ports = [(PROTOC.get(proto, 3), port, self.ips.intern(ip))
                 for (ip, proto, port) in p.host_ports()]
        images = []
        for c in p.spec.containers:
            if c.image:
                images.append(self._intern_image(c.image))
        pa = aff.pod_affinity if aff else None
        pan = aff.pod_anti_affinity if aff else None
        own_ns = self.namespaces.intern(p.metadata.namespace)

        def _term_ns(t):
            ns_set = resolve_term_namespaces(
                t, p.metadata.namespace, self._namespace_labels)
            return (None if ns_set is None else
                    tuple(self.namespaces.intern(n) for n in sorted(ns_set)))

        def _pod_terms(terms):
            out = []
            for t in terms:
                eff = affinity_term_selector(t, p.metadata.labels)
                valid, exprs = self._compile_selector(eff)
                out.append((self.keys.intern(t.topology_key), valid, exprs,
                            _term_ns(t)))
            return out

        aff_req = _pod_terms(pa.required if pa else [])
        anti_req = _pod_terms(pan.required if pan else [])
        paff = []
        for wt in (pa.preferred if pa else []):
            kid = self.keys.intern(wt.term.topology_key)
            eff = affinity_term_selector(wt.term, p.metadata.labels)
            valid, exprs = self._compile_selector(eff)
            paff.append((kid, valid, exprs, float(wt.weight),
                         _term_ns(wt.term)))
        for wt in (pan.preferred if pan else []):
            kid = self.keys.intern(wt.term.topology_key)
            eff = affinity_term_selector(wt.term, p.metadata.labels)
            valid, exprs = self._compile_selector(eff)
            paff.append((kid, valid, exprs, -float(wt.weight),
                         _term_ns(wt.term)))
        spreads = []
        for sc in p.spec.topology_spread_constraints:
            eff = spread_selector(sc, p.metadata.labels)
            valid, exprs = self._compile_selector(eff)
            spreads.append((self.keys.intern(sc.topology_key), valid, exprs,
                            int(sc.max_skew),
                            sc.when_unsatisfiable == "DoNotSchedule",
                            int(sc.min_domains or 0),
                            sc.node_affinity_policy != NODE_INCLUSION_IGNORE,
                            sc.node_taints_policy == NODE_INCLUSION_HONOR))
        labels = self._label_ids(p.metadata.labels)
        # volumes: PVC groups -> (group_id, compiled term) pairs
        from kubernetes_tpu_torch.sched.volumebinding import compile_pod_volumes
        vinfo = compile_pod_volumes(p, self._volumes, self._rwop_in_use)
        vol_terms = []
        for g_idx, group in enumerate(vinfo.groups):
            for _w, exprs in self._compile_terms([(t, 1.0) for t in group],
                                                 (0, 0, 0)):
                vol_terms.append((g_idx, exprs))
        vol_rwo = [self.pv_names.intern(n) for n in vinfo.rwo_pv_names]
        return dict(
            pod=p, req_terms=req_terms, pref_terms=pref_terms, sel=sel,
            tols=tols, ports=ports, images=images, labels=labels, ns=own_ns,
            aff_req=aff_req, anti_req=anti_req, paff=paff, spreads=spreads,
            vol_terms=vol_terms, vol_groups=len(vinfo.groups),
            vol_rwo=vol_rwo, attach_req=vinfo.attach_count,
        )

    def precompile_pod(self, p: Pod) -> bool:
        """Compile a pod's encode record AND its numpy row pack AHEAD of
        batch-encode time — the informer layer calls this per watch event,
        so by the time the drain pops the pod, ``encode_pods`` pays one
        np.stack per field, zero per-pod fill work (the incremental-encode
        half of the connected-path pipeline; see sched/cache.py
        precompile_pod for the locking discipline).

        Volume-carrying pods are skipped: their compile reads catalog state
        (``_rwop_in_use``) that every cluster encode rewrites. Returns True
        when the record was cached."""
        if p.spec.volumes:
            return False
        if len(self._pod_cache) >= self._pod_cache_max:
            self._pod_cache.clear()  # backstop; steady state evicts per key
        epoch = self._epoch_for(p)
        c = self._compile_pod(p)
        sig = pack = None
        if self._row_sig is not None:
            resources, K, NSB, w = self._row_env
            res_index = {r: i for i, r in enumerate(resources)}
            if all(r in res_index for r in self._effective_requests(p)):
                try:
                    pack = self._build_rows(c, resources, K, NSB, w)
                    sig = self._row_sig
                except IndexError:
                    # the pod outgrows the current buckets (wider terms, a
                    # key past K, ...): encode_pods promotes the signature
                    # when this pod actually pops, and fills its rows then
                    pack = None
        self._pod_cache[p.key] = [p, epoch, c, sig, pack]
        return True

    def pod_cache_discard(self, key: str) -> None:
        """Drop a pod's precompiled record — bound/deleted pods never
        encode again, and keeping their Pod + compiled tables alive would
        grow the cache to the wholesale-clear backstop (which would dump
        live pending pods' records too). Plain dict.pop: GIL-atomic, safe
        from informer threads WITHOUT the encode lock (a concurrent
        encode_pods either sees the entry or recompiles; both correct)."""
        self._pod_cache.pop(key, None)

    def encode_pods(self, pods: list[Pod], meta: SnapshotMeta,
                    min_p: int = 1, cache_rows: bool = True) -> PodBatch:
        """``min_p`` pins the pod-axis bucket floor so callers with a fixed
        batch shape (the fused drain) never trigger a smaller-bucket
        recompile for a partial chunk. ``cache_rows=False`` skips storing
        compile records for misses — for callers encoding DERIVED pod
        objects (a profile's addedAffinity wrap) whose identity will never
        be seen again; storing those would evict live precompiled records."""
        P = next_bucket(len(pods), minimum=min_p)
        R = len(meta.resources)
        meta.pod_keys = [p.key for p in pods]
        n = len(pods)

        # First pass: compile everything host-side, find bucket sizes.
        # Pods precompiled at informer-event time (``precompile_pod``) skip
        # the compile entirely — the drain hot path then assembles their
        # PREBUILT rows. Identity + epoch guard staleness: a new watch
        # object or any catalog change (volumes/namespaces/DRA) misses.
        compiled = []
        entries: list[Optional[list]] = []  # live cache record per pod
        for p in pods:
            ent = self._pod_cache.get(p.key)
            if (ent is not None and ent[0] is p
                    and ent[1] == self._epoch_for(p)):
                compiled.append(ent[2])
                entries.append(ent)
                self.pod_cache_hits += 1
                continue
            # snapshot the epoch BEFORE compiling: a catalog change racing
            # the compile (informer threads bump the epoch without the
            # encode lock) must invalidate this record, not get tagged on it
            epoch = self._epoch_for(p)
            c = self._compile_pod(p)
            compiled.append(c)
            self.pod_cache_misses += 1
            ent = None
            if cache_rows and not p.spec.volumes:
                # failure re-pops carry the SAME Pod object back through
                # here — cache so the retry encode is stack-only too
                if len(self._pod_cache) >= self._pod_cache_max:
                    self._pod_cache.clear()
                ent = [p, epoch, c, None, None]
                self._pod_cache[p.key] = ent
            entries.append(ent)

        K = next_bucket(len(self.keys), minimum=1)

        def _bucket(fn, minimum=0):
            return next_bucket(max((fn(c) for c in compiled), default=0), minimum=minimum)

        w = {}
        w["TREQ"] = _bucket(lambda c: len(c["req_terms"]))
        w["TPREF"] = _bucket(lambda c: len(c["pref_terms"]))
        w["VT"] = _bucket(lambda c: len(c["vol_terms"]))
        w["VG"] = _bucket(lambda c: c["vol_groups"])
        w["VB"] = _bucket(lambda c: len(c["vol_rwo"]))
        w["X"] = _bucket(lambda c: max((len(e) for _, e in c["req_terms"] + c["pref_terms"]
                                        + c["vol_terms"]), default=0))
        w["VV"] = _bucket(lambda c: max((len(v) for _, ex in c["req_terms"] + c["pref_terms"]
                                         + c["vol_terms"]
                                         for (_, _, v, _) in ex), default=0))
        w["S"] = _bucket(lambda c: len(c["sel"]))
        w["TOL"] = _bucket(lambda c: len(c["tols"]))
        w["PP"] = _bucket(lambda c: len(c["ports"]))
        w["CI"] = _bucket(lambda c: len(c["images"]))
        w["AT"] = _bucket(lambda c: len(c["aff_req"]))
        w["BT"] = _bucket(lambda c: len(c["anti_req"]))
        w["CT"] = _bucket(lambda c: len(c["paff"]))
        w["SC"] = _bucket(lambda c: len(c["spreads"]))
        AX = _bucket(lambda c: max((len(e) for (_, _, e, _) in c["aff_req"] + c["anti_req"]), default=0))
        AX = max(AX, _bucket(lambda c: max((len(e) for (_, _, e, _, _) in c["paff"]), default=0)))
        AX = max(AX, _bucket(lambda c: max((len(t[2]) for t in c["spreads"]), default=0)))
        AV = _bucket(lambda c: max((len(v) for (_, _, e, _) in c["aff_req"] + c["anti_req"]
                                    for (_, _, v, _) in e), default=0))
        AV = max(AV, _bucket(lambda c: max((len(v) for (_, _, e, _, _) in c["paff"]
                                            for (_, _, v, _) in e), default=0)))
        AV = max(AV, _bucket(lambda c: max((len(v) for t in c["spreads"]
                                            for (_, _, v, _) in t[2]), default=0)))
        w["AX"], w["AV"] = AX, AV
        # sticky promotion: widths never shrink across encodes, so a pod's
        # prebuilt row pack stays valid batch to batch (padding is inert
        # behind validity flags; stable widths also mean stable compiled
        # program shapes — unify_batches/pad_batch_to become no-ops in
        # steady state)
        for k in _ROW_DIMS:
            w[k] = max(w[k], self._row_widths.get(k, 0))
        self._row_widths = {k: w[k] for k in _ROW_DIMS}
        # namespace-mask width: all term ns sets are already interned above
        NSB = next_bucket(len(self.namespaces) + self.ns_headroom, minimum=1)
        sig = (tuple(meta.resources), K, NSB) + tuple(w[k] for k in _ROW_DIMS)
        self._row_sig = sig
        self._row_env = (list(meta.resources), K, NSB, dict(w))

        # Second pass: one row pack per pod — PREBUILT at informer-event
        # time when the signature matches (the steady state: zero per-pod
        # fill work on this path), built here otherwise and cached back so
        # failure re-pops stack too.
        packs = []
        forced = []
        image_bytes_v = []
        for (c, ent) in zip(compiled, entries):
            if ent is not None and ent[3] == sig and ent[4] is not None:
                packs.append(ent[4])
                self.pod_rows_stacked += 1
            else:
                pk = self._build_rows(c, meta.resources, K, NSB, w)
                self.pod_rows_filled += 1
                if ent is not None:
                    ent[3], ent[4] = sig, pk
                packs.append(pk)
            p: Pod = c["pod"]
            # scalars a cached pack must not freeze: node pinning reads the
            # CURRENT node_index and DRA allocation state; image bytes read
            # the live size table (node status may raise a size later)
            fn = -1
            if p.spec.node_name:
                fn = meta.node_index.get(p.spec.node_name, -2)
            forced.append(fn)
            image_bytes_v.append(
                float(sum(self._image_sizes[im] for im in c["images"]))
                if c["images"] else 0.0)

        TREQ, TPREF, VT, VG, VB = w["TREQ"], w["TPREF"], w["VT"], w["VG"], w["VB"]
        X, VV, S, TOL, PP, CI = w["X"], w["VV"], w["S"], w["TOL"], w["PP"], w["CI"]
        AT, BT, CT, SC = w["AT"], w["BT"], w["CT"], w["SC"]

        def _new_termset(T):
            return dict(
                key=np.full((P, T, X), -1, np.int32),
                op=np.zeros((P, T, X), np.int32),
                vals=np.full((P, T, X, VV), -1, np.int32),
                num=np.full((P, T, X), np.nan, np.float32),
                expr_valid=np.zeros((P, T, X), bool),
                term_valid=np.zeros((P, T), bool),
                weight=np.zeros((P, T), np.float32),
                has_any=np.zeros(P, bool),
            )

        req_a = _new_termset(TREQ)
        pref_a = _new_termset(TPREF)
        vol_a = _new_termset(VT)
        vol_group = np.full((P, VT), -1, np.int32)
        vol_group_valid = np.zeros((P, VG), bool)
        rwo_pv = np.full((P, VB), -1, np.int32)
        rwo_valid = np.zeros((P, VB), bool)
        attach_req = np.zeros(P, np.int32)

        def _new_selset(shape_prefix):
            return _selset_arrays(shape_prefix, AX, AV)

        requests = np.zeros((P, R), np.int32)
        pod_valid = np.zeros(P, bool)
        priority = np.zeros(P, np.int32)
        forced_node = np.full(P, -1, np.int32)
        pod_ns = np.full(P, -1, np.int32)
        pod_labels = np.full((P, K), -1, np.int32)
        tol_key = np.full((P, TOL), -1, np.int32)
        tol_op = np.zeros((P, TOL), np.int32)
        tol_val = np.full((P, TOL), -1, np.int32)
        tol_effect = np.full((P, TOL), -1, np.int32)
        tol_valid = np.zeros((P, TOL), bool)
        sel_key = np.full((P, S), -1, np.int32)
        sel_val = np.full((P, S), -1, np.int32)
        sel_valid = np.zeros((P, S), bool)
        pport_proto = np.full((P, PP), -1, np.int32)
        pport_port = np.full((P, PP), -1, np.int32)
        pport_ip = np.full((P, PP), -1, np.int32)
        pport_valid = np.zeros((P, PP), bool)
        pod_images = np.full((P, CI), -1, np.int32)
        image_bytes = np.zeros(P, np.float32)
        aff_sel = _new_selset((P, AT))
        aff_topo = np.full((P, AT), -1, np.int32)
        aff_valid = np.zeros((P, AT), bool)
        aff_ns_explicit = np.zeros((P, AT), bool)
        aff_ns_mask = np.zeros((P, AT, NSB), bool)
        anti_sel = _new_selset((P, BT))
        anti_topo = np.full((P, BT), -1, np.int32)
        anti_valid = np.zeros((P, BT), bool)
        anti_ns_explicit = np.zeros((P, BT), bool)
        anti_ns_mask = np.zeros((P, BT, NSB), bool)
        paff_sel = _new_selset((P, CT))
        paff_topo = np.full((P, CT), -1, np.int32)
        paff_weight = np.zeros((P, CT), np.float32)
        paff_valid = np.zeros((P, CT), bool)
        paff_ns_explicit = np.zeros((P, CT), bool)
        paff_ns_mask = np.zeros((P, CT, NSB), bool)
        sc_sel = _new_selset((P, SC))
        sc_topo = np.full((P, SC), -1, np.int32)
        sc_maxskew = np.ones((P, SC), np.int32)
        sc_hard = np.zeros((P, SC), bool)
        sc_valid = np.zeros((P, SC), bool)
        sc_min_domains = np.zeros((P, SC), np.int32)
        sc_honor_affinity = np.zeros((P, SC), bool)
        sc_honor_taints = np.zeros((P, SC), bool)

        # ---- assembly: one bulk np.stack per field (no per-pod fill) -----
        if n:
            def put(dst, key):
                dst[:n] = np.stack([pk[key] for pk in packs])

            def put_scalar(dst, key, dtype):
                dst[:n] = np.fromiter((pk[key] for pk in packs), dtype, n)

            pod_valid[:n] = True
            forced_node[:n] = forced
            image_bytes[:n] = image_bytes_v
            put(requests, "requests")
            put_scalar(priority, "priority", np.int32)
            put_scalar(pod_ns, "ns", np.int32)
            put_scalar(attach_req, "attach_req", np.int32)
            put(pod_labels, "labels")
            for dst, f in ((tol_key, "tol_key"), (tol_op, "tol_op"),
                           (tol_val, "tol_val"), (tol_effect, "tol_effect"),
                           (tol_valid, "tol_valid")):
                put(dst, f)
            put(sel_key, "sel_key")
            put(sel_val, "sel_val")
            put(sel_valid, "sel_valid")
            for prefix, arrs in (("req", req_a), ("pref", pref_a),
                                 ("vol", vol_a)):
                for f in ("key", "op", "vals", "num", "expr_valid",
                          "term_valid", "weight"):
                    put(arrs[f], f"{prefix}_{f}")
                put_scalar(arrs["has_any"], f"{prefix}_has_any", bool)
            put(vol_group, "vol_group")
            put(vol_group_valid, "vol_group_valid")
            put(rwo_pv, "rwo_pv")
            put(rwo_valid, "rwo_valid")
            put(pport_proto, "port_proto")
            put(pport_port, "port_port")
            put(pport_ip, "port_ip")
            put(pport_valid, "port_valid")
            put(pod_images, "images")
            for prefix, selset, extras in (
                    ("aff", aff_sel,
                     ((aff_topo, "topo"), (aff_valid, "valid"),
                      (aff_ns_explicit, "ns_explicit"),
                      (aff_ns_mask, "ns_mask"))),
                    ("anti", anti_sel,
                     ((anti_topo, "topo"), (anti_valid, "valid"),
                      (anti_ns_explicit, "ns_explicit"),
                      (anti_ns_mask, "ns_mask"))),
                    ("paff", paff_sel,
                     ((paff_topo, "topo"), (paff_valid, "valid"),
                      (paff_weight, "weight"),
                      (paff_ns_explicit, "ns_explicit"),
                      (paff_ns_mask, "ns_mask"))),
                    ("sc", sc_sel,
                     ((sc_topo, "topo"), (sc_valid, "valid"),
                      (sc_maxskew, "maxskew"), (sc_hard, "hard"),
                      (sc_min_domains, "min_domains"),
                      (sc_honor_affinity, "honor_affinity"),
                      (sc_honor_taints, "honor_taints")))):
                for f in ("key", "op", "vals", "expr_valid", "valid"):
                    put(selset[f], f"{prefix}_sel_{f}")
                for dst, f in extras:
                    put(dst, f"{prefix}_{f}")

        batch_topo = {int(k) for k in np.concatenate([
            aff_topo[aff_valid], anti_topo[anti_valid],
            paff_topo[paff_valid], sc_topo[sc_valid]]).tolist()} if P else set()
        meta.topo_keys = tuple(sorted(set(meta.topo_keys) | batch_topo))

        return PodBatch(
            requests=requests, pod_valid=pod_valid, priority=priority,
            forced_node=forced_node, pod_ns=pod_ns, pod_labels=pod_labels,
            tol_key=tol_key, tol_op=tol_op, tol_val=tol_val, tol_effect=tol_effect,
            tol_valid=tol_valid,
            sel_key=sel_key, sel_val=sel_val, sel_valid=sel_valid,
            req_terms=TermSet(**req_a), pref_terms=TermSet(**pref_a),
            port_proto=pport_proto, port_port=pport_port, port_ip=pport_ip,
            port_valid=pport_valid,
            pod_images=pod_images, image_bytes=image_bytes,
            aff_sel=SelectorSet(**aff_sel), aff_topo=aff_topo, aff_valid=aff_valid,
            aff_ns_explicit=aff_ns_explicit, aff_ns_mask=aff_ns_mask,
            anti_sel=SelectorSet(**anti_sel), anti_topo=anti_topo, anti_valid=anti_valid,
            anti_ns_explicit=anti_ns_explicit, anti_ns_mask=anti_ns_mask,
            paff_sel=SelectorSet(**paff_sel), paff_topo=paff_topo,
            paff_weight=paff_weight, paff_valid=paff_valid,
            paff_ns_explicit=paff_ns_explicit, paff_ns_mask=paff_ns_mask,
            sc_sel=SelectorSet(**sc_sel), sc_topo=sc_topo, sc_maxskew=sc_maxskew,
            sc_hard=sc_hard, sc_valid=sc_valid,
            sc_min_domains=sc_min_domains, sc_honor_affinity=sc_honor_affinity,
            sc_honor_taints=sc_honor_taints,
            vol_terms=TermSet(**vol_a), vol_group=vol_group,
            vol_group_valid=vol_group_valid,
            rwo_pv=rwo_pv, rwo_valid=rwo_valid, attach_req=attach_req,
        )

    def _build_rows(self, c: dict, resources: list[str], K: int, NSB: int,
                    w: dict) -> dict:
        """ONE pod's PodBatch rows as small numpy arrays at the bucket
        signature ``(resources, K, NSB, w)`` — the per-pod half of the
        vectorized ``encode_pods`` assembly. Runs at informer-event time
        (``precompile_pod``) in the steady state; the batch hot path then
        does one np.stack per field and no per-pod fill work. Raises
        IndexError when the pod outgrows the widths (callers treat that as
        "no pack"; encode_pods always passes covering widths)."""
        X, VV, AX, AV = w["X"], w["VV"], w["AX"], w["AV"]
        p: Pod = c["pod"]
        rows: dict = {
            "priority": int(p.spec.priority), "ns": int(c["ns"]),
            "attach_req": int(c["attach_req"]),
        }

        rows["requests"] = self._request_vector(p, resources)

        labels = np.full(K, -1, np.int32)
        for kid, vid in c["labels"].items():
            labels[kid] = vid
        rows["labels"] = labels

        tol_key = np.full(w["TOL"], -1, np.int32)
        tol_op = np.zeros(w["TOL"], np.int32)
        tol_val = np.full(w["TOL"], -1, np.int32)
        tol_effect = np.full(w["TOL"], -1, np.int32)
        tol_valid = np.zeros(w["TOL"], bool)
        for t_idx, (kid, opc, vid, eff) in enumerate(c["tols"]):
            tol_key[t_idx], tol_op[t_idx] = kid, opc
            tol_val[t_idx], tol_effect[t_idx] = vid, eff
            tol_valid[t_idx] = True
        rows.update(tol_key=tol_key, tol_op=tol_op, tol_val=tol_val,
                    tol_effect=tol_effect, tol_valid=tol_valid)

        sel_key = np.full(w["S"], -1, np.int32)
        sel_val = np.full(w["S"], -1, np.int32)
        sel_valid = np.zeros(w["S"], bool)
        for s_idx, (kid, vid) in enumerate(c["sel"]):
            sel_key[s_idx], sel_val[s_idx] = kid, vid
            sel_valid[s_idx] = True
        rows.update(sel_key=sel_key, sel_val=sel_val, sel_valid=sel_valid)

        def termset_rows(prefix, T, terms):
            a = dict(
                key=np.full((T, X), -1, np.int32),
                op=np.zeros((T, X), np.int32),
                vals=np.full((T, X, VV), -1, np.int32),
                num=np.full((T, X), np.nan, np.float32),
                expr_valid=np.zeros((T, X), bool),
                term_valid=np.zeros(T, bool),
                weight=np.zeros(T, np.float32),
            )
            for t_idx, (weight, exprs) in enumerate(terms):
                a["term_valid"][t_idx] = True
                a["weight"][t_idx] = weight
                for x_idx, (kid, opc, vals, num) in enumerate(exprs):
                    a["key"][t_idx, x_idx] = kid
                    a["op"][t_idx, x_idx] = opc
                    a["num"][t_idx, x_idx] = num
                    a["expr_valid"][t_idx, x_idx] = True
                    for v_idx, v in enumerate(vals):
                        a["vals"][t_idx, x_idx, v_idx] = v
            for f, arr in a.items():
                rows[f"{prefix}_{f}"] = arr
            rows[f"{prefix}_has_any"] = len(terms) > 0

        vol_terms = [(float(g), e) for g, e in c["vol_terms"]]
        termset_rows("req", w["TREQ"], c["req_terms"])
        termset_rows("pref", w["TPREF"], c["pref_terms"])
        # vol terms reuse the TermSet layout with group id in place of
        # weight, then split the group id out into vol_group
        termset_rows("vol", w["VT"], vol_terms)
        vol_group = np.full(w["VT"], -1, np.int32)
        for t_idx, (g, _e) in enumerate(c["vol_terms"]):
            vol_group[t_idx] = g
        vol_group_valid = np.zeros(w["VG"], bool)
        vol_group_valid[:c["vol_groups"]] = True
        rwo_pv = np.full(w["VB"], -1, np.int32)
        rwo_valid = np.zeros(w["VB"], bool)
        for b_idx, pvid in enumerate(c["vol_rwo"]):
            rwo_pv[b_idx] = pvid
            rwo_valid[b_idx] = True
        rows.update(vol_group=vol_group, vol_group_valid=vol_group_valid,
                    rwo_pv=rwo_pv, rwo_valid=rwo_valid)

        port_proto = np.full(w["PP"], -1, np.int32)
        port_port = np.full(w["PP"], -1, np.int32)
        port_ip = np.full(w["PP"], -1, np.int32)
        port_valid = np.zeros(w["PP"], bool)
        for pt_idx, (proto, port, ip) in enumerate(c["ports"]):
            port_proto[pt_idx], port_port[pt_idx] = proto, port
            port_ip[pt_idx] = ip
            port_valid[pt_idx] = True
        rows.update(port_proto=port_proto, port_port=port_port,
                    port_ip=port_ip, port_valid=port_valid)

        images = np.full(w["CI"], -1, np.int32)
        for ci_idx, img in enumerate(c["images"]):
            images[ci_idx] = img
        rows["images"] = images

        def selset_rows(prefix, T, items, scalars):
            """items: [(topo, valid, exprs, *extras, ns_ids)] with extras
            per ``scalars``: [(name, dtype, default)]."""
            a = _selset_arrays((T,), AX, AV)
            topo = np.full(T, -1, np.int32)
            valid = np.zeros(T, bool)
            ns_explicit = np.zeros(T, bool)
            ns_mask = np.zeros((T, NSB), bool)
            extra_arrs = {nm: np.full(T, dflt, dt)
                          for nm, dt, dflt in scalars}
            for t_idx, item in enumerate(items):
                tk, sv, exprs = item[0], item[1], item[2]
                ns_ids = item[-1]
                topo[t_idx] = tk
                valid[t_idx] = True
                _selset_fill(a, (t_idx,), sv, exprs)
                for (nm, _dt, _df), val in zip(scalars, item[3:-1]):
                    extra_arrs[nm][t_idx] = val
                if ns_ids is not None:
                    ns_explicit[t_idx] = True
                    for nid in ns_ids:
                        ns_mask[t_idx, nid] = True
            for f, arr in a.items():
                rows[f"{prefix}_sel_{f}"] = arr
            rows[f"{prefix}_topo"] = topo
            rows[f"{prefix}_valid"] = valid
            rows[f"{prefix}_ns_explicit"] = ns_explicit
            rows[f"{prefix}_ns_mask"] = ns_mask
            for nm, arr in extra_arrs.items():
                rows[f"{prefix}_{nm}"] = arr

        selset_rows("aff", w["AT"], c["aff_req"], [])
        selset_rows("anti", w["BT"], c["anti_req"], [])
        selset_rows("paff", w["CT"], c["paff"],
                    [("weight", np.float32, 0.0)])
        # spreads: (topo, valid, exprs, skew, hard, mind, haff, htaint) —
        # no ns_ids slot, so append a None sentinel for the shared helper
        selset_rows("sc", w["SC"],
                    [t + (None,) for t in c["spreads"]],
                    [("maxskew", np.int32, 1), ("hard", bool, False),
                     ("min_domains", np.int32, 0),
                     ("honor_affinity", bool, False),
                     ("honor_taints", bool, False)])
        return rows
