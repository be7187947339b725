"""Resident overlay planning — three planners, one cluster image.

The PyTorch port of ``kubernetes_tpu/encode/overlay.py``. The live
scheduling path keeps ONE device-resident cluster encoding (the drain
context: encode once, fold winners on the device, patch churn). The
background planners — the autoscaler's scale-up/scale-down simulation, the
descheduler's eviction validation, gang defrag's prefix probing — would
otherwise re-encode the whole cluster cold every cycle. This module points
them at the resident image instead:

- ``ResidentPlanner`` adapts the scheduler's drain context into the three
  planners' shapes: a row permutation onto the planner's observed node
  list, host alloc/requested mirrors served by the staging shadow (no
  read-back from the card in steady state), and derived pod batches encoded
  against the RESIDENT meta under the cache's encode lock.
- The five programs below (ROADMAP B9, torch ops on the tensors' device)
  answer every planner question as one dispatch on the resident tensors:
  ``_plan_mask_program`` (feasibility mask + optional scores for eviction
  re-placement and scale-down), ``_overlay_mask_program`` (K node-group
  template rows appended to the node axis for scale-up —
  ``with_hypothetical`` without leaving the card), ``_overlay_ct_program``
  (the appended encoding itself), ``_quota_program`` (the per-tenant
  drain-slot quota plane) and ``_without_program`` (victims subtracted).
- Anything the resident image cannot answer EXACTLY — tainted context,
  unfolded deltas, node/bound-set skew vs. the planner's observation, a
  template or batch that overflows a resident bucket, a pod requesting a
  resource off the resident axis, a context that moved while a dispatch
  ran — DECLINES (counted, per planner, per reason) and the caller runs
  its cold-encode path. Plans are equal either way:
  ``tests/test_torch_planner.py`` fuzzes exactly this equivalence.

A failure of the card is not a decline: an exception of a dispatch or of a
read-back escapes to the caller (the reference's ``cluster_arrays`` turns
a failed read-back into a ``readback`` decline and a cold plan; the port
never moves work off the card to hide a fault).

Two algebraic facts make the overlay exact rather than approximate:

1. Nominee reservations: the resident image may carry an M-bucketed
   nominee plane; the planners' cold encodes carry M=0. Zeroing
   ``nom_valid`` makes the fit filter's reservation prefix-sums the
   identity, which is bit-identical to an M=0 encode.
2. Resource-axis superset: the resident axis may carry resources no
   current pod requests (historic bound pods). Such a column contributes
   requested=0 for every pod and node, so fit comparisons, score fractions
   (fixed cpu/memory columns) and ledger arithmetic are unchanged.

The ``label_value_num`` / ``image_sizes`` tables are the one part of the
resident image allowed to go stale (interning appends host-side between
full encodes), so every program takes FRESHLY built tables as inputs —
tiny vectors, rebuilt per dispatch under the encode lock.

Under a device mesh (parallel/mesh.py) the resident image is split over
the mesh's shards. ``mask_scores`` then dispatches on every shard (its
node slice, its pod rows; the score normalize reduces across shards) and
gathers the [P,N] answer; the scale-up overlay, whose template rows extend
the node axis, and the totals' read-back run on the gathered image (a
read-only copy on the lead device). A view built under an older mesh is
declined by the scheduler (``mesh_epoch``), and a reshape during a
dispatch declines it as ``raced``.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import threading
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from kubernetes_tpu_torch.device import resolve_device
from kubernetes_tpu_torch.encode.dictionary import next_bucket
from kubernetes_tpu_torch.encode.scaling import UNLIMITED, scale_allocatable
from kubernetes_tpu_torch.encode.snapshot import EFFECTC, NODE_NAME_LABEL
from kubernetes_tpu_torch.metrics.registry import SCHEDULER_PLANNER_OVERLAY
from kubernetes_tpu_torch.ops.filters import run_filters
from kubernetes_tpu_torch.ops.scores import combined_score
from kubernetes_tpu_torch.parallel import mesh as mesh_mod
from kubernetes_tpu_torch.utils.tracing import TRACER

_LOG = logging.getLogger(__name__)

# every ClusterTensors field with the node bucket as axis 0 — the set the
# template overlay widens (matches encode_cluster's node-side fill)
_NODE_AXIS_FIELDS = (
    "allocatable", "requested", "node_valid", "unschedulable",
    "node_labels", "taint_key", "taint_val", "taint_effect", "taint_valid",
    "port_proto", "port_port", "port_ip", "port_valid", "node_images",
    "used_rwo", "used_rwo_valid", "attach_used", "attach_limit",
)


@dataclass
class PlanMeta:
    """Host-side stand-in for ``SnapshotMeta`` on resident planner paths:
    the live node list in the PLANNER's observation order plus the resident
    resource axis — exactly the fields the host-side ledgers, binpacks and
    move records consume (``node_names``/``node_index``/``resources``)."""

    resources: list
    node_names: list
    node_index: dict
    generation: int = 0


# ---- first-seen shapes (what the CompileCounter counts) ---------------------

_SEEN: set = set()
_SEEN_LOCK = threading.Lock()
SHAPES_FIRST_SEEN = 0


def _shape_sig(x) -> tuple:
    if isinstance(x, torch.Tensor):
        return (str(x.device), str(x.dtype), tuple(x.shape))
    if dataclasses.is_dataclass(x):
        return tuple(_shape_sig(getattr(x, f.name))
                     for f in dataclasses.fields(x))
    if isinstance(x, dict):
        return tuple((k, _shape_sig(v)) for k, v in sorted(x.items()))
    if isinstance(x, (tuple, list)):
        return tuple(_shape_sig(v) for v in x)
    if isinstance(x, (frozenset, set)):
        return tuple(sorted(x))
    return (x,)


def _note_shapes(program: str, *args) -> None:
    """Count a B9 program's bucketed input signature the first time this
    process sees it. Eager PyTorch compiles nothing, but a new bucket is
    exactly where XLA would have compiled the reference's program: the
    planners' steady window must see none (BackgroundPlanner's gate)."""
    global SHAPES_FIRST_SEEN
    sig = (program,) + _shape_sig(args)
    with _SEEN_LOCK:
        if sig not in _SEEN:
            _SEEN.add(sig)
            SHAPES_FIRST_SEEN += 1


def _tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


# ---- the planner programs (ROADMAP B9, torch ops) ---------------------------

def _plan_mask_program(ct, pb, label_value_num, image_sizes, enabled,
                       want_scores):
    """Feasibility mask (and optionally scores) for a derived pod batch
    against the resident image: fresh intern tables swapped in, nominee
    plane neutralized (identical to an M=0 cold encode — see module doc)."""
    _note_shapes("plan_mask", ct, pb, label_value_num, image_sizes,
                 enabled, want_scores)
    ct = ct.replace(label_value_num=label_value_num, image_sizes=image_sizes,
                    nom_valid=torch.zeros_like(ct.nom_valid))
    mask = run_filters(ct, pb, enabled)
    if not want_scores:
        return mask
    return mask, combined_score(ct, pb, mask)


def _sharded_plan_mask(ct_s, pb, label_value_num, image_sizes, enabled,
                       want_scores):
    """``_plan_mask_program`` on every shard of a split resident image ->
    the gathered mask (and scores) on the lead device."""
    m = ct_s.mesh
    pbs = mesh_mod.shard_batch(m, pb)
    layout = mesh_mod.Layout(m, ct_s.layout.N,
                             int(np.shape(pb.pod_valid)[0]))

    def body(piece, pb_dev):
        d = pb_dev.pod_valid.device
        res = _plan_mask_program(piece, mesh_mod.pod_rows(pb_dev),
                                 _tensor(label_value_num, d),
                                 _tensor(image_sizes, d), enabled,
                                 want_scores)
        parts = res if want_scores else (res,)
        out = [mesh_mod.gather_pods(mesh_mod.gather_nodes(x, 1))
               for x in parts]
        return tuple(out) if want_scores else out[0]

    return mesh_mod.run(layout, body, [
        (piece, pbs[d]) for piece, d in zip(ct_s.pieces,
                                            m.device_list())])[0]


def _overlay_ct(ct, planes):
    """Append the K-bucketed template planes to every node-axis field and
    swap in the fresh tables — ``with_hypothetical`` on the device."""
    ext = {f: torch.cat([getattr(ct, f), planes[f]], dim=0)
           for f in _NODE_AXIS_FIELDS}
    return ct.replace(label_value_num=planes["label_value_num"],
                      image_sizes=planes["image_sizes"], **ext)


def _overlay_ct_program(ct, planes):
    _note_shapes("overlay_ct", ct, planes)
    return _overlay_ct(ct, planes)


def _overlay_mask_program(ct, planes, pb):
    _note_shapes("overlay_mask", ct, planes, pb)
    ct2 = _overlay_ct(ct, planes)
    ct2 = ct2.replace(nom_valid=torch.zeros_like(ct2.nom_valid))
    return run_filters(ct2, pb)


def _quota_program(victim_tenant, quotas):
    """allowed[v] = this victim's 0-based rank among ITS tenant's victims
    (in eviction order) is below the tenant's quota. -1 tenant or -1 quota
    = unlimited. ONE dispatch decides the whole cycle's quota verdicts.
    Every step stays int32 (torch's cumsum and sum would promote to
    int64), so ``UNLIMITED`` compares exactly as in the reference."""
    _note_shapes("quota", victim_tenant, quotas)
    T = quotas.shape[0]
    i32 = torch.int32
    hot = victim_tenant[:, None] == torch.arange(
        T, dtype=victim_tenant.dtype, device=victim_tenant.device)
    rank = torch.cumsum(hot.to(i32), dim=0, dtype=i32) - 1
    zero = torch.zeros((), dtype=i32, device=rank.device)
    my_rank = torch.where(hot, rank, zero).sum(dim=1, dtype=i32)
    unlimited = torch.full((), UNLIMITED, dtype=i32, device=rank.device)
    lim = torch.where(quotas < 0, unlimited, quotas)
    my_lim = torch.where(victim_tenant >= 0,
                         lim[victim_tenant.clamp(0, T - 1).long()],
                         unlimited)
    return my_rank < my_lim


def _without_program(ct, slot_rows, node_rows, req_delta):
    """The victims leave ``requested`` and their epod rows invalidate, on
    new tensors (the resident ones are never written). The padding
    entries carry out-of-range rows, which JAX's scatter drops: here they
    are filtered out by hand. ``index_add`` sums duplicate rows, so two
    victims on one node both subtract (an indexed ``-=`` would keep only
    one of the two writes)."""
    _note_shapes("without", ct, slot_rows, node_rows, req_delta)
    N = ct.requested.shape[0]
    E = ct.epod_valid.shape[0]
    keep_n = (node_rows >= 0) & (node_rows < N)
    requested = ct.requested.index_add(
        0, node_rows[keep_n].long(), -req_delta[keep_n])
    epod_valid = ct.epod_valid.clone()
    keep_e = (slot_rows >= 0) & (slot_rows < E)
    epod_valid[slot_rows[keep_e].long()] = False
    return ct.replace(requested=requested, epod_valid=epod_valid)


def tenant_quota_mask(tenant_ids: list, quotas: list,
                      device=None) -> np.ndarray:
    """Per-tenant drain-slot quota plane on the card. ``tenant_ids``: one
    int per victim in eviction order — an index into ``quotas`` (-1 =
    untenanted/unquotaed -> unlimited); ``quotas``: per-tenant eviction
    caps (-1 = unlimited). Returns the allowed[V] verdicts — the caller
    blocks any set containing a disallowed victim, with no host-side
    re-derivation of the arithmetic (power-of-two buckets keep the shapes
    stable across cycles). ``device`` None = the card."""
    device = resolve_device(device)
    V = next_bucket(len(tenant_ids), minimum=1)
    T = next_bucket(len(quotas), minimum=1)
    vt = np.full(V, -1, np.int32)
    vt[:len(tenant_ids)] = np.asarray(tenant_ids, np.int32)
    q = np.full(T, -1, np.int32)
    q[:len(quotas)] = np.asarray(quotas, np.int32)
    out = _quota_program(_tensor(vt, device), _tensor(q, device))
    return out.cpu().numpy()[:len(tenant_ids)]


# ---- host-side builders (call under the owning encoder's lock) --------------

def _fresh_tables(enc, V: int, IMG: int):
    """label_value_num/image_sizes rebuilt from the encoder's CURRENT
    intern tables at the resident bucket widths; None when either table
    outgrew its resident bucket (structural — the next full encode will
    widen it)."""
    if len(enc.values) > V or len(enc._image_sizes) > IMG:
        return None
    lvn = np.full(V, np.nan, np.float32)
    nums = enc.values.numeric_values()
    lvn[:len(nums)] = np.asarray(nums, np.float32)
    isz = np.zeros(IMG, np.float32)
    isz[:len(enc._image_sizes)] = enc._image_sizes
    return lvn, isz


def _tables_outgrown(enc, ct) -> bool:
    """The encoder's label-key, value or image table outgrew its resident
    bucket: the next full encode, which sizes the buckets from these
    tables, widens it."""
    return (len(enc.keys) > ct.node_labels.shape[1]
            or len(enc.values) > ct.label_value_num.shape[0]
            or len(enc._image_sizes) > ct.image_sizes.shape[0])


def _template_planes(enc, resources, ct, templates) -> Optional[dict]:
    """Node-axis plane rows (numpy) for K hypothetical template nodes at
    the RESIDENT bucket widths (same fill logic as ``with_hypothetical``'s
    numpy path), plus fresh tables. None when a template overflows a
    resident bucket (new label key past K, taints past T, value past V)."""
    from kubernetes_tpu_torch.sched.volumebinding import node_attach_limit
    Kdev = ct.node_labels.shape[1]
    Tdev = ct.taint_key.shape[1]
    PRT = ct.port_proto.shape[1]
    I = ct.node_images.shape[1]
    VN = ct.used_rwo.shape[1]
    R = ct.allocatable.shape[1]
    tmpl_labels = [enc._label_ids(n.metadata.labels,
                                  {NODE_NAME_LABEL: n.metadata.name})
                   for n in templates]
    tmpl_taints = [[(enc.keys.intern(t.key), enc.values.intern(t.value),
                     EFFECTC.get(t.effect, 0)) for t in n.spec.taints]
                   for n in templates]
    # only the TEMPLATES' label keys must address node_labels columns —
    # pod-side keys interned after the cluster encode (e.g. a gang label)
    # grow the shared table past Kdev without touching any node row
    if any(kid >= Kdev for ids in tmpl_labels for kid in ids):
        return None
    if max((len(t) for t in tmpl_taints), default=0) > Tdev:
        return None
    tables = _fresh_tables(enc, ct.label_value_num.shape[0],
                           ct.image_sizes.shape[0])
    if tables is None:
        return None
    KB = next_bucket(len(templates), minimum=1)
    planes = dict(
        allocatable=np.zeros((KB, R), np.int32),
        requested=np.zeros((KB, R), np.int32),
        node_valid=np.zeros(KB, bool),
        unschedulable=np.zeros(KB, bool),
        node_labels=np.full((KB, Kdev), -1, np.int32),
        taint_key=np.full((KB, Tdev), -1, np.int32),
        taint_val=np.full((KB, Tdev), -1, np.int32),
        taint_effect=np.full((KB, Tdev), -1, np.int32),
        taint_valid=np.zeros((KB, Tdev), bool),
        port_proto=np.full((KB, PRT), -1, np.int32),
        port_port=np.full((KB, PRT), -1, np.int32),
        port_ip=np.full((KB, PRT), -1, np.int32),
        port_valid=np.zeros((KB, PRT), bool),
        node_images=np.full((KB, I), -1, np.int32),
        used_rwo=np.full((KB, VN), -1, np.int32),
        used_rwo_valid=np.zeros((KB, VN), bool),
        attach_used=np.zeros(KB, np.int32),
        attach_limit=np.full(KB, UNLIMITED, np.int32),
    )
    for k, n in enumerate(templates):
        planes["node_valid"][k] = True
        planes["unschedulable"][k] = n.spec.unschedulable
        alloc = n.allocatable_canonical()
        for r_idx, r in enumerate(resources):
            if r in alloc:
                planes["allocatable"][k, r_idx] = min(
                    scale_allocatable(r, alloc[r]), UNLIMITED)
            elif r == "pods":
                planes["allocatable"][k, r_idx] = UNLIMITED
        for kid, vid in tmpl_labels[k].items():
            planes["node_labels"][k, kid] = vid
        for t_idx, (tk, tv, te) in enumerate(tmpl_taints[k]):
            planes["taint_key"][k, t_idx] = tk
            planes["taint_val"][k, t_idx] = tv
            planes["taint_effect"][k, t_idx] = te
            planes["taint_valid"][k, t_idx] = True
        lim = node_attach_limit(n.status.allocatable)
        if lim >= 0:
            planes["attach_limit"][k] = lim
    planes["label_value_num"], planes["image_sizes"] = tables
    return planes


def _planes_to(planes: dict, device) -> dict:
    return {k: _tensor(v, device) for k, v in planes.items()}


def resident_with_hypothetical(encoder, ct, meta, nodes):
    """``with_hypothetical`` against an encoding held in torch tensors:
    template planes host-built at the resident widths, appended by one
    concatenate per field on the tensors' device — the image never
    round-trips. Returns (ct_over, rows) with ct_over on that device, or
    None on bucket overflow (the encoder method then raises).
    Call under whatever lock guards the encoder's intern tables."""
    planes = _template_planes(encoder, meta.resources, ct, nodes)
    if planes is None:
        return None
    N = ct.node_valid.shape[0]
    return (_overlay_ct_program(ct, _planes_to(planes, ct.node_valid.device)),
            list(range(N, N + len(nodes))))


def resident_without_pods(st, ct, pod_keys):
    """``without_pods`` against an encoding held in torch tensors: the
    victims' request vectors leave ``requested`` and their epod rows
    invalidate in one scatter. ``st``: the encoder's patch state (the
    caller already validated generation/patchability/slot membership)."""
    keys = sorted(set(pod_keys))
    B = next_bucket(len(keys), minimum=1)
    E = ct.epod_valid.shape[0]
    N, R = ct.requested.shape
    slot_rows = np.full(B, E, np.int32)   # out-of-range pad: filtered out
    node_rows = np.full(B, N, np.int32)
    req_delta = np.zeros((B, R), np.int32)
    for i, k in enumerate(keys):
        slot_rows[i] = st.slot_of[k]
        node_rows[i] = st.slot_node[k]
        req_delta[i] = st.slot_req[k]
    device = ct.requested.device
    return _without_program(ct, _tensor(slot_rows, device),
                            _tensor(node_rows, device),
                            _tensor(req_delta, device))


# ---- compile accounting -----------------------------------------------------

class CompileCounter:
    """Counts, inside armed windows, what would cost a warm steady state
    time on the card: every ``nvcc`` build ``ops/kernels.build`` runs
    (``kernels.BUILDS``), every CUDA graph of the gang rounds captured
    (``models/graphs.CAPTURES``: the reference's XLA would compile the
    converge program there) and every bucketed input signature of a B9
    program seen for the first time in this process (``SHAPES_FIRST_SEEN``:
    the reference's XLA would compile the program anew there; eager
    PyTorch compiles nothing, so a new bucket is the event that stands for
    it).
    The BackgroundPlanner cadence and the smoke's PlannerLoop share it to
    prove a zero-compile steady window (the status key
    ``steadyCompiles``)."""

    def __init__(self):
        self.count = 0
        self._armed = False
        self._base = 0
        self._lock = threading.Lock()

    @staticmethod
    def _events() -> int:
        from kubernetes_tpu_torch.models import graphs
        from kubernetes_tpu_torch.ops import kernels
        return kernels.BUILDS + graphs.CAPTURES + SHAPES_FIRST_SEEN

    def arm(self) -> None:
        with self._lock:
            if not self._armed:
                self._armed = True
                self._base = self._events()

    def disarm(self) -> None:
        with self._lock:
            if self._armed:
                self.count += self._events() - self._base
                self._armed = False

    def take(self) -> int:
        with self._lock:
            if self._armed:
                return self.count + self._events() - self._base
            return self.count


# ---- the planner adapter ----------------------------------------------------

def _stamp(view: dict) -> tuple:
    """What moves when the resident context does: its build epoch, the
    delta-log position it consumed and its patch state's cursors."""
    cs = view["cs"]
    return (view["epoch"], view["seq"], cs.fill_host, cs.top)


class ResidentPlanner:
    """Adapter giving the three background planners resident fast paths.

    ``view_source``: ``Scheduler.resident_plan_view`` — ``() -> (view |
    None, reason)`` (untainted + all-folded delta log + nothing in flight)
    with decline reasons. ``cache``: the scheduler cache owning the live
    encoder and encode lock.

    Every method returns None on decline and counts (planner, reason); the
    caller then runs its cold-encode path, which produces an equal plan —
    residency is a latency optimization, never a semantic fork. Callers
    report success with ``hit(ctx)`` exactly once per fully-resident plan.

    The resident tensors are the live drain context, which ``drain_step``
    updates in place (the reference's arrays are immutable). A dispatch
    therefore re-reads the view once its result is back on the host: if a
    drain started or resolved in between (the context moved), the answer
    may mix two cluster states and the planner declines (``raced``)."""

    def __init__(self, view_source: Callable, cache):
        self._view_source = view_source
        self.cache = cache
        self.hits: dict = {}
        self.declines: dict = {}

    # -- accounting ---------------------------------------------------------

    def _decline(self, planner: str, reason: str):
        d = self.declines.setdefault(planner, {})
        d[reason] = d.get(reason, 0) + 1
        SCHEDULER_PLANNER_OVERLAY.inc({"planner": planner,
                                       "outcome": "decline"})
        return None

    def hit(self, ctx: dict) -> None:
        planner = ctx["planner"]
        self.hits[planner] = self.hits.get(planner, 0) + 1
        SCHEDULER_PLANNER_OVERLAY.inc({"planner": planner, "outcome": "hit"})

    def stats(self) -> dict:
        return {"hits": dict(self.hits),
                "declines": {k: dict(v) for k, v in self.declines.items()}}

    # -- view ---------------------------------------------------------------

    def plan_view(self, nodes, bound_pods, planner: str) -> Optional[dict]:
        """The resident image row-permuted onto THIS planner's observed
        node list, or None. Beyond the scheduler-side freshness checks,
        the planner's observation must agree with the image: same node
        set, same bound-pod set (the planners observe through the API
        client; any skew vs. the cache means the cold encode would see a
        different cluster than the image holds)."""
        view, reason = self._view_source()
        if view is None:
            return self._decline(planner, reason)
        meta = view["meta"]
        cs = view["cs"]
        names = {n.metadata.name for n in nodes}
        if names != {n.metadata.name for n in view["nodes"]}:
            return self._decline(planner, "node_set_skew")
        bound_keys = {p.key for p in bound_pods
                      if p.spec.node_name in names}
        if bound_keys != set(cs.slot_of):
            return self._decline(planner, "bound_set_skew")
        rows = np.asarray([meta.node_index[n.metadata.name] for n in nodes],
                          np.int32)
        plan_meta = PlanMeta(
            resources=list(cs.resources),
            node_names=[n.metadata.name for n in nodes],
            node_index={n.metadata.name: i for i, n in enumerate(nodes)},
            generation=meta.generation)
        return {"view": view, "ct": view["ct"], "meta": meta, "cs": cs,
                "rows": rows, "plan_meta": plan_meta, "planner": planner,
                "stamp": _stamp(view)}

    def _moved(self, ctx: dict) -> bool:
        """True when the context changed since ``plan_view``: it was
        rebuilt (``epoch``: a rebuild at the same shapes writes the new
        snapshot into the same tensors), a drain is in flight or resolved,
        a churn patch was folded (``seq``), or the view no longer
        stands."""
        view, _reason = self._view_source()
        if view is None or view["ct"] is not ctx["ct"]:
            return True
        return _stamp(view) != ctx["stamp"]

    # -- cluster totals ------------------------------------------------------

    def cluster_arrays(self, ctx: dict):
        """(allocatable, requested) int64 [N_live, R_resident] in the
        planner's node order — served from the staging shadow's host
        mirrors (no read-back) or one ``.cpu()`` of the resident totals.
        Unlike the reference, a failed read-back is not a decline: the
        exception escapes, since a fault of the card must not turn into a
        cold plan that hides it."""
        view = ctx["view"]
        cs = ctx["cs"]
        got = None
        shadow = view.get("shadow")
        if shadow is not None:
            shadow.catch_up(
                lambda p: self.cache.request_vector(p, cs.resources))
            got = shadow.arrays()
        if got is None:
            ct = mesh_mod.full_view(ctx["ct"])
            got = (ct.allocatable.cpu().numpy(), ct.requested.cpu().numpy())
        alloc_res, req_res = got
        rows = ctx["rows"]
        return (np.asarray(alloc_res, np.int64)[rows],
                np.asarray(req_res, np.int64)[rows])

    # -- derived pod batches -------------------------------------------------

    def _covered(self, enc, pods, resources) -> bool:
        res = set(resources)
        for p in pods:
            if any(r not in res for r in enc._effective_requests(p)):
                return False
        return True

    def pod_batch(self, ctx: dict, pods):
        """Encode a derived batch (unpinned victims, gang pods, pending
        pods) against the RESIDENT meta under the encode lock, plus fresh
        tables. Declines when a pod requests a resource off the resident
        axis (encode_pods would silently drop it) or a table outgrew its
        bucket. The meta is shallow-copied: encode_pods stamps
        ``meta.pod_keys`` and the drain's own meta must not see it."""
        meta = ctx["meta"]
        ct = ctx["ct"]
        V = ct.label_value_num.shape[0]
        IMG = ct.image_sizes.shape[0]

        def fn(enc):
            if not self._covered(enc, pods, meta.resources):
                return "resource_axis"
            pb = enc.encode_pods(list(pods), copy.copy(meta),
                                 cache_rows=False)
            tables = _fresh_tables(enc, V, IMG)
            if tables is None:
                return "table_bucket"
            return pb, tables

        with TRACER.span("planner/encode", pods=len(pods)):
            out = self.cache.with_encoder(fn)
        if isinstance(out, str):
            return self._decline(ctx["planner"], out)
        return out

    # -- dispatches ----------------------------------------------------------

    def mask_scores(self, ctx: dict, pods, enabled=None,
                    want_scores: bool = False):
        """ONE dispatch answering a batch's feasibility (and optionally
        scores) against the resident image. Returns (mask [P, N_live],
        scores [P, N_live] | None, reqs [P, R] int64) gathered into the
        planner's node order, or None on decline."""
        if not pods:
            n = len(ctx["plan_meta"].node_names)
            return (np.zeros((0, n), bool), None,
                    np.zeros((0, len(ctx["plan_meta"].resources)), np.int64))
        out = self.pod_batch(ctx, pods)
        if out is None:
            return None
        pb, (lvn, isz) = out
        P = len(pods)
        reqs = np.asarray(pb.requests[:P], np.int64)
        rows = ctx["rows"]
        with TRACER.span("planner/dispatch", pods=P):
            if isinstance(ctx["ct"], mesh_mod.ShardedCluster):
                res = _sharded_plan_mask(ctx["ct"], pb, lvn, isz, enabled,
                                         want_scores)
            else:
                device = ctx["ct"].node_valid.device
                res = _plan_mask_program(ctx["ct"], pb.to(device),
                                         _tensor(lvn, device),
                                         _tensor(isz, device), enabled,
                                         want_scores)
            if want_scores:
                mask, scores = (r.cpu().numpy() for r in res)
                got = (mask[:P][:, rows], scores[:P][:, rows], reqs)
            else:
                got = (res.cpu().numpy()[:P][:, rows], None, reqs)
        if self._moved(ctx):
            return self._decline(ctx["planner"], "raced")
        return got

    def overlay_mask(self, ctx: dict, templates, pods):
        """Scale-up: K template rows appended to the resident image, ONE
        run_filters over every (pending pod x candidate) question.
        Returns (mask [P, N_live + K] — live columns first, template
        columns after in group order — caps [K, R] and reqs [P, R], both
        int64 on the resident resource axis), or None."""
        if not pods or not templates:
            return None
        meta = ctx["meta"]
        ct = mesh_mod.full_view(ctx["ct"])

        def fn(enc):
            if not self._covered(enc, pods, meta.resources):
                return "resource_axis"
            planes = _template_planes(enc, meta.resources, ct, templates)
            if planes is None:
                outgrown.append(_tables_outgrown(enc, ct))
                return "template_bucket"
            pb = enc.encode_pods(list(pods), copy.copy(meta),
                                 cache_rows=False)
            return planes, pb

        outgrown: list = []
        with TRACER.span("planner/encode", pods=len(pods)):
            out = self.cache.with_encoder(fn)
        if isinstance(out, str):
            if any(outgrown):
                # the templates' labels are interned now, but only a full
                # encode widens the buckets, and a static fleet makes no
                # change that brings one: without it every cycle declines
                self.cache.request_full_encode()
            return self._decline(ctx["planner"], out)
        planes, pb = out
        P = len(pods)
        K = len(templates)
        caps = planes["allocatable"][:K].astype(np.int64)
        reqs = np.asarray(pb.requests[:P], np.int64)
        device = ct.node_valid.device
        with TRACER.span("planner/dispatch", pods=P):
            mask = _overlay_mask_program(ct, _planes_to(planes, device),
                                         pb.to(device)).cpu().numpy()
        N = ct.node_valid.shape[0]
        live = mask[:P][:, ctx["rows"]]
        tmpl = mask[:P, N:N + K]
        if self._moved(ctx):
            return self._decline(ctx["planner"], "raced")
        return np.concatenate([live, tmpl], axis=1), caps, reqs
