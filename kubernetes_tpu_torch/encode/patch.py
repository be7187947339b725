"""Churn patches for the device-resident drain context.

The PyTorch port of ``kubernetes_tpu/encode/patch.py``: host code (numpy)
whose patches equal the reference's array by array.

Reference shape: ``pkg/scheduler/internal/cache/cache.go`` keeps per-node
generation counters so ``UpdateSnapshot`` copies only what changed; the
scheduler never rebuilds its whole view because one node flapped. Here the
fused drain keeps the cluster encoding resident on the card
(models/gang.py drain_step), and this module turns the cache's delta log
(sched/cache.py) into STATIC-SHAPE scatter arrays that the drain (or
models/gang.py apply_ctx_patch) applies to that resident encoding in place
— node and pod churn become a ~KB host->device copy instead of a multi-MB
re-encode + re-upload per scheduling pop.

Layout contract with drain_step:
- epod rows [0, fill) hold device-folded committed pods (packed upward);
  PATCHED pods take slots from the TOP of the free region downward, so the
  two allocators never collide. ``free_floor`` (lowest patched slot) bounds
  how far folds may grow before a rebuild repacks.
- node rows beyond the live cluster (``node_free``) absorb node ADDs; a
  node DELETE retires its row until no bound pod references it.
- nominee reservations (nom_* tensors) live at a fixed bucket M so
  preemption storms patch reservations instead of dropping the context.

Anything that does not fit — bucket overflow, a new resource kind or
topology key (static args!), pods with host ports/volumes (they own
node-side port/volume state) — compiles to ``None`` and the caller
rebuilds the context from a fresh host snapshot. Correct first, resident
when provable.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any, Optional

import numpy as np

from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.encode.dictionary import next_bucket
from kubernetes_tpu_torch.encode.scaling import UNLIMITED, scale_allocatable
from kubernetes_tpu_torch.encode.snapshot import (
    EFFECTC,
    NODE_NAME_LABEL,
    SnapshotMeta,
    _selset_arrays,
    _selset_fill,
)
from kubernetes_tpu_torch.encode.termprep import (
    affinity_term_selector,
    resolve_term_namespaces,
)
from kubernetes_tpu_torch.sched.volumebinding import node_attach_limit

# minimum write-bucket widths: generous floors so virtually every patch in
# a run has the same shapes (and the reference's, for parity); scatters
# over padded rows are cheap
_MIN_PODS = 64
_MIN_NODES = 64
_MIN_NOMS = 64


@dataclass
class CtxPatchState:
    """Host-side bookkeeping for ONE device-resident drain context.

    Forked from the encoder's post-encode ``_PatchState`` (same slot/row
    maps) but evolves independently: the device context folds committed
    pods into slots the host snapshot never sees, so the two replicas stop
    agreeing on slot assignment after the first drain."""

    resources: list[str]
    res_index: dict[str, int]
    node_index: dict[str, int]
    K: int
    ET: int
    EAX: int
    EAV: int
    NSB: int
    N: int
    V: int
    T: int
    I: int
    IMG: int
    E: int
    # Pod-side label width of the RESIDENT epod arrays. extend_cluster
    # unifies epod_labels/ea_* to max(cluster, batch) widths, so a batch
    # whose label keys crossed a bucket AFTER the cluster encode leaves the
    # context wider than the encoder's K — patches write at EK (and the
    # scheduler re-syncs ET/EAX/EAV/NSB from the staged arrays) or the
    # scatter rows would not broadcast. K keeps addressing the node rows.
    EK: int = 0
    slot_of: dict[str, int] = dc_field(default_factory=dict)
    slot_node: dict[str, int] = dc_field(default_factory=dict)
    slot_req: dict[str, Any] = dc_field(default_factory=dict)
    unpatchable: set = dc_field(default_factory=set)
    # Slot allocation: device folds fill [0, fill_host) UPWARD; patches
    # allocate DOWNWARD from ``top`` (starts at e0). Freed slots are never
    # reused — a freed slot in the folds' path would be silently
    # overwritten as fill grows — so deletes leak their slot and the
    # context rebuilds (repacking) when the cursors meet. The scheduler
    # re-checks fill_bound + batch <= top AFTER compiling each patch.
    top: int = 0
    fill_host: int = 0        # host's view of the device fold watermark
    node_free: list[int] = dc_field(default_factory=list)  # ascending rows
    node_retired: set = dc_field(default_factory=set)
    row_pods: dict[int, int] = dc_field(default_factory=dict)
    # pods deliberately invisible (bound to nodes this context dropped):
    # key -> Pod, re-materialized if their node (re)appears
    ignored: dict = dc_field(default_factory=dict)
    # a device fold included a pod owning node-side port/volume state the
    # fold cannot reproduce -> the context must rebuild at next dispatch
    tainted: bool = False
    # our own device-side folds: key -> node name (assume log entries for
    # these are already reflected in the resident encoding)
    folded: dict[str, str] = dc_field(default_factory=dict)
    # nominee reservations resident on device: key -> (slot, node, prio)
    nom_applied: dict[str, tuple] = dc_field(default_factory=dict)
    nom_free: list[int] = dc_field(default_factory=list)


def fork_patch_state(pstate) -> Optional[CtxPatchState]:
    """CtxPatchState seeded from the encoder's ``_PatchState`` right after a
    full encode (slot maps still agree at that instant). Returns None when
    the encoder has no patch state (nothing encoded yet)."""
    if pstate is None or pstate.N == 0:
        return None
    e0 = pstate.E
    fill = len(pstate.slot_of)
    return CtxPatchState(
        resources=list(pstate.resources), res_index=dict(pstate.res_index),
        node_index=dict(pstate.node_index),
        K=pstate.K, ET=pstate.ET, EAX=pstate.EAX, EAV=pstate.EAV,
        NSB=pstate.NSB, N=pstate.N, V=pstate.V, T=pstate.T, I=pstate.I,
        IMG=pstate.IMG, E=e0, EK=pstate.K,
        slot_of=dict(pstate.slot_of), slot_node=dict(pstate.slot_node),
        slot_req={k: np.array(v) for k, v in pstate.slot_req.items()},
        unpatchable=set(pstate.unpatchable),
        top=e0, fill_host=fill,
        node_free=list(pstate.node_free),
        row_pods=dict(pstate.row_pods),
    )


def sync_resident_widths(cs: CtxPatchState, ct_all) -> CtxPatchState:
    """Align the patch state's POD-SIDE bucket widths with the staged drain
    context's actual arrays. extend_cluster unifies epod/anti-term widths to
    max(cluster, batch); when a batch's label keys or anti terms crossed a
    bucket after the cluster encode, the resident arrays are wider than the
    encoder's post-encode widths — patches compiled at the narrow widths
    would fail to broadcast at apply time (and reject pods the resident
    buckets can in fact hold)."""
    cs.EK = int(ct_all.epod_labels.shape[1])
    cs.ET = int(ct_all.ea_valid.shape[1])
    cs.EAX = int(ct_all.ea_sel.key.shape[2])
    cs.EAV = int(ct_all.ea_sel.vals.shape[3])
    cs.NSB = int(ct_all.ea_ns_mask.shape[2])
    return cs


def fork_meta(meta: SnapshotMeta) -> SnapshotMeta:
    """Context-private copy of the snapshot meta: node patches append names
    the host's cached encoding must never see. node_names is pre-extended to
    the N bucket so any patched row resolves."""
    m = SnapshotMeta(
        keys=meta.keys, values=meta.values, namespaces=meta.namespaces,
        ips=meta.ips, images=meta.images, resources=list(meta.resources),
        node_names=list(meta.node_names), node_index=dict(meta.node_index),
        pod_keys=list(meta.pod_keys), topo_keys=meta.topo_keys,
        generation=meta.generation,
    )
    return m


class _Unfit(Exception):
    """Internal: delta does not fit the resident buckets -> rebuild."""


def entries_all_folded(cs: CtxPatchState, entries: list) -> bool:
    """True when every delta-log entry is an ``assume`` this context already
    folded device-side (``cs.folded``) — i.e. the log contains nothing the
    resident encoding doesn't know. The pipelined scheduler then advances
    its log cursor WITHOUT compiling a patch and, critically, without
    draining the dispatch pipeline first: a compile needs the patch state
    current with every in-flight drain's folds, but a no-op advance does
    not. This is the steady-state gate that lets drain k+1 dispatch while
    drain k still executes (the reference's sched/scheduler.py
    _schedule_drain; testing/resident.py here)."""
    for _seq, op, payload in entries:
        if op != "assume":
            return False
        key, node_name, _pod = payload
        if cs.folded.get(key) != node_name:
            return False
    return True


def entries_fold_safe(cs: CtxPatchState, entries: list,
                      inflight_keys: set) -> bool:
    """True when the delta-log entries can be compiled into a patch WITHOUT
    first draining the dispatch pipeline — the fused-fold gate.

    The patch state's slot/row maps lag the device by exactly the in-flight
    drains' folds (mirrored at resolve). A delta is fold-safe when nothing
    it touches depends on those unmirrored folds:

    - pod-level entries (``assume``/``pod``/``poddel``) must not name a pod
      an in-flight drain is scheduling: its fold slot is unknown until
      resolve, so a delete/rebind could not be addressed;
    - ``nodedel`` is never fold-safe while drains are in flight: the
      retire-or-free decision reads ``row_pods``, which does not yet count
      in-flight folds — a row could be freed (and later reused by a node
      add) while folded pods still reference it;
    - ``full`` always forces the rebuild path (compile would refuse it
      anyway, but the caller should not burn a compile to learn that).

    Node upserts are safe: existing rows rewrite in place, and new rows
    come from ``node_free`` — rows no in-flight fold can reference (folds
    only land on valid winner rows). Slot-cursor collisions are handled
    separately: the caller compiles with ``fold_floor`` set to its
    dispatch-side fill reservation."""
    for _seq, op, payload in entries:
        if op in ("full", "nodedel"):
            return False
        if op == "assume":
            key = payload[0]
        elif op == "pod":
            key = payload.key
        elif op == "poddel":
            key = payload
        elif op == "node":
            continue
        else:
            return False  # unknown op: fail safe
        if key in inflight_keys:
            return False
    return True


def compile_patch(encoder, meta: SnapshotMeta, cs: CtxPatchState,
                  entries: list, nom_target: dict,
                  nom_bucket: int, fold_floor: int = 0) -> Optional[dict]:
    """Delta-log entries + nominee target set -> numpy scatter arrays for
    apply_ctx_patch (or drain_step's ``patch``), updating ``cs``/``meta``
    bookkeeping in the same pass.

    ``entries``: [(seq, op, payload)] in log order with op in
    {"assume", "pod", "poddel", "node", "nodedel", "full"}.
    ``nom_target``: pod_key -> (node_name, priority, Pod) — the COMPLETE
    desired reservation set; the diff against ``cs.nom_applied`` is patched.
    ``fold_floor``: lowest slot the patch allocator may descend to — the
    fused-fold path passes the scheduler's dispatch-side fill reservation
    (``fill_bound``), which is ahead of ``fill_host`` by exactly the
    in-flight drains' pods, so a patch compiled without draining the
    pipeline can never hand out a slot an unresolved fold will take.

    Returns None when any delta does not fit (caller rebuilds; ``cs`` is
    then discarded, so no rollback is attempted)."""
    try:
        return _compile(encoder, meta, cs, entries, nom_target, nom_bucket,
                        fold_floor)
    except _Unfit:
        return None


def _compile(encoder, meta, cs, entries, nom_target, nom_bucket,
             fold_floor=0):
    R = len(cs.resources)
    # final-value accumulators
    pod_writes: dict[int, Optional[tuple]] = {}
    node_writes: dict[int, Optional[tuple]] = {}
    nom_writes: dict[int, Optional[tuple]] = {}
    req_delta = np.zeros((cs.N, R), np.int32)

    def _retire_check(row: int):
        if row in cs.node_retired and cs.row_pods.get(row, 0) == 0:
            cs.node_retired.discard(row)
            cs.node_free.append(row)

    def _vec(v):
        # slot_req stores either the vector or the Pod itself (resolve-time
        # folds defer the compute: most pods are never deleted/rebound)
        if isinstance(v, np.ndarray):
            return v
        return encoder._request_vector(v, cs.resources)

    def _drop_pod(key: str):
        if key in cs.unpatchable:
            # the pod owns node-side port/volume state a slot clear cannot
            # undo (the host patch path refuses these too)
            raise _Unfit
        slot = cs.slot_of.pop(key, None)
        cs.folded.pop(key, None)
        cs.ignored.pop(key, None)
        if slot is None:
            return
        row = cs.slot_node.pop(key)
        req_delta[row] -= _vec(cs.slot_req.pop(key))
        cs.row_pods[row] = cs.row_pods.get(row, 1) - 1
        _retire_check(row)
        pod_writes[slot] = None  # slot leaks by design (see CtxPatchState)

    def _upsert_pod(p: Pod):
        key = p.key
        if key in cs.unpatchable:
            raise _Unfit
        if p.spec.volumes or p.host_ports():
            raise _Unfit  # owns node-side port/volume state
        reqs = encoder._effective_requests(p)
        if any(r not in cs.res_index for r in reqs):
            raise _Unfit
        ns_id = encoder.namespaces.intern(p.metadata.namespace)
        if ns_id >= cs.NSB:
            raise _Unfit  # candidate-pod ns indexes [*,NSB] term masks
        label_ids = encoder._label_ids(p.metadata.labels)
        if any(kid >= cs.EK for kid in label_ids):
            raise _Unfit
        aff = p.spec.affinity
        pan = aff.pod_anti_affinity if aff else None
        terms = []
        for t in (pan.required if pan else []):
            eff = affinity_term_selector(t, p.metadata.labels)
            valid, exprs = encoder._compile_selector(eff)
            ns_set = resolve_term_namespaces(
                t, p.metadata.namespace, encoder._namespace_labels)
            ns_ids = (None if ns_set is None else
                      tuple(encoder.namespaces.intern(n)
                            for n in sorted(ns_set)))
            topo = encoder.keys.intern(t.topology_key)
            if topo not in meta.topo_keys:
                raise _Unfit  # topo_keys is a STATIC drain arg
            terms.append((topo, valid, exprs, ns_ids))
        if (len(terms) > cs.ET
                or any(len(ex) > cs.EAX for (_, _, ex, _) in terms)
                or any(len(v) > cs.EAV for (_, _, ex, _) in terms
                       for (_, _, v, _) in ex)
                or any(nid >= cs.NSB for (_, _, _, ns) in terms
                       if ns is not None for nid in ns)):
            raise _Unfit
        ni = cs.node_index.get(p.spec.node_name, -1)
        had_slot = key in cs.slot_of
        if had_slot:
            # remove the old incarnation's contribution, keep the slot
            slot = cs.slot_of[key]
            old_row = cs.slot_node[key]
            req_delta[old_row] -= _vec(cs.slot_req[key])
            cs.row_pods[old_row] = cs.row_pods.get(old_row, 1) - 1
            _retire_check(old_row)
        if ni < 0:
            # bound to a node this context dropped: invisible (parked in
            # ``ignored``) until the node (re)appears — _upsert_node
            # re-materializes it then
            if had_slot:
                pod_writes[cs.slot_of.pop(key)] = None
                cs.slot_node.pop(key, None)
                cs.slot_req.pop(key, None)
            cs.ignored[key] = p
            cs.folded.pop(key, None)
            return
        if not had_slot:
            if cs.top <= max(cs.fill_host, fold_floor):
                raise _Unfit  # patch cursor met the fold watermark
            cs.top -= 1
            slot = cs.top
            cs.slot_of[key] = slot
        vec = encoder._request_vector(p, cs.resources)
        req_delta[ni] += vec
        cs.slot_node[key] = ni
        cs.slot_req[key] = vec
        cs.row_pods[ni] = cs.row_pods.get(ni, 0) + 1
        cs.ignored.pop(key, None)
        pod_writes[slot] = (ni, ns_id, label_ids, terms)

    def _upsert_node(n: Node):
        name = n.metadata.name
        alloc = dict(n.allocatable_canonical())
        if encoder._dra is not None:
            alloc.update(encoder._dra.node_capacity(name))
        if any(r not in cs.res_index for r in alloc):
            raise _Unfit  # new resource kind widens R
        label_ids = encoder._label_ids(n.metadata.labels,
                                       {NODE_NAME_LABEL: name})
        if any(kid >= cs.K for kid in label_ids):
            raise _Unfit
        if any(vid >= cs.V for vid in label_ids.values()):
            raise _Unfit  # node label values index label_value_num[V]
        if len(n.spec.taints) > cs.T:
            raise _Unfit
        if len(n.status.images) > cs.I:
            raise _Unfit
        img_ids = []
        for img in n.status.images:
            if not img.names:
                continue
            iid = encoder._intern_image(img.names[0], img.size_bytes)
            if iid >= cs.IMG:
                raise _Unfit  # image_sizes bucket overflow
            img_ids.append(iid)
        ni = cs.node_index.get(name)
        reset = False
        if ni is None:
            if not cs.node_free:
                raise _Unfit
            ni = cs.node_free.pop(0)
            cs.node_index[name] = ni
            meta.node_index[name] = ni
            while len(meta.node_names) <= ni:
                meta.node_names.append("")
            meta.node_names[ni] = name
            reset = True
            req_delta[ni] = 0  # cancel pre-reset contributions on this row
            # pods that were parked because this node was unknown (informer
            # delivered them first, or the node flapped) become visible now
            parked = [q for q in cs.ignored.values()
                      if q.spec.node_name == name]
        alloc_row = np.zeros(R, np.int32)
        for r, amt in alloc.items():
            alloc_row[cs.res_index[r]] = min(
                scale_allocatable(r, amt), UNLIMITED)
        if "pods" not in alloc:
            alloc_row[cs.res_index["pods"]] = UNLIMITED
        taints = [(encoder.keys.intern(t.key),
                   encoder.values.intern(t.value),
                   EFFECTC.get(t.effect, 0)) for t in n.spec.taints]
        if any(vid >= cs.V for (_, vid, _) in taints):
            raise _Unfit  # values table crossed the V bucket
        lim = node_attach_limit(n.status.allocatable)
        node_writes[ni] = (alloc_row, bool(n.spec.unschedulable), label_ids,
                           taints, img_ids,
                           np.int32(lim if lim >= 0 else UNLIMITED), reset)
        if reset:
            for q in parked:
                _upsert_pod(q)

    def _delete_node(name: str):
        ni = cs.node_index.pop(name, None)
        meta.node_index.pop(name, None)
        if ni is None:
            return
        node_writes[ni] = None
        if cs.row_pods.get(ni, 0) == 0:
            cs.node_free.append(ni)
        else:
            cs.node_retired.add(ni)

    for _seq, op, payload in entries:
        if op == "full":
            raise _Unfit
        if op == "assume":
            key, node_name, pod = payload
            if cs.folded.get(key) == node_name:
                continue  # our own device-side fold, already resident
            _upsert_pod(pod)
        elif op == "pod":
            _upsert_pod(payload)
        elif op == "poddel":
            _drop_pod(payload)
        elif op == "node":
            _upsert_node(payload)
        elif op == "nodedel":
            _delete_node(payload)
        else:
            raise _Unfit  # unknown op: fail safe

    # ---- nominee reservation diff ---------------------------------------
    if not cs.nom_free and not cs.nom_applied:
        cs.nom_free = list(range(nom_bucket))
    for key in [k for k in cs.nom_applied if k not in nom_target]:
        slot, _n, _p = cs.nom_applied.pop(key)
        nom_writes[slot] = None
        cs.nom_free.append(slot)
    for key, (node_name, prio, pod) in nom_target.items():
        prev = cs.nom_applied.get(key)
        ni = cs.node_index.get(node_name, -1)
        if prev is not None:
            if prev[1] == node_name and prev[2] == prio and ni >= 0:
                continue
            slot = prev[0]
            cs.nom_applied.pop(key)
            nom_writes[slot] = None
            cs.nom_free.append(slot)
        if ni < 0:
            continue  # nominated node vanished: reservation is moot
        if not cs.nom_free:
            raise _Unfit
        slot = cs.nom_free.pop()
        vec = encoder._request_vector(pod, cs.resources)
        nom_writes[slot] = (ni, np.int32(prio), vec)
        cs.nom_applied[key] = (slot, node_name, prio)

    if len(encoder.values) > cs.V:
        raise _Unfit  # label_value_num bucket overflow

    # ---- materialize static-shape arrays --------------------------------
    MP = next_bucket(len(pod_writes), minimum=_MIN_PODS)
    MN = next_bucket(len(node_writes), minimum=_MIN_NODES)
    MM = next_bucket(len(nom_writes), minimum=_MIN_NOMS)
    patch = {
        "pod_slot": np.full(MP, -1, np.int32),
        "pod_node": np.full(MP, -1, np.int32),
        "pod_ns": np.full(MP, -1, np.int32),
        "pod_labels": np.full((MP, cs.EK), -1, np.int32),
        "pod_valid": np.zeros(MP, bool),
        "ea_topo": np.full((MP, cs.ET), -1, np.int32),
        "ea_valid": np.zeros((MP, cs.ET), bool),
        "ea_ns_explicit": np.zeros((MP, cs.ET), bool),
        "ea_ns_mask": np.zeros((MP, cs.ET, cs.NSB), bool),
        "node_row": np.full(MN, -1, np.int32),
        "n_alloc": np.zeros((MN, R), np.int32),
        "n_valid": np.zeros(MN, bool),
        "n_unsched": np.zeros(MN, bool),
        "n_labels": np.full((MN, cs.K), -1, np.int32),
        "n_taint_key": np.full((MN, cs.T), -1, np.int32),
        "n_taint_val": np.full((MN, cs.T), -1, np.int32),
        "n_taint_effect": np.full((MN, cs.T), -1, np.int32),
        "n_taint_valid": np.zeros((MN, cs.T), bool),
        "n_images": np.full((MN, cs.I), -1, np.int32),
        "n_attach_limit": np.full(MN, UNLIMITED, np.int32),
        "n_reset": np.zeros(MN, bool),
        "nom_slot": np.full(MM, -1, np.int32),
        "nom_node": np.full(MM, -1, np.int32),
        "nom_prio": np.zeros(MM, np.int32),
        "nom_req": np.zeros((MM, R), np.int32),
        "nom_valid": np.zeros(MM, bool),
        "req_delta": req_delta,
    }
    ea = _selset_arrays((MP, cs.ET), cs.EAX, cs.EAV)
    for i, (slot, w) in enumerate(sorted(pod_writes.items())):
        patch["pod_slot"][i] = slot
        if w is None:
            continue  # all-invalid row = clear
        ni, ns_id, label_ids, terms = w
        patch["pod_node"][i] = ni
        patch["pod_ns"][i] = ns_id
        for kid, vid in label_ids.items():
            patch["pod_labels"][i, kid] = vid
        patch["pod_valid"][i] = True
        for t_idx, (topo, valid, exprs, ns_ids) in enumerate(terms):
            patch["ea_topo"][i, t_idx] = topo
            patch["ea_valid"][i, t_idx] = True
            _selset_fill(ea, (i, t_idx), valid, exprs)
            if ns_ids is not None:
                patch["ea_ns_explicit"][i, t_idx] = True
                for nid in ns_ids:
                    patch["ea_ns_mask"][i, t_idx, nid] = True
    for f, arr in ea.items():
        patch[f"ea_sel_{f}"] = arr
    for i, (row, w) in enumerate(sorted(node_writes.items())):
        patch["node_row"][i] = row
        if w is None:
            continue
        alloc_row, unsched, label_ids, taints, img_ids, lim, reset = w
        patch["n_alloc"][i] = alloc_row
        patch["n_valid"][i] = True
        patch["n_unsched"][i] = unsched
        for kid, vid in label_ids.items():
            patch["n_labels"][i, kid] = vid
        for t_idx, (kid, vid, eff) in enumerate(taints):
            patch["n_taint_key"][i, t_idx] = kid
            patch["n_taint_val"][i, t_idx] = vid
            patch["n_taint_effect"][i, t_idx] = eff
            patch["n_taint_valid"][i, t_idx] = True
        for im_idx, iid in enumerate(img_ids):
            patch["n_images"][i, im_idx] = iid
        patch["n_attach_limit"][i] = lim
        patch["n_reset"][i] = reset
    for i, (slot, w) in enumerate(sorted(nom_writes.items())):
        patch["nom_slot"][i] = slot
        if w is None:
            continue
        ni, prio, vec = w
        patch["nom_node"][i] = ni
        patch["nom_prio"][i] = prio
        patch["nom_req"][i] = vec
        patch["nom_valid"][i] = True
    # label-value numeric table: values interned since the encode extend it
    # (a [V] float32 — KBs; always shipped rather than tracking dirtiness)
    lvn = np.full(cs.V, np.nan, np.float32)
    nums = encoder.values.numeric_values()
    lvn[:len(nums)] = np.asarray(nums, np.float32)
    patch["label_value_num"] = lvn
    return patch
