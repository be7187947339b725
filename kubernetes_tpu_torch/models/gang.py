"""Gang batcher — schedule P pods per step with conflict resolution.

The PyTorch port of the single-batch path of ``kubernetes_tpu/models/gang.py``.
Batching P pods against one snapshot introduces intra-batch conflicts the
serial loop never sees:

  capacity     two batch members both fit node n, but not together
  relational   anti-affinity/spread/affinity between batch members

Design: iterative propose/commit rounds, all tensor-side:

  1. evaluate() all uncommitted pods against cluster state + already-committed
     batch members (committed members occupy pre-padded "extension" slots of
     the existing-pods tensors).
  2. every pod proposes its argmax node.
  3. capacity acceptance per node: proposals sorted by (node, rank) with
     rank = (-priority, batch index); segmented exclusive prefix-sums of
     requests accept the prefix that fits.
  4. relational veto: an accepted pod is rejected if a higher-rank pod
     accepted THIS round conflicts (anti-affinity either direction, shared
     hard-spread domain, or required-affinity forcing co-location). Rejected
     pods re-propose next round against the updated state, so committed
     state is always sequentially valid.
  5. fold acceptances into requested[N,R] + extension slots; repeat.

``serial=True`` caps acceptance at one pod per round (highest rank), which
reproduces the reference's serial semantics exactly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from kubernetes_tpu_torch.encode.snapshot import ClusterTensors, PodBatch, SelectorSet
from kubernetes_tpu_torch.models.schedule_step import evaluate
from kubernetes_tpu_torch.ops.exprs import eval_selector_set
from kubernetes_tpu_torch.ops.sorting import lexsort
from kubernetes_tpu_torch.ops.topology import _gather_ns

_I32_MIN = -(1 << 31)
_I32_MAX = (1 << 31) - 1


@dataclass
class GangState:
    requested: torch.Tensor    # [N,R] current (base + committed batch members)
    committed: torch.Tensor    # [P] bool
    assignment: torch.Tensor   # [P] int32, -1 unassigned
    tried: torch.Tensor        # [P] bool (serial mode: attempted exactly once)
    rounds: int                # rounds run


def _pad_axis(a: torch.Tensor, axis: int, size: int, fill):
    if a.shape[axis] == size:
        return a
    shape = list(a.shape)
    shape[axis] = size - a.shape[axis]
    pad = torch.full(shape, fill, dtype=a.dtype, device=a.device)
    return torch.cat([a, pad], dim=axis)


def extend_cluster(ct: ClusterTensors, pb: PodBatch) -> ClusterTensors:
    """Widen the existing-pods tensors with P extension slots for batch
    members (invalid until committed) so relational plugins see committed
    members. Anti-affinity term buckets are unified by padding."""
    P = int(pb.pod_valid.shape[0])
    dev = ct.epod_node.device
    K = max(int(ct.epod_labels.shape[1]), int(pb.pod_labels.shape[1]))

    epod_labels = torch.cat([_pad_axis(ct.epod_labels, 1, K, -1),
                             _pad_axis(pb.pod_labels, 1, K, -1)], dim=0)
    # unify anti-affinity term buckets: [E,ET,...] with [P,BT,...]
    ET = max(int(ct.ea_valid.shape[1]), int(pb.anti_valid.shape[1]))
    AX = max(int(ct.ea_sel.key.shape[2]), int(pb.anti_sel.key.shape[2]))
    AV = max(int(ct.ea_sel.vals.shape[3]), int(pb.anti_sel.vals.shape[3]))

    def pad_sel(sel: SelectorSet, T):
        key = _pad_axis(_pad_axis(sel.key, 1, T, -1), 2, AX, -1)
        op = _pad_axis(_pad_axis(sel.op, 1, T, 0), 2, AX, 0)
        vals = _pad_axis(_pad_axis(_pad_axis(sel.vals, 1, T, -1), 2, AX, -1),
                         3, AV, -1)
        ev = _pad_axis(_pad_axis(sel.expr_valid, 1, T, False), 2, AX, False)
        valid = _pad_axis(sel.valid, 1, T, False)
        return key, op, vals, ev, valid

    ek, eo, ev_, ee, eval_ = pad_sel(ct.ea_sel, ET)
    pk, po, pv, pe, pval = pad_sel(pb.anti_sel, ET)
    ea_sel = SelectorSet(
        key=torch.cat([ek, pk]), op=torch.cat([eo, po]),
        vals=torch.cat([ev_, pv]), expr_valid=torch.cat([ee, pe]),
        valid=torch.cat([eval_, pval]))
    ea_topo = torch.cat([_pad_axis(ct.ea_topo, 1, ET, -1),
                         _pad_axis(pb.anti_topo, 1, ET, -1)])
    ea_valid = torch.cat([_pad_axis(ct.ea_valid, 1, ET, False),
                          _pad_axis(pb.anti_valid, 1, ET, False)])
    # unify the namespace-mask width (the tables only grow, so the larger
    # bucket covers every id the smaller one can hold)
    NSB = max(int(ct.ea_ns_mask.shape[2]), int(pb.anti_ns_mask.shape[2]))
    ea_ns_explicit = torch.cat([
        _pad_axis(ct.ea_ns_explicit, 1, ET, False),
        _pad_axis(pb.anti_ns_explicit, 1, ET, False)])
    ea_ns_mask = torch.cat([
        _pad_axis(_pad_axis(ct.ea_ns_mask, 1, ET, False), 2, NSB, False),
        _pad_axis(_pad_axis(pb.anti_ns_mask, 1, ET, False), 2, NSB, False)])
    return ct.replace(
        epod_node=torch.cat([ct.epod_node,
                             torch.full((P,), -1, dtype=torch.int32, device=dev)]),
        epod_ns=torch.cat([ct.epod_ns, pb.pod_ns]),
        epod_labels=epod_labels,
        epod_valid=torch.cat([ct.epod_valid,
                              torch.zeros(P, dtype=torch.bool, device=dev)]),
        ea_sel=ea_sel, ea_topo=ea_topo, ea_valid=ea_valid,
        ea_ns_explicit=ea_ns_explicit, ea_ns_mask=ea_ns_mask,
    )


def _segmented_capacity_accept(choice, want, rank, requests, free_at_choice,
                               per_node_cap=None):
    """Per-node priority-ordered capacity acceptance.

    choice [P] proposed node; want [P] proposal live; rank [P] lower = first;
    requests [P,R]; free_at_choice [P,R] free capacity on the proposed node;
    per_node_cap: scalar max acceptances per node this round (balance guard —
    batch members share one snapshot, so without a cap equal-score pods pile
    onto tie-break winners instead of spreading like the serial loop).
    Returns accept [P] bool. Uses sort + segmented exclusive cumsum.
    """
    P = choice.shape[0]
    dev = choice.device
    node_key = torch.where(want, choice, 0x3FFFFFFF)
    order = lexsort((rank, node_key))              # group by node, rank within
    sn = node_key[order]
    seg_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           sn[1:] != sn[:-1]])

    def seg_excl(values):
        """Segmented exclusive prefix sums along axis 0 (values >= 0), in
        int32 like the reference; the int32 minimum marks rows that do not
        start a segment, so the running max carries each segment's base."""
        cs = torch.cumsum(values, dim=0, dtype=torch.int32)
        base = torch.where(seg_start[:, None], cs - values, _I32_MIN)
        base = torch.cummax(base, dim=0).values
        return cs - values - base

    want_s = want[order]
    req_s = torch.where(want_s[:, None], requests[order], 0)
    fits = torch.all(seg_excl(req_s) + req_s <= free_at_choice[order], dim=-1)
    fits &= want_s
    if per_node_cap is not None:
        # cap counts capacity-FITTING entries only (rejected ones don't burn
        # slots); a second scan over the fits indicator gives that count.
        ones = fits[:, None].to(torch.int32)
        fits &= seg_excl(ones)[:, 0] < per_node_cap
    accept = torch.zeros(P, dtype=torch.bool, device=dev)
    accept[order] = fits
    return accept


def _relational_veto(ct: ClusterTensors, pb: PodBatch, choice, accept, rank,
                     topo_keys: tuple[int, ...]):
    """Reject accepted pods conflicting with a higher-rank pod accepted this
    round (anti-affinity both directions, shared hard-spread domain, required
    affinity forcing co-location). Conservative; rejects re-propose next round."""
    P = pb.pod_valid.shape[0]
    K = ct.node_labels.shape[1]
    higher = (rank[None, :] < rank[:, None]) & accept[None, :] & accept[:, None]  # [q,p]
    conflict = torch.zeros((P, P), dtype=torch.bool, device=choice.device)
    ns_eq = pb.pod_ns[:, None] == pb.pod_ns[None, :]                # [q,p]

    def _term_ns_ok(explicit, mask):
        """[q,T,p]: does q's term t apply to p's namespace?"""
        exp = _gather_ns(mask, pb.pod_ns)                           # [q,T,p]
        return torch.where(explicit[..., None], exp, ns_eq[:, None, :])

    for k in topo_keys:
        if k < 0 or k >= K:
            continue
        dv = ct.node_labels[:, k]                                   # [N]
        dvc = dv[choice.clamp(0, dv.shape[0] - 1).long()]           # [P] chosen domain
        same = (dvc[:, None] == dvc[None, :]) & (dvc[:, None] >= 0)  # [q,p]
        if pb.anti_valid.shape[1] > 0:
            m = eval_selector_set(pb.anti_sel, pb.pod_labels)       # [p_t, q, BT]
            qt = (pb.anti_topo == k) & pb.anti_valid                # [q,BT]
            ns_ok = _term_ns_ok(pb.anti_ns_explicit, pb.anti_ns_mask)  # [q,BT,p]
            # q's term matches p (selector + per-term namespaces): m[p, q, t]
            q_hits_p = torch.any(m.movedim(0, 2) & qt[..., None]
                                 & ns_ok, dim=1)                    # [q,p]
            conflict |= q_hits_p & same
            # symmetry: p's anti term matches q -> q (lower rank) rejected
            conflict |= q_hits_p.T & same
        if pb.sc_valid.shape[1] > 0:
            m = eval_selector_set(pb.sc_sel, pb.pod_labels)         # [p_t, q, SC]
            qt = (pb.sc_topo == k) & pb.sc_valid & pb.sc_hard
            q_hits_p = torch.any(m & qt[None], dim=-1).T
            conflict |= q_hits_p & same & ns_eq  # spread: own namespace only
        if pb.aff_valid.shape[1] > 0:
            m = eval_selector_set(pb.aff_sel, pb.pod_labels)        # [p_t, q, AT]
            qt = (pb.aff_topo == k) & pb.aff_valid
            ns_ok = _term_ns_ok(pb.aff_ns_explicit, pb.aff_ns_mask)  # [q,AT,p]
            q_hits_p = torch.any(m.movedim(0, 2) & qt[..., None]
                                 & ns_ok, dim=1)                    # [q,p]
            # required affinity: must be in SAME domain as matching member
            conflict |= q_hits_p & ~same
    veto = torch.any(conflict & higher, dim=1)
    return accept & ~veto


def _gang_round_impl(ct_ext: ClusterTensors, pb: PodBatch, state: GangState,
                     seed: int = 0, fit_strategy: str = "LeastAllocated",
                     topo_keys: tuple[int, ...] = (), serial: bool = False,
                     weights: tuple = (), enabled_filters: tuple = (),
                     cap_scale=1):
    """One propose/accept/fold round. Returns (new_state, progress) where
    progress (a 0-d tensor) counts acceptances plus serial-mode attempts.
    The batch's extension slots are the trailing P epod slots."""
    P = state.committed.shape[0]
    N = ct_ext.node_valid.shape[0]
    dev = state.committed.device
    slot_start = ct_ext.epod_valid.shape[0] - P
    # wire committed members into this batch's extension slots
    epod_node = ct_ext.epod_node.clone()
    epod_node[slot_start:slot_start + P] = state.assignment
    epod_valid = ct_ext.epod_valid.clone()
    epod_valid[slot_start:slot_start + P] = state.committed
    ct_round = ct_ext.replace(requested=state.requested, epod_node=epod_node,
                              epod_valid=epod_valid)
    pb_round = pb.replace(pod_valid=pb.pod_valid & ~state.committed)
    res = evaluate(ct_round, pb_round, seed=seed,
                   fit_strategy=fit_strategy, topo_keys=topo_keys,
                   weights=dict(weights) if weights else None,
                   enabled_filters=frozenset(enabled_filters) if enabled_filters else None)
    want = res.assigned & ~state.committed & pb.pod_valid
    tried = state.tried
    n_attempted = torch.zeros((), dtype=torch.int64, device=dev)
    idx = torch.arange(P, dtype=torch.int32, device=dev)
    if serial:
        # Exact ScheduleOne semantics: attempt pods once each, in a-priori
        # (priority desc, index asc) order — a pod that fails is NOT retried
        # even if later commits would make it feasible.
        untried = ~state.committed & ~tried & pb.pod_valid
        tprio = torch.where(untried, -pb.priority, _I32_MAX)
        torder = lexsort((idx, tprio))
        target = torder[0]
        is_target = (idx == target) & untried[target]
        want = want & is_target
        tried = tried | is_target
        n_attempted = torch.sum(is_target)
    # rank: priority desc, batch index asc; non-proposing pods rank last
    prio_key = torch.where(want, -pb.priority, _I32_MAX)
    order0 = lexsort((idx, prio_key))
    rank = torch.zeros(P, dtype=torch.int32, device=dev)
    rank[order0] = idx
    free = ct_round.allocatable - state.requested                   # [N,R]
    choice_safe = res.choice.clamp(0, N - 1).long()
    free_at_choice = free[choice_safe]
    # Balance guard: spread this round's acceptances across the nodes feasible
    # for someone, approximating the serial loop's load feedback. cap_scale
    # doubles every round (_converge), so strict-preference workloads where the
    # cap would serialize still converge in O(log P) rounds.
    distinct = torch.sum(torch.any(res.feasible & want[:, None], dim=0))
    n_want = torch.sum(want)
    cap = torch.clamp(-(-n_want // torch.clamp(distinct, min=1)), min=1) * cap_scale
    accept = _segmented_capacity_accept(res.choice, want, rank, pb.requests,
                                        free_at_choice, per_node_cap=cap)
    accept = _relational_veto(ct_round, pb, res.choice, accept, rank, topo_keys)
    # fold: integer add of the accepted pods' requests at their nodes (exact;
    # an index_add_ in place of the reference's one-hot integer matmul)
    add = torch.where(accept[:, None], pb.requests, 0)
    requested = state.requested.clone().index_add_(0, choice_safe, add)
    new_state = GangState(
        requested=requested,
        committed=state.committed | accept,
        assignment=torch.where(accept, res.choice, state.assignment),
        tried=tried,
        rounds=state.rounds + 1,
    )
    return new_state, torch.sum(accept) + n_attempted


def _converge(ct_ext, pb, state, *, seed, fit_strategy, topo_keys,
              weights, enabled_filters, max_rounds,
              serial=False) -> GangState:
    """Rounds until one makes no progress, at most ``max_rounds``.

    The reference runs a fixed-trip loop whose body goes dead after the
    first round without progress; ``cap_scale = 1 << min(i, 20)`` counts
    the live rounds. This loop breaks at that round instead, which gives
    the same rounds and assignments for one host read per round. Capturing
    the rounds in a CUDA graph is later work."""
    for i in range(max(int(max_rounds), 1)):
        state, progress = _gang_round_impl(
            ct_ext, pb, state, seed=seed, fit_strategy=fit_strategy,
            topo_keys=topo_keys, serial=serial, weights=weights,
            enabled_filters=enabled_filters, cap_scale=1 << min(i, 20))
        if int(progress) == 0:
            break
    return state


def gang_schedule(ct: ClusterTensors, pb: PodBatch, seed: int = 0,
                  fit_strategy: str = "LeastAllocated",
                  topo_keys: tuple[int, ...] = (), serial: bool = False,
                  max_rounds: int = 64, weights=None, enabled_filters=None):
    """Drive rounds until convergence. Returns (assignment [P] np.int32 with -1
    for unschedulable, rounds_used). ``weights`` (plugin->weight) and
    ``enabled_filters`` (set of filter names) carry the active profile's
    plugin configuration. ``ct`` and ``pb`` are on one device; the rounds
    run there."""
    P = int(pb.pod_valid.shape[0])
    dev = pb.pod_valid.device
    ct_ext = extend_cluster(ct, pb)
    state = GangState(
        requested=ct.requested,
        committed=torch.zeros(P, dtype=torch.bool, device=dev),
        assignment=torch.full((P,), -1, dtype=torch.int32, device=dev),
        tried=torch.zeros(P, dtype=torch.bool, device=dev),
        rounds=0,
    )
    weights_t = tuple(sorted(weights.items())) if weights else ()
    filters_t = tuple(sorted(enabled_filters)) if enabled_filters else ()
    limit = max(P if serial else max_rounds, 1)
    state = _converge(ct_ext, pb, state, seed=seed,
                      fit_strategy=fit_strategy, topo_keys=topo_keys,
                      serial=serial, weights=weights_t,
                      enabled_filters=filters_t, max_rounds=limit)
    return state.assignment.cpu().numpy().astype(np.int32), state.rounds
