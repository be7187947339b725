"""Gang batcher — schedule P pods per step with conflict resolution.

The PyTorch port of ``kubernetes_tpu/models/gang.py``: the single-batch
``gang_schedule``, the multi-batch ``gang_drain`` and the device-resident
``drain_step`` with its fold and churn patch. The out-of-tree tensor
plugins (``plugins``) run inside every round, and so inside the rounds'
captured graphs on the card.

On a device mesh (``mesh=``, parallel/mesh.py) every shard runs the same
rounds at once: it evaluates its pod rows against its node slice, reads
the capacity at a proposed node from the shard that owns it, and folds
an accepted pod's requests on that shard only. The capacity accept and
the [P,P] relational veto are O(P) and O(P^2): every shard runs them over
the whole batch, on the gathered proposals, and gets the same answer. The
winners (assignments, rounds, the fill scalar) end up on the lead shard,
O(P) bytes; the folded state stays on its owner shards. A mesh's rounds
run eagerly (no CUDA graph: see parallel/mesh.py).
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

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from kubernetes_tpu_torch.device import resolve_device
from kubernetes_tpu_torch.encode.convert import patch_to
from kubernetes_tpu_torch.encode.snapshot import (ClusterTensors, PodBatch,
                                                  SelectorSet, _Tensors)
from kubernetes_tpu_torch.models import graphs
from kubernetes_tpu_torch.models.schedule_step import evaluate
from kubernetes_tpu_torch.ops.exprs import eval_selector_set
from kubernetes_tpu_torch.ops.sorting import lexsort
from kubernetes_tpu_torch.ops.topology import _gather_ns
from kubernetes_tpu_torch.parallel import mesh as mesh_mod

_I32_MIN = -(1 << 31)
_I32_MAX = (1 << 31) - 1


@dataclass
class GangState:
    requested: torch.Tensor    # [N,R] current (base + committed batch members)
    committed: torch.Tensor    # [P] bool
    assignment: torch.Tensor   # [P] int32, -1 unassigned
    tried: torch.Tensor        # [P] bool (serial mode: attempted exactly once)
    rounds: torch.Tensor       # 0-d int32: rounds run

    def fields(self) -> list:
        return [self.requested, self.committed, self.assignment, self.tried,
                self.rounds]


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
        # choices are global node ids: their domains come from the whole
        # node axis' column (gathered on a mesh shard)
        dv = mesh_mod.gather_nodes(ct.node_labels[:, k])            # [N]
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
                     cap_scale=1, slot_start=None, ext_mask=None,
                     ext_scores=None, plugins: tuple = ()):
    """One propose/accept/fold round. Returns (new_state, progress) where
    progress (a 0-d tensor) counts acceptances plus serial-mode attempts.
    ``slot_start``: index of this batch's extension slots in the epod
    tensors; defaults to the trailing P slots. ``ext_mask``/``ext_scores``:
    the extender veto and score overlay [P,N]; ``plugins``: the profile's
    out-of-tree TensorPlugins (see evaluate)."""
    P = state.committed.shape[0]
    N = ct_ext.node_valid.shape[0]
    dev = state.committed.device
    if slot_start is None:
        slot_start = ct_ext.epod_valid.shape[0] - P
    # wire committed members into this batch's extension slots
    epod_node = ct_ext.epod_node.clone()
    epod_node[slot_start:slot_start + P] = state.assignment
    epod_valid = ct_ext.epod_valid.clone()
    epod_valid[slot_start:slot_start + P] = state.committed
    ct_round = ct_ext.replace(requested=state.requested, epod_node=epod_node,
                              epod_valid=epod_valid)
    # a mesh shard evaluates its own pod rows (the whole batch elsewhere)
    pb_rows = mesh_mod.pod_rows(pb)
    committed_rows = mesh_mod.pod_rows(state.committed)
    pb_round = pb_rows.replace(pod_valid=pb_rows.pod_valid & ~committed_rows)
    res = evaluate(ct_round, pb_round, seed=seed,
                   fit_strategy=fit_strategy, topo_keys=topo_keys,
                   weights=dict(weights) if weights else None,
                   enabled_filters=frozenset(enabled_filters) if enabled_filters else None,
                   ext_mask=ext_mask, ext_scores=ext_scores, plugins=plugins)
    want_rows = res.assigned & ~committed_rows & pb_rows.pod_valid
    want = mesh_mod.gather_pods(want_rows)
    choice = mesh_mod.gather_pods(res.choice)
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
        # the reference's `(idx == target) & untried[target]`: only the
        # target's own entry can survive the first term, so `& untried`
        # is the same mask, and reading untried[target] (a host index
        # of a device scalar) would synchronise inside a graph capture
        is_target = (idx == target) & untried
        want = want & is_target
        tried = tried | is_target
        n_attempted = torch.sum(is_target)
    # rank: priority desc, batch index asc; non-proposing pods rank last
    prio_key = torch.where(want, -pb.priority, _I32_MAX)
    order0 = lexsort((idx, prio_key))
    rank = torch.zeros(P, dtype=torch.int32, device=dev)
    rank[order0] = idx
    free = ct_round.allocatable - state.requested                   # [N,R]
    # a choice is a global node id; on a mesh shard only its owner reads
    # the node's free capacity, and the owners' rows are summed
    choice_safe, own = mesh_mod.own_nodes(choice, N)
    free_at_choice = free[choice_safe]
    if own is not None:
        free_at_choice = mesh_mod.reduce_nodes(
            torch.where(own[:, None], free_at_choice, 0), "sum")
    # Balance guard: spread this round's acceptances across the nodes feasible
    # for someone, approximating the serial loop's load feedback. cap_scale
    # doubles every round (_converge), so strict-preference workloads where the
    # cap would serialize still converge in O(log P) rounds.
    hit = mesh_mod.reduce_pods(torch.any(res.feasible & want_rows[:, None],
                                         dim=0), "any")
    distinct = mesh_mod.reduce_nodes(torch.sum(hit), "sum")
    n_want = torch.sum(want)
    cap = torch.clamp(-(-n_want // torch.clamp(distinct, min=1)), min=1) * cap_scale
    accept = _segmented_capacity_accept(choice, want, rank, pb.requests,
                                        free_at_choice, per_node_cap=cap)
    accept = _relational_veto(ct_round, pb, choice, accept, rank, topo_keys)
    # fold: integer add of the accepted pods' requests at their nodes (exact;
    # an index_add_ in place of the reference's one-hot integer matmul),
    # on a mesh shard only at the nodes it owns
    add = torch.where(accept[:, None], pb.requests, 0)
    if own is not None:
        add = torch.where(own[:, None], add, 0)
    requested = state.requested.clone().index_add_(0, choice_safe, add)
    new_state = GangState(
        requested=requested,
        committed=state.committed | accept,
        assignment=torch.where(accept, choice, state.assignment),
        tried=tried,
        rounds=state.rounds + 1,
    )
    return new_state, torch.sum(accept) + n_attempted


# the chunk of rounds between two host reads on the card (``_converge``):
# every round past the last live one in a chunk is a dead round that costs
# a live one's device time, and every chunk one replay and one host read.
# On an H100 (700 W) K = 1 was 5-9% faster than K = 2 at the drain and
# resident shapes, K = 4 and 8 slower still (chip_smoke.py --chunks,
# PERF.md §6); 2 is the least K that does not read the host after every
# round. On the CPU a read costs nothing and every round is followed by
# one.
GRAPH_CHUNK = 2
CPU_CHUNK = 1


def default_chunk(device) -> int:
    """K on ``device``: GRAPH_CHUNK on the card, CPU_CHUNK on the CPU."""
    return GRAPH_CHUNK if torch.device(device).type == "cuda" else CPU_CHUNK


def _masked_round(ct_ext, pb, state: GangState, n, limit: int, kw: dict):
    """One trip of the reference's static-trip loop: the round runs when
    the previous one made progress (``n > 0``) and fewer than ``limit``
    have run; otherwise every field, ``rounds`` included, comes back as it
    was (``torch.where`` field by field), as the reference's ``cond``
    leaves its carry. ``cap_scale`` doubles every live round, from the
    device's round counter. -> (state, progress of this trip)."""
    live = (n > 0) & (state.rounds < limit)
    one = torch.ones((), dtype=torch.int64, device=n.device)
    cap = one << state.rounds.clamp(max=20).to(torch.int64)
    new, progress = _gang_round_impl(ct_ext, pb, state, cap_scale=cap, **kw)
    state = GangState(*(torch.where(live, a, b)
                        for a, b in zip(new.fields(), state.fields())))
    return state, torch.where(live, progress, torch.zeros_like(progress))


def converge_key(ct_ext, pb, state: GangState, *, limit: int, chunk: int,
                 slot_start: int, ext_mask=None, ext_scores=None,
                 **statics) -> tuple:
    """The graph key of a chunk of ``chunk`` rounds (models/graphs.py): the
    static arguments (the plugin tuple among them: a graph records the
    plugins' ops, so profiles with other plugins never share it), the round
    limit, K, every input tensor's address and layout, and the carried
    state's layout."""
    return graphs.graph_key(
        "gang_rounds",
        (tuple(sorted(statics.items())), int(limit), int(chunk),
         int(slot_start)),
        _tree_leaves(ct_ext) + _tree_leaves(pb) + [ext_mask, ext_scores],
        state.fields())


def _converge(ct_ext, pb, state, *, seed, fit_strategy, topo_keys,
              weights, enabled_filters, max_rounds,
              serial=False, slot_start=None, ext_mask=None,
              ext_scores=None, plugins: tuple = (),
              capture=True) -> GangState:
    """The reference's static trip of ``max_rounds`` cond-guarded rounds,
    cut at a chunk edge: rounds run K (``default_chunk``) at a time, each
    masked
    (``_masked_round``), and the host reads the progress flag once per
    chunk, never once per round. A chunk past the last live round changes
    nothing, so the cut gives the reference's rounds and assignments for
    every K. On the card the chunk is one captured CUDA graph, replayed
    (models/graphs.py); ``capture=False`` runs the same rounds eagerly."""
    limit = max(int(max_rounds), 1)
    P = int(state.committed.shape[0])
    dev = state.committed.device
    K = max(1, min(default_chunk(dev), limit))
    plugins = tuple(plugins)
    if slot_start is None:
        slot_start = int(ct_ext.epod_valid.shape[0]) - P
    kw = dict(seed=seed, fit_strategy=fit_strategy, topo_keys=topo_keys,
              serial=serial, weights=weights,
              enabled_filters=enabled_filters, slot_start=slot_start,
              ext_mask=ext_mask, ext_scores=ext_scores, plugins=plugins)

    def rounds(st: GangState, n):
        for _ in range(K):
            st, n = _masked_round(ct_ext, pb, st, n, limit, kw)
        return st, n

    def body(flat):
        st, n = rounds(GangState(*flat[:5]), flat[5])
        return st.fields() + [n]

    captured = (capture and dev.type == "cuda"
                and mesh_mod.current() is None)
    if captured:
        key = converge_key(ct_ext, pb, state, limit=limit, chunk=K,
                           slot_start=slot_start, ext_mask=ext_mask,
                           ext_scores=ext_scores, seed=seed,
                           fit_strategy=fit_strategy,
                           topo_keys=tuple(topo_keys), serial=bool(serial),
                           weights=tuple(weights),
                           enabled_filters=tuple(enabled_filters),
                           plugins=plugins)
    n = torch.ones((), dtype=torch.int64, device=dev)
    done = 0
    while True:
        if captured:
            flat = graphs.replay(key, body, state.fields() + [n])
            state, n = GangState(*flat[:5]), flat[5]
        else:
            state, n = rounds(state, n)
        done += K
        if done >= limit:
            break
        if mesh_mod.is_lead():
            graphs.count_host_read()
        if int(n) == 0:
            break
    if captured:
        # the graph's buffers are overwritten at its next replay
        state = GangState(*(t.clone() for t in state.fields()))
    return state


def gang_round(ct_ext: ClusterTensors, pb: PodBatch, state: GangState,
               seed: int = 0, fit_strategy: str = "LeastAllocated",
               topo_keys: tuple[int, ...] = (), serial: bool = False,
               mesh=None):
    """One propose/accept/fold round over an extended cluster (the
    reference's ``gang_round``) -> (new state, progress). ``mesh``: run it
    on every shard of a parallel/mesh.Mesh (``ct_ext`` a ClusterTensors,
    split here, or a ShardedCluster); the state comes back whole on the
    mesh's lead device."""
    kw = dict(seed=seed, fit_strategy=fit_strategy,
              topo_keys=tuple(topo_keys), serial=serial)
    if mesh is None:
        return _gang_round_impl(ct_ext, pb, state, **kw)
    ct_s = (ct_ext if isinstance(ct_ext, mesh_mod.ShardedCluster)
            else mesh_mod.shard_cluster(mesh, ct_ext))
    pbs = mesh_mod.shard_batch(mesh, pb)
    layout = mesh_mod.Layout(mesh, ct_s.layout.N,
                             int(pb.pod_valid.shape[0]))

    def body(piece, pb_dev):
        dev = pb_dev.pod_valid.device
        fields = [t.to(dev) for t in state.fields()]
        fields[0] = mesh_mod.node_slice(fields[0]).clone()
        new, n = _gang_round_impl(piece, pb_dev, GangState(*fields), **kw)
        return (GangState(mesh_mod.gather_nodes(new.requested),
                          *new.fields()[1:]), n)

    out = mesh_mod.run(layout, body, [
        (piece, pbs[d]) for piece, d in zip(ct_s.pieces, mesh.device_list())])
    st, n = out[0]
    lead = mesh.lead
    return GangState(*(t.to(lead) for t in st.fields())), n.to(lead)


def gang_schedule(ct: ClusterTensors, pb: PodBatch, seed: int = 0,
                  fit_strategy: str = "LeastAllocated",
                  topo_keys: tuple[int, ...] = (), serial: bool = False,
                  max_rounds: int = 64, weights=None, enabled_filters=None,
                  ext_mask=None, ext_scores=None, plugins: tuple = (),
                  capture: bool = True, mesh=None):
    """Drive rounds until convergence. Returns (assignment [P] np.int32 with -1
    for unschedulable, rounds_used). ``weights`` (plugin->weight) and
    ``enabled_filters`` (set of filter names) carry the active profile's
    plugin configuration. ``ct`` and ``pb`` are on one device; the rounds
    run there. ``ext_mask`` [P,N] bool / ``ext_scores`` [P,N] float32
    (numpy, at the bucketed dims): the extender pass's veto and score
    overlay, copied to that device once for every round. ``plugins``: the
    profile's out-of-tree TensorPlugins (sched/framework.py), run in every
    round. ``capture``: on the card, replay each chunk of rounds as a CUDA
    graph (False: run it eagerly, for comparisons). ``mesh``: run the
    rounds on every shard of a parallel/mesh.Mesh (eagerly); the
    assignment equals the single-device one."""
    P = int(pb.pod_valid.shape[0])
    dev = pb.pod_valid.device
    ct_ext = extend_cluster(ct, pb)
    weights_t = tuple(sorted(weights.items())) if weights else ()
    filters_t = tuple(sorted(enabled_filters)) if enabled_filters else ()
    limit = max(P if serial else max_rounds, 1)
    if mesh is not None:
        kw = dict(seed=seed, fit_strategy=fit_strategy,
                  topo_keys=topo_keys, serial=serial, weights=weights_t,
                  enabled_filters=filters_t, max_rounds=limit,
                  plugins=plugins, capture=False)
        with graphs.LOCK:
            st = _gang_schedule_sharded(mesh, ct_ext, pb, ext_mask,
                                        ext_scores, kw)
        return (st.assignment.cpu().numpy().astype(np.int32),
                int(st.rounds))
    if ext_mask is not None:
        ext_mask = torch.as_tensor(ext_mask, dtype=torch.bool, device=dev)
    if ext_scores is not None:
        ext_scores = torch.as_tensor(ext_scores, dtype=torch.float32,
                                     device=dev)
    with graphs.LOCK:
        if capture and dev.type == "cuda":
            ct_ext = _stable("gang_ct", ct_ext)
            pb = _stable("gang_pb", pb)
            ext_mask, ext_scores = graphs.stable("gang_ext",
                                                 [ext_mask, ext_scores])
        state = _converge(ct_ext, pb, _new_state(ct.requested, P, dev),
                          seed=seed, fit_strategy=fit_strategy,
                          topo_keys=topo_keys, serial=serial,
                          weights=weights_t, enabled_filters=filters_t,
                          max_rounds=limit, ext_mask=ext_mask,
                          ext_scores=ext_scores, plugins=plugins,
                          capture=capture)
    return (state.assignment.cpu().numpy().astype(np.int32),
            int(state.rounds))


def _shard_overlay(x, dtype, dev):
    """A shard's block of an extender [P,N] overlay (numpy or None)."""
    if x is None:
        return None
    t = torch.as_tensor(x, dtype=dtype).to(dev)
    return mesh_mod.node_slice(mesh_mod.pod_rows(t), 1)


def _gang_schedule_sharded(mesh, ct_ext, pb, ext_mask, ext_scores,
                           kw) -> GangState:
    """``gang_schedule``'s rounds on every shard of ``mesh``; -> the lead
    shard's final state (its ``requested`` is its node slice)."""
    ct_s = mesh_mod.shard_cluster(mesh, ct_ext)
    pbs = mesh_mod.shard_batch(mesh, pb)
    P = int(pb.pod_valid.shape[0])
    layout = mesh_mod.Layout(mesh, ct_s.layout.N, P)

    def body(piece, pb_dev):
        dev = pb_dev.pod_valid.device
        return _converge(
            piece, pb_dev, _new_state(piece.requested, P, dev),
            ext_mask=_shard_overlay(ext_mask, torch.bool, dev),
            ext_scores=_shard_overlay(ext_scores, torch.float32, dev), **kw)

    return mesh_mod.run(layout, body, [
        (piece, pbs[d]) for piece, d in zip(ct_s.pieces,
                                            mesh.device_list())])[0]


# -- multi-batch drain: the whole queue in one call ---------------------------
#
# The containers are dataclasses, so the reference's pytree walks become
# walks over fields by name, nested SelectorSet and TermSet included. A leaf
# is a numpy array (as the encoder fills it) or a torch tensor.

def _tree_map(fn, *trees):
    """``fn`` over the leaves of equally built containers, field by field;
    -> a container of the results (a non-container argument is a leaf)."""
    first = trees[0]
    if isinstance(first, _Tensors):
        return first.replace(**{
            f.name: _tree_map(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(first)})
    return fn(*trees)


def _tree_leaves(tree) -> list:
    """The leaves of a container in field order (``_tree_map``'s order)."""
    if isinstance(tree, _Tensors):
        return [leaf for f in dataclasses.fields(tree)
                for leaf in _tree_leaves(getattr(tree, f.name))]
    return [tree]


def _fill_value(a):
    """Pad value by dtype: False for bool, 0.0 for float, -1 otherwise
    (every padded region is guarded by its validity flag)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bool:
            return False
        return 0.0 if a.dtype.is_floating_point else -1
    if a.dtype == bool:
        return False
    return 0.0 if np.issubdtype(a.dtype, np.floating) else -1


def _pad_to(a, shape: tuple[int, ...], fill):
    """Pad ``a`` (numpy or torch) at the end of each axis up to ``shape``."""
    shape = tuple(shape)
    if tuple(a.shape) == shape:
        return a
    if isinstance(a, torch.Tensor):
        out = torch.full(shape, fill, dtype=a.dtype, device=a.device)
        out[tuple(slice(0, s) for s in a.shape)] = a
        return out
    return np.pad(a, [(0, t - s) for s, t in zip(a.shape, shape)],
                  constant_values=fill)


def unify_batches(pbs: list[PodBatch]) -> list[PodBatch]:
    """Pad every leaf of each PodBatch to the max shape across batches.
    Bucket dims (selector terms, toleration slots, ...) can differ batch to
    batch; every padded region is guarded by its validity flag, so the
    dtype-driven fills (-1 ids / False / 0.0) are inert."""
    shapes = _tree_map(lambda *xs: tuple(max(x.shape[d] for x in xs)
                                         for d in range(xs[0].ndim)), *pbs)
    return [_tree_map(lambda a, shape: _pad_to(a, shape, _fill_value(a)),
                      pb, shapes) for pb in pbs]


def stack_batches(pbs: list[PodBatch]) -> PodBatch:
    """Equally shaped PodBatches -> one PodBatch with a leading B axis."""
    return _tree_map(lambda *xs: (torch.stack(xs)
                                  if isinstance(xs[0], torch.Tensor)
                                  else np.stack(xs)), *pbs)


def _batch(pb_stack: PodBatch, b: int) -> PodBatch:
    """Batch ``b`` of a stacked PodBatch (views)."""
    return _tree_map(lambda x: x[b], pb_stack)


def extend_cluster_drain(ct: ClusterTensors, pbs: list[PodBatch]
                         ) -> tuple[ClusterTensors, int]:
    """Chain P extension slots for EVERY batch onto the cluster: batch b's
    pods live at epod slots [e0 + b*P, e0 + (b+1)*P). Committed members of
    earlier batches therefore stay relationally visible (spread counts,
    affinity, anti-affinity symmetry) to later batches — the sequential
    semantics of the reference's one-pod-at-a-time loop. Takes torch
    tensors, like ``extend_cluster``."""
    e0 = int(ct.epod_valid.shape[0])
    for pb in pbs:
        ct = extend_cluster(ct, pb)
    return ct, e0


def _new_state(requested, P: int, dev) -> GangState:
    return GangState(requested=requested,
                     committed=torch.zeros(P, dtype=torch.bool, device=dev),
                     assignment=torch.full((P,), -1, dtype=torch.int32,
                                           device=dev),
                     tried=torch.zeros(P, dtype=torch.bool, device=dev),
                     rounds=torch.zeros((), dtype=torch.int32, device=dev))


def _stable(tag: str, tree):
    """``tree`` copied into persistent buffers of its shapes on the card
    (models/graphs.stable), so the graphs keyed on their addresses are
    found again at the next call of the same shapes."""
    bufs = iter(graphs.stable(tag, _tree_leaves(tree)))
    return _tree_map(lambda _: next(bufs), tree)


def _drain_batches(ct: ClusterTensors, pb_stack: PodBatch, e0: int,
                   kw: dict):
    """The reference's ``lax.scan`` over batches as a loop: each batch is a
    full convergence against the cluster plus every earlier batch's
    committed pods, and its own committed slots are written into
    ``ct.epod_node``/``ct.epod_valid`` IN PLACE for the batches after it.
    On the card each batch's chunk of rounds is a captured graph, keyed on
    the context's addresses and on the batch's slot start; the batches are
    first copied into persistent buffers. The rounds stay on the device.
    -> (assignments [B,P] int32, rounds [B] int32, requested [N,R])."""
    B, P = pb_stack.pod_valid.shape
    dev = pb_stack.pod_valid.device
    requested = ct.requested
    assignments, rounds = [], []
    with graphs.lock():
        if (kw.get("capture", True) and dev.type == "cuda"
                and mesh_mod.current() is None):
            pb_stack = _stable("drain_pb", pb_stack)
        for b in range(B):
            start = e0 + b * P
            st = _converge(ct, _batch(pb_stack, b),
                           _new_state(requested, P, dev), slot_start=start,
                           **kw)
            ct.epod_node[start:start + P] = st.assignment
            ct.epod_valid[start:start + P] = st.committed
            requested = st.requested
            assignments.append(st.assignment)
            rounds.append(st.rounds)
    return torch.stack(assignments), torch.stack(rounds), requested


def _drain_kw(seed, fit_strategy, topo_keys, weights, enabled_filters,
              max_rounds, capture=True, plugins=()) -> dict:
    return dict(seed=seed, fit_strategy=fit_strategy,
                topo_keys=tuple(topo_keys), weights=tuple(weights),
                enabled_filters=tuple(enabled_filters),
                max_rounds=max_rounds, plugins=plugins, capture=capture)


def prepare_drain(ct: ClusterTensors, pbs: list[PodBatch], device=None):
    """Drain prep: unify the batch buckets, stack the batches, move cluster
    and batches to ``device`` (None: the CUDA card) and chain the extension
    slots there. Returns an opaque (ct_all, pb_stack, e0) tuple for
    gang_drain; repeated drains over it pay no transfer again."""
    dev = resolve_device(device)
    pbs_u = unify_batches(pbs)
    pb_stack = stack_batches(pbs_u).to(dev)
    ct_all, e0 = extend_cluster_drain(
        ct.to(dev), [_batch(pb_stack, b) for b in range(len(pbs_u))])
    return ct_all, pb_stack, e0


def gang_drain(ct: ClusterTensors = None, pbs: list[PodBatch] = None,
               seed: int = 0, fit_strategy: str = "LeastAllocated",
               topo_keys: tuple[int, ...] = (), weights=None,
               enabled_filters=None, max_rounds: int = 64, prepared=None,
               device=None, plugins: tuple = (), capture: bool = True):
    """Schedule a whole queue of batches in one call.

    A loop over the batch axis, each step a full gang convergence,
    carrying (requested[N,R], epod slot state) batch to batch — so capacity
    AND relational effects of earlier batches are visible to later ones.
    The carries stay on the device; the host reads the results once, at
    the end, besides one read of the progress flag per chunk of rounds.

    Returns (assignments [B,P] np.int32 with -1 unschedulable,
    rounds [B] np.int32, requested_final [N,R] np.int32).

    ``prepared``: the result of prepare_drain() — pass it to amortize host
    prep and staging across repeated drains of the same queue (it is not
    modified). Otherwise ``ct`` and ``pbs`` are prepared on ``device``.
    ``plugins`` and ``capture``: as ``gang_schedule``.
    """
    if prepared is None:
        prepared = prepare_drain(ct, pbs, device=device)
    ct_all, pb_stack, e0 = prepared
    if capture and ct_all.epod_node.is_cuda:
        # a copy in persistent buffers: the graphs find it again
        ct_run = _stable("drain_ct", ct_all)
    else:
        ct_run = ct_all.replace(epod_node=ct_all.epod_node.clone(),
                                epod_valid=ct_all.epod_valid.clone())
    kw = _drain_kw(seed, fit_strategy, topo_keys,
                   sorted(weights.items()) if weights else (),
                   sorted(enabled_filters) if enabled_filters else (),
                   max_rounds, capture, plugins)
    with graphs.LOCK:
        assignments, rounds, requested = _drain_batches(ct_run, pb_stack,
                                                        e0, kw)
        return (assignments.cpu().numpy(), rounds.cpu().numpy(),
                requested.cpu().numpy())


# -- device-resident drain: cluster tensors stay on the card across drains ----
#
# The connected scheduler's steady state is a loop of drains over an almost
# unchanged cluster. The encoding stays on the device and each drain ships
# only the new pod batches: refill the extension rows from the batch, run
# the batches, then FOLD committed pods into free base existing-pod slots.
# Where the reference donates its buffers, this port updates the resident
# tensors in place.

def _flat(x):
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def drain_widths_fit(ct_all: ClusterTensors, pb_stack: PodBatch) -> bool:
    """The batch's bucket widths must fit the resident extension slots
    (they only grow when pods carry new label keys / wider anti-affinity
    terms — the caller rebuilds the context when they do)."""
    if isinstance(ct_all, mesh_mod.ShardedCluster):
        ct_all = ct_all.pieces[0]
    return (pb_stack.pod_labels.shape[2] <= ct_all.epod_labels.shape[1]
            and pb_stack.anti_valid.shape[2] <= ct_all.ea_valid.shape[1]
            and pb_stack.anti_sel.key.shape[3] <= ct_all.ea_sel.key.shape[2]
            and pb_stack.anti_sel.vals.shape[4] <= ct_all.ea_sel.vals.shape[3]
            and pb_stack.anti_ns_mask.shape[3] <= ct_all.ea_ns_mask.shape[2]
            and pb_stack.requests.shape[2] == ct_all.requested.shape[1])


def batch_shapes(pb_stack: PodBatch) -> list[tuple]:
    return [tuple(leaf.shape) for leaf in _tree_leaves(pb_stack)]


def pad_batch_to(pb_stack: PodBatch, shapes: list[tuple]):
    """Pad every leaf of a stacked PodBatch up to recorded target shapes
    (``batch_shapes`` of the batch the context was built with), so the
    resident context keeps one set of shapes whatever each pop's bucket
    widths. Returns None when any leaf EXCEEDS its target — the caller must
    rebuild the context at the wider shape."""
    leaves = _tree_leaves(pb_stack)
    if any(s > t for leaf, target in zip(leaves, shapes)
           for s, t in zip(leaf.shape, target)):
        return None
    targets = iter(shapes)
    return _tree_map(lambda a: _pad_to(a, next(targets), _fill_value(a)),
                     pb_stack)


def build_drain_context(ct: ClusterTensors, pbs: list[PodBatch],
                        nom_bucket: int = 0, device=None, mesh=None):
    """One-time prep for the device-resident drain: unify the batch
    buckets, copy the cluster to ``device`` (None: the CUDA card), chain
    the extension slots (content is placeholder — drain_step refills it).
    Returns ``(ct_all, e0, fill0)`` or None when the base epod slots aren't
    packed (fold targets assume [0,fill) occupied, [fill,e0) free — true
    after any full encode; host-side patches with deletes can leave holes).

    Every tensor of ``ct_all`` is a fresh copy, on the CPU too: drain_step
    updates them in place and must never write into the host encoding.

    ``nom_bucket``: size of the RESIDENT nominee-reservation tensors. The
    base encode carries zero nominees; giving the context a fixed M lets
    preemption storms patch reservations in place (apply_ctx_patch).

    ``mesh``: a parallel/mesh.Mesh -- the context is built on its lead
    device and split over it (``shard_cluster``): a ShardedCluster whose
    node-major tensors stay on their owner shards from then on."""
    dev = mesh.lead if mesh is not None else resolve_device(device)
    valid = np.asarray(ct.epod_valid.cpu() if isinstance(ct.epod_valid,
                                                         torch.Tensor)
                       else ct.epod_valid)
    fill0 = int(valid.sum())
    if fill0 and not valid[:fill0].all():
        return None  # holes: the fold would overwrite occupied slots
    pbs_u = unify_batches(pbs)
    pb_stack = stack_batches(pbs_u).to(dev)
    ct_dev = _tree_map(lambda x: torch.as_tensor(x).to(dev, copy=True), ct)
    ct_all, e0 = extend_cluster_drain(
        ct_dev, [_batch(pb_stack, b) for b in range(len(pbs_u))])
    if nom_bucket:
        R = int(ct_all.requested.shape[1])
        ct_all = ct_all.replace(
            nom_node=torch.full((nom_bucket,), -1, dtype=torch.int32,
                                device=dev),
            nom_prio=torch.zeros(nom_bucket, dtype=torch.int32, device=dev),
            nom_req=torch.zeros((nom_bucket, R), dtype=torch.int32,
                                device=dev),
            nom_valid=torch.zeros(nom_bucket, dtype=torch.bool, device=dev))
    if mesh is not None:
        ct_all = mesh_mod.shard_cluster(mesh, ct_all)
    return ct_all, e0, fill0


def adopt_storage(old, new):
    """``new``'s content written into ``old``'s tensors when every leaf
    has the same shape, dtype and device, so the graphs captured on
    ``old`` (models/graphs.py keys them on its addresses) serve ``new``;
    -> ``old``, or ``new`` itself when the shapes differ (it is captured
    anew at its first drain)."""
    if old is None:
        return new
    sharded = [isinstance(c, mesh_mod.ShardedCluster) for c in (old, new)]
    if any(sharded):
        if (not all(sharded) or old.mesh is not new.mesh
                or old.layout != new.layout):
            return new
        kept = [adopt_storage(o, n) for o, n in zip(old.pieces, new.pieces)]
        return old if all(k is o for k, o in zip(kept, old.pieces)) else new
    lo, ln = _tree_leaves(old), _tree_leaves(new)
    if len(lo) != len(ln) or any(
            a.shape != b.shape or a.dtype != b.dtype or a.device != b.device
            for a, b in zip(lo, ln)):
        return new
    for a, b in zip(lo, ln):
        a.copy_(b)
    return old


def _refill(dst, e0: int, src, fill) -> None:
    """dst[e0:] = src, padded at the end of its trailing axes with ``fill``."""
    region = dst[e0:]
    region.copy_(_pad_to(src, tuple(region.shape), fill))


# fields the fold packs into base slots, by (container attribute, field)
_FOLDED = (("epod_ns",), ("epod_labels",), ("ea_sel", "key"),
           ("ea_sel", "op"), ("ea_sel", "vals"), ("ea_sel", "expr_valid"),
           ("ea_sel", "valid"), ("ea_topo",), ("ea_valid",),
           ("ea_ns_explicit",), ("ea_ns_mask",))


def _field(ct, path):
    for name in path:
        ct = getattr(ct, name)
    return ct


def drain_step(ct_all: ClusterTensors, pb_stack: PodBatch, fill,
               patch=None, *, e0: int, seed: int = 0,
               fit_strategy: str = "LeastAllocated",
               topo_keys: tuple[int, ...] = (), weights: tuple = (),
               enabled_filters: tuple = (), max_rounds: int = 64,
               plugins: tuple = (), capture: bool = True):
    """One fused drain over a DEVICE-RESIDENT cluster encoding.

    ``ct_all``: rows [0,e0) are base existing-pod slots (``fill`` of them
    occupied, packed), rows [e0,e0+B*P) are extension slots whose content
    this call overwrites from ``pb_stack`` (numpy or tensors; moved to the
    context's device in one call).
    ``fill``: a 0-d int32 tensor on the device (the previous call's
    ``new_fill``), or a Python int on the first call.

    Where the reference donates ``ct_all`` and ``fill``, this call updates
    ``ct_all``'s tensors IN PLACE and consumes the container: the
    ``ct_out`` it returns is the same object, folded. ``fill`` itself is
    not written.

    Returns ``(assignments [B,P] int32, rounds [B] int32, ct_out,
    new_fill)``, all on the device: every committed pod is folded into
    base slots [fill, fill+n) in flattened batch order and the extension
    region is invalidated — ready to be the next call's ``ct_all``.
    Reading ``new_fill`` on the host is the caller's business.

    ``patch``: optional compiled churn patch (encode/patch.py; numpy arrays
    by key), applied in front of the batches as ``apply_ctx_patch`` would
    apply it.

    On the card the rounds are captured graphs that read the context at
    its addresses (models/graphs.py): a context rebuilt elsewhere is
    captured anew. ``plugins`` and ``capture``: as ``gang_schedule``. The
    fold's ``nonzero`` and the patch's row filters read the host outside
    them.

    A ``ct_all`` split over a mesh (a parallel/mesh.ShardedCluster, from
    ``build_drain_context(..., mesh=)``) drains on every shard at once
    (eagerly): ``pb_stack`` is a stack or its per-device copies
    (``presplit_stack``), the patch's node rows go to their owner shards,
    and the winners and ``new_fill`` come back on the lead device.
    """
    kw = dict(e0=e0, seed=seed, fit_strategy=fit_strategy,
              topo_keys=topo_keys, weights=weights,
              enabled_filters=enabled_filters, max_rounds=max_rounds,
              plugins=plugins)
    if isinstance(ct_all, mesh_mod.ShardedCluster):
        return _drain_step_sharded(ct_all, pb_stack, fill, patch, **kw)
    return _drain_step_local(ct_all, pb_stack, fill, patch, capture=capture,
                             **kw)


def _drain_step_local(ct_all: ClusterTensors, pb_stack: PodBatch, fill,
                      patch, *, e0: int, seed: int, fit_strategy: str,
                      topo_keys: tuple, weights: tuple,
                      enabled_filters: tuple, max_rounds: int,
                      plugins: tuple, capture: bool):
    """``drain_step`` on one device (or one mesh shard's pieces)."""
    B, P = pb_stack.pod_valid.shape
    BP = B * P
    E = int(ct_all.epod_valid.shape[0])
    if E != e0 + BP:
        raise ValueError(f"the context holds {E} epod slots, not e0 + B*P = "
                         f"{e0} + {BP}: build it with this batch count")
    dev = ct_all.epod_valid.device
    pb_stack = pb_stack.to(dev)
    if patch is not None:
        _apply_patch(ct_all, patch_to(patch, dev))
    ea = ct_all.ea_sel
    _refill(ct_all.epod_node, e0, torch.full((BP,), -1, dtype=torch.int32,
                                             device=dev), -1)
    _refill(ct_all.epod_ns, e0, _flat(pb_stack.pod_ns), -1)
    _refill(ct_all.epod_labels, e0, _flat(pb_stack.pod_labels), -1)
    ct_all.epod_valid[e0:] = False
    _refill(ea.key, e0, _flat(pb_stack.anti_sel.key), -1)
    _refill(ea.op, e0, _flat(pb_stack.anti_sel.op), 0)
    _refill(ea.vals, e0, _flat(pb_stack.anti_sel.vals), -1)
    _refill(ea.expr_valid, e0, _flat(pb_stack.anti_sel.expr_valid), False)
    _refill(ea.valid, e0, _flat(pb_stack.anti_sel.valid), False)
    _refill(ct_all.ea_topo, e0, _flat(pb_stack.anti_topo), -1)
    _refill(ct_all.ea_valid, e0, _flat(pb_stack.anti_valid), False)
    _refill(ct_all.ea_ns_explicit, e0, _flat(pb_stack.anti_ns_explicit),
            False)
    _refill(ct_all.ea_ns_mask, e0, _flat(pb_stack.anti_ns_mask), False)

    kw = _drain_kw(seed, fit_strategy, topo_keys, weights, enabled_filters,
                   max_rounds, capture, plugins)
    assignments, rounds, requested = _drain_batches(ct_all, pb_stack, e0, kw)
    ct_all.requested.copy_(requested)

    # ---- fold committed pods into base slots [fill, fill+n) -------------
    # the exclusive prefix count of the committed flags is fill + k for the
    # k-th committed row; the reference's scatter drops a destination past
    # the end, so such rows are filtered here (CUDA would assert instead)
    flat = assignments.reshape(BP)
    src = torch.nonzero(flat >= 0).squeeze(1)
    fill_t = torch.as_tensor(fill, dtype=torch.int32, device=dev)
    dest = fill_t + torch.arange(src.shape[0], dtype=torch.int32, device=dev)
    new_fill = fill_t + src.shape[0]
    keep = dest < E
    src, dest = src[keep], dest[keep].long()
    rows = e0 + src
    for path in _FOLDED:
        arr = _field(ct_all, path)
        # the right side is a copy (advanced indexing), taken before any
        # destination row is written
        arr[dest] = arr[rows]
    ct_all.epod_node[dest] = flat[src]
    ct_all.epod_valid[dest] = True
    # invalidate the extension region (labels/terms of dead rows are inert
    # once the valid flags drop)
    ct_all.epod_valid[e0:] = False
    ct_all.ea_valid[e0:] = False
    return assignments, rounds, ct_all, new_fill


def _per_device(mesh, x) -> dict:
    """``x`` (a tensor, or a Python int) on each distinct device."""
    return {d: (x.to(d) if isinstance(x, torch.Tensor) else x)
            for d in mesh.distinct_devices()}


def _drain_step_sharded(ct_all, pb_stack, fill, patch, **kw):
    """``drain_step`` on every shard of ``ct_all.mesh``; the lead shard's
    winners. The thread that calls it holds ``graphs.LOCK`` for them."""
    m = ct_all.mesh
    stacks = (pb_stack if isinstance(pb_stack, dict)
              else mesh_mod.presplit_stack(m, pb_stack))
    lead_stack = stacks[m.lead]
    P = int(lead_stack.pod_valid.shape[1])
    layout = mesh_mod.Layout(m, ct_all.layout.N, P)
    patches = ({d: patch_to(patch, d) for d in m.distinct_devices()}
               if patch is not None else None)
    fills = _per_device(m, fill)

    def body(piece, d):
        return _drain_step_local(piece, stacks[d], fills[d],
                                 None if patches is None else patches[d],
                                 capture=False, **kw)

    with graphs.LOCK:
        out = mesh_mod.run(layout, body, [
            (piece, d) for piece, d in zip(ct_all.pieces, m.device_list())])
    assignments, rounds, _ct, new_fill = out[0]
    # the folded state stayed on its owner shards: the output is the input
    return assignments, rounds, mesh_mod.constrain_cluster(m, ct_all), \
        new_fill


# churn-patch scatters: (container field path, patch key) by row kind
_POD_ROWS = ((("epod_node",), "pod_node"), (("epod_ns",), "pod_ns"),
             (("epod_labels",), "pod_labels"), (("epod_valid",), "pod_valid"),
             (("ea_sel", "key"), "ea_sel_key"), (("ea_sel", "op"), "ea_sel_op"),
             (("ea_sel", "vals"), "ea_sel_vals"),
             (("ea_sel", "expr_valid"), "ea_sel_expr_valid"),
             (("ea_sel", "valid"), "ea_sel_valid"),
             (("ea_topo",), "ea_topo"), (("ea_valid",), "ea_valid"),
             (("ea_ns_explicit",), "ea_ns_explicit"),
             (("ea_ns_mask",), "ea_ns_mask"))
_NODE_ROWS = ((("allocatable",), "n_alloc"), (("node_valid",), "n_valid"),
              (("unschedulable",), "n_unsched"),
              (("node_labels",), "n_labels"),
              (("taint_key",), "n_taint_key"), (("taint_val",), "n_taint_val"),
              (("taint_effect",), "n_taint_effect"),
              (("taint_valid",), "n_taint_valid"),
              (("node_images",), "n_images"),
              (("attach_limit",), "n_attach_limit"))
_NOM_ROWS = ((("nom_node",), "nom_node"), (("nom_prio",), "nom_prio"),
             (("nom_req",), "nom_req"), (("nom_valid",), "nom_valid"))


def _patch_rows(idx, dim: int):
    """(patch rows, target rows) of the entries of ``idx`` inside [0, dim):
    the reference's drop-mode scatter ignores the others (-1 pads)."""
    keep = (idx >= 0) & (idx < dim)
    return torch.nonzero(keep).squeeze(1), idx[keep].long()


def _scatter(ct, table, patch, src, dst) -> None:
    for path, key in table:
        _field(ct, path)[dst] = patch[key][src]


def _apply_patch(ct_all: ClusterTensors, patch: dict) -> ClusterTensors:
    """The churn-patch scatter, in place: pod slot rewrites/clears, node
    row rewrites/retires, nominee reservation diffs, and the dense
    requested[N,R] delta. Shared by ``apply_ctx_patch`` and the fused
    ``drain_step``, so the two paths can never drift. ``patch`` holds
    tensors on the context's device.

    Reference shape: the incremental half of ``Cache.UpdateSnapshot``
    (pkg/scheduler/internal/cache/cache.go) — churn moves only what changed.

    On a mesh shard the node rows (and the requested delta's) are its own
    slice's, renumbered locally; pod and nominee rows go to every shard's
    copy."""
    N = int(ct_all.node_valid.shape[0])
    psrc, pdst = _patch_rows(patch["pod_slot"], int(ct_all.epod_valid.shape[0]))
    nsrc, ndst = _patch_rows(mesh_mod.local_nodes(patch["node_row"]), N)
    msrc, mdst = _patch_rows(patch["nom_slot"], int(ct_all.nom_valid.shape[0]))

    # node rows being reset (fresh assignment of a freed/new row) clear the
    # pod-contributed state patches cannot reconstruct (ports/volumes are
    # guarded unpatchable, so a resettable row never has live entries);
    # reset first, then the delta, as in the reference
    reset = torch.zeros(N, dtype=torch.bool, device=ct_all.node_valid.device)
    reset[ndst] = patch["n_reset"][nsrc]
    ct_all.requested.masked_fill_(reset[:, None], 0).add_(
        mesh_mod.node_slice(patch["req_delta"]))
    ct_all.label_value_num.copy_(patch["label_value_num"])
    _scatter(ct_all, _POD_ROWS, patch, psrc, pdst)
    _scatter(ct_all, _NODE_ROWS, patch, nsrc, ndst)
    ct_all.attach_used.masked_fill_(reset, 0)
    ct_all.port_valid.masked_fill_(reset[:, None], False)
    ct_all.used_rwo_valid.masked_fill_(reset[:, None], False)
    _scatter(ct_all, _NOM_ROWS, patch, msrc, mdst)
    return ct_all


def apply_ctx_patch(ct_all: ClusterTensors, patch: dict) -> ClusterTensors:
    """Standalone churn-patch apply (rebuild-time nominee staging): the
    compiled patch (numpy arrays by key) moves to the context's device
    (``convert.patch_to``) and scatters into ``ct_all`` in place;
    -> ``ct_all``. A context split over a mesh takes the patch on every
    shard, its node rows routed to their owner shards."""
    if isinstance(ct_all, mesh_mod.ShardedCluster):
        m = ct_all.mesh
        patches = {d: patch_to(patch, d) for d in m.distinct_devices()}
        layout = mesh_mod.Layout(m, ct_all.layout.N, 0)
        mesh_mod.run(layout, _apply_patch, [
            (piece, patches[d])
            for piece, d in zip(ct_all.pieces, m.device_list())])
        return ct_all
    return _apply_patch(ct_all, patch_to(patch, ct_all.node_valid.device))
