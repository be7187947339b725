"""Tensor-batched eviction planning — K candidate sets, ONE re-placement
simulation.

Reference: ``kubernetes-sigs/descheduler`` (``pkg/descheduler/descheduler.go``
Run + ``pkg/descheduler/evictions``). The reference validates each eviction
by asking the scheduler framework one (pod, node) pair at a time; here the
union of every candidate set's victims encodes into ONE ``PodBatch`` and a
single ``run_filters``/``run_scores`` pass answers every (victim × node)
re-placement question — the K-way candidate search costs one device program
instead of K sequential simulations (the same inversion
``autoscaler/simulator.py`` applies to scale-up: the loop axis becomes a
tensor axis).

"Masking candidate victim rows out of the encoded cluster" happens on the
host ledger, not the device: the feasibility mask is computed against the
FULL encoding (victims still resident) which is conservative — a target's
free space never includes room another candidate's eviction would open — and
the per-set capacity arithmetic releases exactly the accepted victims'
request vectors (``with_hypothetical`` in reverse: instead of overlaying
hypothetical capacity, hypothetically vacated capacity is credited back).
Accepted sets share one ledger, so two sets approved in one cycle can never
double-book a survivor node's room (same discipline as
``simulate_scale_down``).

The PyTorch port of ``kubernetes_tpu/descheduler/planner.py``: the cold
encode runs its one ``run_filters`` + ``combined_score`` on ``device``
(None = the card), the resident path on the scheduler's context.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.autoscaler.simulator import drain_exempt
from kubernetes_tpu_torch.device import resolve_device
from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
from kubernetes_tpu_torch.ops.filters import FILTERS, run_filters
from kubernetes_tpu_torch.ops.scores import combined_score

# Resource fit is deliberately NOT part of the device mask: the mask is
# computed against the full encoding (victims still resident), so the fit
# filter would veto exactly the placements the evictions open up. Capacity
# is the host ledger's job — same arithmetic (requests vs allocatable -
# requested, "pods" slot included), but against the post-eviction state.
REPLACEMENT_FILTERS = frozenset(FILTERS) - {"NodeResourcesFit"}


def evictable(p: Pod) -> bool:
    """Pods a descheduler strategy may nominate: daemon/mirror pods are
    node-bound (their replacement lives and dies with the node) and
    terminal pods need no re-placement home."""
    return not drain_exempt(p.metadata.annotations,
                            p.metadata.owner_references)


@dataclass
class CandidateSet:
    """One candidate eviction set a strategy proposed."""

    name: str
    strategy: str
    victims: list[Pod]
    # node names the victims' re-placement must avoid (the nodes this set
    # intends to drain — parking a victim back on them defeats the plan)
    exclude_targets: set[str] = field(default_factory=set)
    reason: str = ""


@dataclass
class AcceptedSet:
    name: str
    strategy: str
    victims: list[Pod]
    # victim pod key -> target node the proof parked it on
    moves: list[tuple[str, str]] = field(default_factory=list)
    reason: str = ""


@dataclass
class EvictionPlan:
    accepted: list[AcceptedSet] = field(default_factory=list)
    blocked: dict[str, str] = field(default_factory=dict)   # set name -> why
    batch_victims: int = 0   # victim rows in the single batched evaluation
    batch_sets: int = 0      # candidate sets the one call validated
    # the committed capacity/PDB ledger, for chaining into the SAME cycle's
    # gang-defrag plans: two plans in one cycle must not double-book a
    # survivor node's room or a budget's last disruption
    ledger: Optional["_Ledger"] = field(default=None, repr=False,
                                        compare=False)

    @property
    def evictions(self) -> int:
        return sum(len(s.victims) for s in self.accepted)


def _unpinned(pods: list[Pod]) -> list[Pod]:
    """Re-placement view: the evicted pod's replacement won't carry
    spec.nodeName, so the NodeName pin must not constrain the proof."""
    return [dataclasses.replace(
        p, spec=dataclasses.replace(p.spec, node_name="")) for p in pods]


class _Ledger:
    """Host-side capacity + PDB bookkeeping shared by every candidate set
    in one planning pass (and by the gang-defrag trial placement)."""

    def __init__(self, ct, meta, pdbs, pod_dicts):
        from kubernetes_tpu_torch.api.policy import pdb_budgets
        real_n = len(meta.node_names)
        alloc = np.asarray(ct.allocatable[:real_n], np.int64)
        req = np.asarray(ct.requested[:real_n], np.int64)
        self.free = alloc - req
        self.meta = meta
        self.real_n = real_n
        self.drained: set[int] = set()     # rows accepted sets will empty
        self.receivers: set[int] = set()   # rows holding simulated moves
        # PDB budgets: live disruptionsAllowed computed ONCE (pdb_budgets),
        # then CHARGED per approved eviction
        self._pdb_state = pdb_budgets(pdbs, pod_dicts)
        self._charged: dict[int, int] = {}

    def fork(self) -> "_Ledger":
        """Trial copy: a candidate set mutates the fork; only an ACCEPTED
        set's fork is committed back (a blocked set must leave no trace)."""
        t = object.__new__(_Ledger)
        t.free = self.free.copy()
        t.meta = self.meta
        t.real_n = self.real_n
        t.drained = set(self.drained)
        t.receivers = set(self.receivers)
        t._pdb_state = self._pdb_state
        t._charged = dict(self._charged)
        return t

    def commit(self, trial: "_Ledger") -> None:
        self.free = trial.free
        self.drained = trial.drained
        self.receivers = trial.receivers
        self._charged = trial._charged

    def charge_pdb(self, p: Pod) -> Optional[str]:
        """Charge every budget covering ``p``; -> blocking budget name or
        None when the eviction fits all budgets."""
        from kubernetes_tpu_torch.api.policy import _matches
        covering = []
        for idx, (pdb, pns, pname, allowed) in enumerate(self._pdb_state):
            if pns != p.metadata.namespace:
                continue
            if not _matches((pdb.get("spec") or {}).get("selector"),
                            p.metadata.labels):
                continue
            if allowed - self._charged.get(idx, 0) <= 0:
                return pname
            covering.append(idx)
        for idx in covering:
            self._charged[idx] = self._charged.get(idx, 0) + 1
        return None

    def place(self, row_mask: np.ndarray, req: np.ndarray, order: np.ndarray,
              source: int, exclude: set[int]) -> Optional[int]:
        """Park one pod on the best-scoring feasible node with room; -> row
        or None. ``order``: node rows sorted score-desc for this pod."""
        for t in order:
            t = int(t)
            if t >= self.real_n or not row_mask[t]:
                continue
            if t == source or t in exclude or t in self.drained:
                continue
            if np.all(req <= self.free[t]):
                self.free[t] -= req
                self.receivers.add(t)
                return t
        return None


def _resident_encode_and_mask(resident, nodes, bound_pods, batch, planner):
    """The `_encode_and_mask` question answered from the device-resident
    cluster image: totals from the host shadow, feasibility + scores from
    ONE dispatch on the card (no cold full encode). Victims stay resident
    in the image — exactly the cold path's conservative semantics, so no
    `without_pods` subtraction is needed; capacity release remains the
    host ledger's job. None on decline."""
    from types import SimpleNamespace
    ctx = resident.plan_view(nodes, bound_pods, planner=planner)
    if ctx is None:
        return None
    arrays = resident.cluster_arrays(ctx)
    if arrays is None:
        return None
    alloc, req = arrays
    ct_like = SimpleNamespace(allocatable=alloc, requested=req)
    pm = ctx["plan_meta"]
    if not batch:
        resident.hit(ctx)
        return None, ct_like, pm, np.zeros((0, 0), bool), None, None
    ms = resident.mask_scores(ctx, batch, enabled=REPLACEMENT_FILTERS,
                              want_scores=True)
    if ms is None:
        return None
    mask, scores, reqs = ms
    order = np.argsort(-scores, axis=1, kind="stable")
    resident.hit(ctx)
    return None, ct_like, pm, mask, order, reqs


def _encode_and_mask(nodes: list[Node], bound_pods: list[Pod],
                     victims: list[Pod], extra_pods: list[Pod],
                     encoder: Optional[SnapshotEncoder], resident=None,
                     planner: str = "descheduler", device=None):
    """ONE encode + ONE run_filters + ONE combined_score over the union of
    all candidate victims plus any extra (gang) pods. This is the hot path
    the acceptance criterion pins: no per-candidate-set loop touches the
    device.

    With ``resident`` (an encode/overlay.ResidentPlanner) the cold encode
    is skipped entirely in steady state — the same mask/scores come from
    one warm dispatch on the scheduler's resident encoding; any decline
    falls through to the cold path below, bit-identically. The returned
    encoder slot is None on the resident path (nothing downstream uses
    it). The cold path's device work runs on ``device`` (None = the
    card)."""
    batch = _unpinned(victims) + list(extra_pods)
    if resident is not None:
        out = _resident_encode_and_mask(resident, nodes, bound_pods, batch,
                                        planner)
        if out is not None:
            return out
    device = resolve_device(device)
    enc = encoder or SnapshotEncoder()
    ct, meta = enc.encode_cluster(nodes, bound_pods, pending_pods=batch,
                                  pending_slots=False)
    if not batch:
        return enc, ct, meta, np.zeros((0, 0), bool), None, None
    pb = enc.encode_pods(batch, meta)
    ct_d, pb_d = ct.to(device), pb.to(device)
    # ONE call, all K sets
    mask_d = run_filters(ct_d, pb_d, REPLACEMENT_FILTERS)
    mask = mask_d.cpu().numpy()
    scores = combined_score(ct_d, pb_d, mask_d).cpu().numpy()
    # score-desc target order per batch row (ties broken by row index —
    # deterministic, matching the proof's first-fit walk)
    order = np.argsort(-scores, axis=1, kind="stable")
    reqs = np.asarray(pb.requests[:len(batch)], np.int64)
    return enc, ct, meta, mask, order, reqs


def _rebase_ledger(ledger: "_Ledger", meta, ct) -> None:
    """Re-anchor a prior plan's committed ledger onto a fresh encode's
    indexing (plans chained within ONE cycle — node set and order are
    identical across the cycle's encodes). The fresh encode's RESOURCE
    axis may still differ from the ledger's — a resident-path plan chained
    into a cold-path plan sees the resident axis first, the cold union
    axis second. Shared columns keep the ledger's committed free values
    (same baseline within a cycle, so deltas carry over); a column only
    the new axis has saw zero deltas by construction (no prior victim or
    gang pod requested a resource its encode didn't know), so its fresh
    ``alloc - requested`` baseline is exact."""
    old_res = list(ledger.meta.resources)
    new_res = list(meta.resources)
    if old_res != new_res:
        real_n = len(meta.node_names)
        alloc = np.asarray(ct.allocatable[:real_n], np.int64)
        req = np.asarray(ct.requested[:real_n], np.int64)
        free2 = alloc - req
        old_idx = {r: i for i, r in enumerate(old_res)}
        for j, r in enumerate(new_res):
            i = old_idx.get(r)
            if i is not None:
                free2[:, j] = ledger.free[:, i]
        ledger.free = free2
    ledger.meta = meta


def plan_evictions(nodes: list[Node], bound_pods: list[Pod],
                   candidate_sets: list[CandidateSet],
                   pdbs: Optional[list[dict]] = None,
                   all_pod_dicts: Optional[list[dict]] = None,
                   encoder: Optional[SnapshotEncoder] = None,
                   max_evictions: Optional[int] = None,
                   resident=None, device=None) -> EvictionPlan:
    """Validate every candidate set against one shared re-placement
    simulation. A set is accepted only when EVERY victim (not already
    claimed by an earlier accepted set) has a provable new home on a
    surviving node with ledger room, and no eviction overdraws a PDB.

    Sets evaluate in the given order; ``max_evictions`` caps the cycle's
    total eviction budget (sets that would exceed it block, they are not
    partially executed — half a drain helps nobody).

    ``resident`` routes the one encode+mask through the scheduler's
    device-resident encoding when fresh (see ``_encode_and_mask``) —
    identical plans, zero cold encodes in steady state.
    """
    plan = EvictionPlan(batch_sets=len(candidate_sets))
    if not candidate_sets:
        return plan
    seen: dict[str, int] = {}
    union: list[Pod] = []
    for cs in candidate_sets:
        for p in cs.victims:
            if p.key not in seen:
                seen[p.key] = len(union)
                union.append(p)
    plan.batch_victims = len(union)
    if pdbs and all_pod_dicts is None:
        all_pod_dicts = [p.to_dict() for p in bound_pods]
    enc, ct, meta, mask, order, reqs = _encode_and_mask(
        nodes, bound_pods, union, [], encoder, resident=resident,
        device=device)
    ledger = _Ledger(ct, meta, pdbs, all_pod_dicts)
    plan.ledger = ledger
    claimed: set[str] = set()
    budget = plan.evictions
    for cs in candidate_sets:
        verdict = _try_set(cs, ledger, meta, mask, order, reqs, seen,
                           claimed)
        if isinstance(verdict, str):
            plan.blocked[cs.name] = verdict
            continue
        trial, accepted = verdict
        if max_evictions is not None and \
                budget + len(accepted.victims) > max_evictions:
            plan.blocked[cs.name] = (
                f"eviction budget exhausted ({budget}/{max_evictions})")
            continue
        if not accepted.victims:
            plan.blocked[cs.name] = "no victims left to evict"
            continue
        ledger.commit(trial)
        claimed |= {p.key for p in accepted.victims}
        budget += len(accepted.victims)
        plan.accepted.append(accepted)
    return plan


def _try_set(cs: CandidateSet, ledger: _Ledger, meta, mask, order, reqs,
             seen: dict[str, int], claimed: set[str]):
    """-> (trial ledger, AcceptedSet) or a blocking-reason string."""
    excl_rows = {meta.node_index[n] for n in cs.exclude_targets
                 if n in meta.node_index}
    for row in excl_rows:
        if row in ledger.receivers:
            return "drain target holds simulated re-placements"
    trial = ledger.fork()
    trial.drained |= excl_rows
    out = AcceptedSet(name=cs.name, strategy=cs.strategy, victims=[],
                      reason=cs.reason)
    for p in cs.victims:
        if p.key in claimed:
            continue  # already moving under an earlier accepted set
        pname = trial.charge_pdb(p)
        if pname is not None:
            return f"pod {p.key} blocked by PDB {pname!r}"
        v = seen[p.key]
        source = meta.node_index.get(p.spec.node_name, -1)
        target = trial.place(mask[v], reqs[v], order[v], source, excl_rows)
        if target is None:
            return f"pod {p.key} fits nowhere else"
        out.victims.append(p)
        out.moves.append((p.key, meta.node_names[target]))
    return trial, out


def plan_evictions_naive(nodes: list[Node], bound_pods: list[Pod],
                         candidate_sets: list[CandidateSet],
                         pdbs: Optional[list[dict]] = None,
                         all_pod_dicts: Optional[list[dict]] = None,
                         max_evictions: Optional[int] = None,
                         device=None) -> EvictionPlan:
    """Reference oracle: the per-candidate loop the batched path replaces —
    one full encode + ``run_filters`` PER candidate set. Exists only for
    the parity test and as documentation of what one batched call buys."""
    plan = EvictionPlan(batch_sets=len(candidate_sets))
    if not candidate_sets:
        return plan
    if pdbs and all_pod_dicts is None:
        all_pod_dicts = [p.to_dict() for p in bound_pods]
    shared: Optional[_Ledger] = None
    claimed: set[str] = set()
    budget = 0
    for cs in candidate_sets:
        enc, ct, meta, mask, order, reqs = _encode_and_mask(
            nodes, bound_pods, cs.victims, [], None, device=device)
        plan.batch_victims += len(cs.victims)
        if shared is None:
            shared = _Ledger(ct, meta, pdbs, all_pod_dicts)
        else:
            # re-anchor the fresh encode's row/resource indexing onto the
            # shared ledger state (node sets are identical across encodes)
            _rebase_ledger(shared, meta, ct)
        seen = {p.key: i for i, p in enumerate(cs.victims)}
        verdict = _try_set(cs, shared, meta, mask, order, reqs, seen,
                           claimed)
        if isinstance(verdict, str):
            plan.blocked[cs.name] = verdict
            continue
        trial, accepted = verdict
        if max_evictions is not None and \
                budget + len(accepted.victims) > max_evictions:
            plan.blocked[cs.name] = (
                f"eviction budget exhausted ({budget}/{max_evictions})")
            continue
        if not accepted.victims:
            plan.blocked[cs.name] = "no victims left to evict"
            continue
        shared.commit(trial)
        claimed |= {p.key for p in accepted.victims}
        budget += len(accepted.victims)
        plan.accepted.append(accepted)
    return plan


# ---- gang defragmentation ---------------------------------------------------

@dataclass
class GangDefragPlan:
    """The cheapest consolidation that makes a pending gang fit."""

    gang: str
    accepted: Optional[AcceptedSet] = None
    # gang pod key -> node row the trial placement parked it on
    gang_moves: list[tuple[str, str]] = field(default_factory=list)
    fits_without_evictions: bool = False
    blocked: dict[str, str] = field(default_factory=dict)
    batch_victims: int = 0
    batch_sets: int = 0
    # committed ledger after this gang's moves, for chaining to the next
    # gang in the same cycle (see EvictionPlan.ledger)
    ledger: Optional["_Ledger"] = field(default=None, repr=False,
                                        compare=False)

    @property
    def evictions(self) -> int:
        return len(self.accepted.victims) if self.accepted else 0


def plan_gang_defrag(nodes: list[Node], bound_pods: list[Pod],
                     gang_pods: list[Pod], gang: str,
                     candidate_sets: list[CandidateSet],
                     pdbs: Optional[list[dict]] = None,
                     all_pod_dicts: Optional[list[dict]] = None,
                     encoder: Optional[SnapshotEncoder] = None,
                     max_evictions: Optional[int] = None,
                     ledger: Optional[_Ledger] = None,
                     claimed: Optional[set] = None,
                     resident=None, device=None) -> GangDefragPlan:
    """Pick the FEWEST-EVICTIONS candidate set under which (a) every victim
    provably re-places on a surviving node and (b) every gang member then
    fits (drained nodes included — consolidation frees them FOR the gang).

    Victims of every candidate set AND the gang pods ride one PodBatch:
    still exactly ONE ``run_filters`` call for the whole search. Candidate
    sets are tried in ascending eviction count, so the first success is the
    cheapest; an empty set (0 evictions) is probed first — a gang that
    already fits needs patience, not evictions.

    ``ledger``: a prior plan's committed ledger from the SAME cycle (the
    strategy plan's, or an earlier gang's). The winning trial — victims'
    re-placements AND gang placements — commits back into it, so plans in
    one cycle cannot double-book capacity or PDB budgets.

    ``claimed``: victim keys a prior plan in this cycle already evicts.
    They are skipped here — not evicted twice, not PDB-charged twice —
    and their capacity is NOT credited back (conservative: the shared
    ledger never credited their departure either; a fit this forgoes is
    found next cycle, against the settled cluster).
    """
    plan = GangDefragPlan(gang=gang)
    if not gang_pods:
        return plan
    ordered = sorted(candidate_sets, key=lambda cs: len(cs.victims))
    if not ordered or ordered[0].victims:
        ordered = [CandidateSet(name="no-evictions", strategy="GangDefrag",
                                victims=[])] + ordered
    plan.batch_sets = len(ordered)
    seen: dict[str, int] = {}
    union: list[Pod] = []
    for cs in ordered:
        for p in cs.victims:
            if p.key not in seen:
                seen[p.key] = len(union)
                union.append(p)
    plan.batch_victims = len(union)
    if pdbs and all_pod_dicts is None:
        all_pod_dicts = [p.to_dict() for p in bound_pods]
    enc, ct, meta, mask, order, reqs = _encode_and_mask(
        nodes, bound_pods, union, gang_pods, encoder, resident=resident,
        planner="gangDefrag", device=device)
    g0 = len(union)
    if ledger is not None:
        # re-anchor the fresh encode's row/resource indexing onto the prior
        # plan's committed state (node set/order are identical in a cycle)
        base = ledger
        _rebase_ledger(base, meta, ct)
    else:
        base = _Ledger(ct, meta, pdbs, all_pod_dicts)
    plan.ledger = base
    already = claimed or set()
    prior_drained = set(base.drained)  # prior plans' reclaim targets
    for cs in ordered:
        fresh_victims = [p for p in cs.victims if p.key not in already]
        if max_evictions is not None and len(fresh_victims) > max_evictions:
            plan.blocked[cs.name] = (
                f"{len(fresh_victims)} evictions over budget "
                f"{max_evictions}")
            continue
        verdict = _try_set(cs, base, meta, mask, order, reqs, seen,
                           already)
        if isinstance(verdict, str):
            plan.blocked[cs.name] = verdict
            continue
        trial, accepted = verdict
        # victims are out: credit their vacated rows back to the trial —
        # the "reverse overlay" that lets gang members claim drained nodes
        for p in accepted.victims:
            src = meta.node_index.get(p.spec.node_name)
            if src is not None:
                trial.free[src] += reqs[seen[p.key]]
        # THIS set's drained rows are exactly what the gang wants; rows a
        # prior plan drained (reclaim targets) stay off-limits
        trial.drained -= ({meta.node_index[n] for n in cs.exclude_targets
                           if n in meta.node_index} - prior_drained)
        gang_moves: list[tuple[str, str]] = []
        ok = True
        for gi, gp in enumerate(gang_pods):
            v = g0 + gi
            target = trial.place(mask[v], reqs[v], order[v], -1, set())
            if target is None:
                ok = False
                plan.blocked[cs.name] = f"gang pod {gp.key} still unplaceable"
                break
            gang_moves.append((gp.key, meta.node_names[target]))
        if not ok:
            continue
        if not accepted.victims:
            plan.fits_without_evictions = True
        else:
            plan.accepted = accepted
        plan.gang_moves = gang_moves
        # commit the winning trial — victims' re-placements AND the gang's
        # seats — so the next gang in this cycle plans against it
        base.commit(trial)
        return plan
    return plan
