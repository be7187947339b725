"""Preemption — the PostFilter plugin (victim search + nomination).

The PyTorch port of ``kubernetes_tpu/sched/preemption.py``. Reference:
``pkg/scheduler/framework/plugins/defaultpreemption/
default_preemption.go`` (``SelectVictimsOnNode``) and
``framework/preemption/preemption.go`` (``Evaluator``, ``DryRunPreemption``).

Two paths:

``find_candidate``          the exact serial simulation (per node: evict
                            lower-priority pods until feasible, reprieve,
                            pickOneNode) — the parity reference.
``find_candidate_tensor``   the device path: ops/preemption.py runs the
                            whole N×V victim dry-run at once (prefix-sum
                            capacity release), the host exactly verifies +
                            reprieves only the ranked winners. Falls back
                            to the exact scan whenever the device narrowing
                            can't be trusted (relational/port/volume-driven
                            failures).

Where the port differs from the reference: the device paths here catch
nothing. The reference swallows any exception of the device dry-run, the
static masks or the wave and quietly degrades to the exact host scan; in
the port such an error propagates to the caller, and only the scheduler
(``Scheduler._default_preempt_wave`` and ``_default_preempt``) decides to
degrade, counting it as a loop error and feeding the breaker. The
semantic fallbacks to ``find_candidate`` (a zero-eviction fit, ranked
candidates that fail exact verification) are part of the algorithm and
stay. A DRA catalog (sched/dra.py) reaches the oracle, the static masks and
the victims' requests as in the reference. A device mesh is taken and run
single-device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np

from kubernetes_tpu_torch.api.policy import _matches, compute_pdb_status
from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.device import resolve_device
from kubernetes_tpu_torch.sched.oracle import OracleScheduler


@dataclass
class PreemptionResult:
    node_name: str
    victims: list[Pod]  # sorted by priority asc (evict lowest first)
    num_pdb_violations: int = 0


def _pdb_budgets(pdbs: list[dict], bound_pods: list[Pod]) -> list[tuple]:
    """-> [(pdb_ns, selector, disruptionsAllowed)] computed live."""
    out = []
    pod_dicts = [p.to_dict() for p in bound_pods]
    for pdb in pdbs or []:
        ns = (pdb.get("metadata") or {}).get("namespace", "")
        sel = (pdb.get("spec") or {}).get("selector")
        allowed = compute_pdb_status(
            pdb, [d for d in pod_dicts
                  if (d.get("metadata") or {}).get("namespace", "") == ns]
        )["disruptionsAllowed"]
        out.append((ns, sel, allowed))
    return out


def _violates(pod: Pod, budgets_used: list) -> bool:
    """True if evicting ``pod`` would exceed some covering PDB's remaining
    budget; charges the budget either way (filterPodsWithPDBViolation)."""
    violating = False
    for entry in budgets_used:
        ns, sel, allowed, used = entry
        if pod.metadata.namespace != ns:
            continue
        if not _matches(sel, pod.metadata.labels):
            continue
        if used >= allowed:
            violating = True
        entry[3] += 1
    return violating


def _pick_key(victims: list[Pod], violations: int, ni: int) -> tuple:
    """pickOneNodeForPreemption's order: fewest PDB violations, then the
    lowest highest-victim priority, then fewest victims, then node order."""
    return (violations, max((v.spec.priority for v in victims), default=-1),
            len(victims), ni)


def find_candidate(nodes: list[Node], bound_pods: list[Pod], pod: Pod,
                   pdbs: Optional[list[dict]] = None, dra=None,
                   orc: Optional[OracleScheduler] = None,
                   budgets: Optional[list] = None,
                   ) -> Optional[PreemptionResult]:
    """Find the best node + minimal victim set enabling ``pod`` to schedule.

    Per node: remove lower-priority pods — PDB-unprotected ones first — until
    feasible, then reprieve (re-add highest-first while staying feasible),
    mirroring SelectVictimsOnNode's split into violating/non-violating
    victims. A budget MAY be violated as a last resort, exactly as upstream.
    Candidate selection mirrors pickOneNodeForPreemption (``_pick_key``).
    ``orc``/``budgets``: a caller-maintained simulation + live budget
    accounting (the wave path threads one oracle through many preemptors
    instead of rebuilding O(nodes x bound) state per call).
    """
    if budgets is None:
        budgets = _pdb_budgets(pdbs or [], bound_pods)
    # one shared simulation, mutated and restored per node trial — building
    # a fresh oracle per candidate node is O(nodes x bound) each
    if orc is None:
        orc = OracleScheduler(nodes, bound_pods, dra=dra)
    best: Optional[tuple] = None
    for i, node in enumerate(nodes):
        found = _victims_on_node(nodes, bound_pods, pod, node, budgets,
                                 dra=dra, orc=orc)
        if found is None:
            continue
        victims, violations = found
        key = _pick_key(victims, violations, i)
        if best is None or key < best[0]:
            best = (key, node.metadata.name, victims, violations)
    if best is None:
        return None
    return PreemptionResult(
        node_name=best[1],
        victims=sorted(best[2], key=lambda p: p.spec.priority),
        num_pdb_violations=best[3])


def _best_verified(nodes, live, pod, cand_idxs, budgets, dra, orc
                   ) -> Optional[PreemptionResult]:
    """Exactly verify the device's ranked candidates and re-rank them by
    the exact post-reprieve pickOneNode key (the device key uses
    pre-reprieve estimates, which can rank another node first than
    pickOneNodeForPreemption would). None when every candidate fails."""
    best: Optional[tuple] = None
    for ni in cand_idxs:
        found = _victims_on_node(nodes, live, pod, nodes[ni], budgets,
                                 dra=dra, orc=orc)
        if found is None:
            continue
        victims, violations = found
        key = _pick_key(victims, violations, ni)
        if best is None or key < best[0]:
            best = (key, ni, victims, violations)
    if best is None:
        return None
    _key, ni, victims, violations = best
    return PreemptionResult(
        node_name=nodes[ni].metadata.name,
        victims=sorted(victims, key=lambda p: p.spec.priority),
        num_pdb_violations=violations)


def find_candidate_tensor(nodes: list[Node], bound_pods: list[Pod], pod: Pod,
                          pdbs: Optional[list[dict]] = None, dra=None,
                          verify_limit: int = 8, device=None
                          ) -> Optional[PreemptionResult]:
    """Device-narrowed preemption: rank (node, victim-count) candidates with
    one [N,V+1] dry-run, then exactly verify + reprieve the winners
    host-side. Sound by construction (every returned result passed the full
    serial check); falls back to the exact scan when the failure could be
    relational/port/volume-driven — i.e. when some node looks feasible with
    ZERO evictions resource-wise (so something the dry-run doesn't model
    blocked the main cycle). An error of the device dry-run propagates."""
    from kubernetes_tpu_torch.ops.preemption import dry_run_candidates
    budgets = _pdb_budgets(pdbs or [], bound_pods)
    cands, zero_evict = dry_run_candidates(nodes, bound_pods, pod, budgets,
                                           dra=dra, device=device)
    if zero_evict:
        # some node fits without evicting anyone: the main-cycle failure was
        # relational/ports/volumes, which the dry-run doesn't model
        return find_candidate(nodes, bound_pods, pod, pdbs=pdbs, dra=dra)
    if not cands:
        return None  # no node becomes resource-feasible by evicting
    orc = OracleScheduler(nodes, bound_pods, dra=dra)
    res = _best_verified(nodes, bound_pods, pod,
                         [ni for _key, ni, _k in cands[:verify_limit]],
                         budgets, dra, orc)
    if res is not None:
        return res
    # ranked candidates failed exact verification (relational terms the
    # dry-run doesn't model): the serial scan is the source of truth
    return find_candidate(nodes, bound_pods, pod, pdbs=pdbs, dra=dra)


def _charge_budgets(budgets: list, victim: Pod) -> None:
    """Evicting ``victim`` consumes one disruption from every covering PDB —
    live accounting threaded across a wave (may go negative: a budget
    violated as a last resort stays violated for later preemptors)."""
    for entry in budgets:
        ns, sel, _allowed = entry[0], entry[1], entry[2]
        if victim.metadata.namespace == ns and _matches(
                sel, victim.metadata.labels):
            entry[2] -= 1


# The victim-INDEPENDENT filter set: evicting pods can never change these
# verdicts (ports/volumes/relational CAN change, and are settled by exact
# host verification instead). One definition, shared by the wave's own
# encoder path and the scheduler's resident-encoding path.
STATIC_FILTERS = frozenset({"NodeUnschedulable", "NodeName", "NodeAffinity",
                            "TaintToleration"})


def _static_filters_program(ct, pb):
    """The static filter AND on the device (the reference jits it)."""
    from kubernetes_tpu_torch.ops.filters import run_filters
    return run_filters(ct, pb, enabled=STATIC_FILTERS)


def tensor_static_masks(nodes, preemptors, ct=None, meta=None,
                        bound_pods=None, encode_pods=None,
                        min_p: int = 1, mesh=None, pre_staged: bool = False,
                        node_rows=None, device=None) -> np.ndarray:
    """[Q,N] victim-independent feasibility via the encoded filter masks —
    one device pass instead of Q x N host-side oracle probes, which
    dominated wave setup at fleet scale. Pass an already-encoded cluster
    (``ct``/``meta`` + an ``encode_pods(pods, meta, min_p=...)`` callable —
    e.g. the scheduler cache's) to skip the fresh encode. ``min_p`` pins
    the pod-batch bucket (WAVE_BUCKET) so varying wave sizes share one
    shape.

    ``pre_staged``: ``ct`` is already on ``device`` (the scheduler's drain
    context) — skip the per-wave copy of the whole cluster encoding.
    ``node_rows``: optional row index per entry of ``nodes`` into ``ct``'s
    node axis — the resident context's row order diverges from the node
    list after node churn patches, so the columns are gathered by row
    instead of sliced positionally. ``mesh``: the port runs on one
    device; a mesh is taken and the masks computed single-device."""
    device = resolve_device(device)
    if ct is None:
        from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
        enc = SnapshotEncoder()
        ct, meta = enc.encode_cluster(nodes, bound_pods or [])
        encode_pods = enc.encode_pods
    pb = encode_pods(preemptors, meta, min_p=min_p)
    ct_dev = ct if pre_staged else ct.to(device)
    mask = _static_filters_program(ct_dev, pb.to(device)).cpu().numpy()
    if node_rows is not None:
        return mask[:len(preemptors)][:, np.asarray(node_rows)]
    return mask[:len(preemptors), :len(nodes)]


# waves pad to this bucket so a storm's varying wave sizes share one set of
# shapes; larger waves bucket upward
WAVE_BUCKET = 256


def preempt_wave(nodes: list[Node], bound_pods: list[Pod],
                 preemptors: list[Pod], pdbs: Optional[list[dict]] = None,
                 dra=None, static_masks=None, min_q: int = 1,
                 mesh=None, resident_arrays=None,
                 req_lookup=None, device=None
                 ) -> list[Optional[PreemptionResult]]:
    """Resolve a WAVE of preemptors with sequential-commit semantics in one
    device scan + one shared host simulation.

    Reference behavior being batched: the failure path runs
    ``DryRunPreemption`` per pod, evicts, and the next failed pod sees the
    mutated cluster. Here the [Q,N,V+1] scan (ops/preemption.py
    ``_wave_scan``) commits each winner's victims and reservation into the
    device-side state, and the host EXACTLY verifies each proposal in wave
    order against ONE OracleScheduler that absorbs the committed evictions
    and nominee reservations — so results are identical in soundness to Q
    serial ``find_candidate_tensor`` calls, minus Q re-encodes of the
    cluster and Q oracle rebuilds.

    ``resident_arrays``/``req_lookup``: the scheduler's resident-context
    fast path (ops/preemption.py dry_run_wave). An error of the static
    masks or of the device wave propagates.

    Returns one ``PreemptionResult | None`` per preemptor, in order."""
    from kubernetes_tpu_torch.ops.preemption import dry_run_wave
    if not preemptors:
        return []
    budgets = _pdb_budgets(pdbs or [], bound_pods)
    if static_masks is None and len(preemptors) * len(nodes) > (1 << 14):
        static_masks = tensor_static_masks(nodes, preemptors,
                                           bound_pods=bound_pods,
                                           min_p=min_q, device=device)
    proposals = dry_run_wave(nodes, bound_pods, preemptors, budgets,
                             dra=dra, static_masks=static_masks,
                             min_q=min_q, resident_arrays=resident_arrays,
                             req_lookup=req_lookup, device=device)

    orc = OracleScheduler(nodes, bound_pods, dra=dra)
    live = list(bound_pods)
    budgets_live = [[ns, sel, allowed] for (ns, sel, allowed) in budgets]
    results: list[Optional[PreemptionResult]] = []
    # Drift accounting: a host REPRIEVE evicts fewer victims than the device
    # committed, leaving the device state only OPTIMISTIC about capacity —
    # a device "no" stays trustworthy. Anything that makes the device state
    # PESSIMISTIC — a phantom commit the host rejected outright, a fallback
    # commit the device never saw, a different node chosen by the exact
    # re-rank, or the host evicting pods outside the device's set — flips
    # ``drifted`` and later device "no"s are re-checked exactly.
    drifted = False
    for pod, prop in zip(preemptors, proposals):
        res: Optional[PreemptionResult] = None
        via_fallback = False
        dev_victims = None
        snap = [tuple(b) for b in budgets_live]
        if prop is None and not drifted:
            # no resource-feasible eviction set exists device-side; since
            # evictions only ever free resources and the device state is
            # not pessimistic, the exact path cannot succeed either
            results.append(None)
            continue
        if prop == "zero_evict" or prop is None:
            res = find_candidate(nodes, live, pod, dra=dra, orc=orc,
                                 budgets=snap)
            via_fallback = True
        else:
            cand_idxs, dev_vs = prop
            dev_victims = {v.metadata.uid for v in dev_vs}
            res = _best_verified(nodes, live, pod, cand_idxs, snap, dra, orc)
            if res is None:
                # every ranked candidate failed exact verification
                # (relational terms, or drift from earlier commits)
                res = find_candidate(nodes, live, pod, dra=dra, orc=orc,
                                     budgets=snap)
                via_fallback = True
        # drift bookkeeping (device committed on its TOP candidate)
        if dev_victims is not None:
            if res is None:
                drifted = True  # phantom device commit, host found nothing
            else:
                host_victims = {v.metadata.uid for v in res.victims}
                dev_node = nodes[prop[0][0]].metadata.name
                if (via_fallback or res.node_name != dev_node
                        or not host_victims <= dev_victims):
                    drifted = True
        elif res is not None:
            drifted = True  # fallback commit the device never saw
        if res is not None:
            # commit: evictions + the nominee's reservation become the
            # state every later preemptor is verified against
            evicted = {v.metadata.uid for v in res.victims}
            for v in res.victims:
                orc.remove_bound(v)
                _charge_budgets(budgets_live, v)
            live = [p for p in live if p.metadata.uid not in evicted]
            nominee = dataclasses.replace(
                pod, spec=dataclasses.replace(pod.spec,
                                              node_name=res.node_name))
            orc.restore_bound(nominee)
            live.append(nominee)
        results.append(res)
    return results


def _victims_on_node(nodes, bound_pods, pod, node, budgets, dra=None,
                     orc: Optional[OracleScheduler] = None
                     ) -> Optional[tuple[list[Pod], int]]:
    on_node = [p for p in bound_pods if p.spec.node_name == node.metadata.name]
    lower = [p for p in on_node if p.spec.priority < pod.spec.priority]
    if not lower:
        return None
    # classify against fresh per-node budget accounting, then try
    # non-violating victims (priority asc) before violating ones
    used = [[ns, sel, allowed, 0] for (ns, sel, allowed) in budgets]
    flagged = [(p, _violates(p, used))
               for p in sorted(lower, key=lambda p: p.spec.priority)]
    ordered = ([p for p, v in flagged if not v]
               + [p for p, v in flagged if v])
    violating_uids = {p.metadata.uid for p, v in flagged if v}
    ni = next(i for i, n in enumerate(nodes)
              if n.metadata.name == node.metadata.name)

    # One oracle, mutated incrementally and RESTORED before returning (so a
    # caller-shared instance survives many node trials): remove/restore are
    # O(node) and the single-node re-filter is what DryRunPreemption's
    # per-node simulation does.
    if orc is None:
        orc = OracleScheduler(nodes, bound_pods, dra=dra)
    removed_now: list[Pod] = []
    try:
        victims: list[Pod] = []
        ok = False
        for v in ordered:
            orc.remove_bound(v)
            removed_now.append(v)
            victims.append(v)
            if orc.feasible_one(pod, ni):
                ok = True
                break
        if not ok:
            return None
        # Reprieve: re-add victims that aren't actually needed —
        # PDB-violating candidates first (so budgets are preserved whenever
        # possible), then by priority desc, mirroring SelectVictimsOnNode's
        # two reprieve passes.
        for v in sorted(victims,
                        key=lambda p: (p.metadata.uid not in violating_uids,
                                       -p.spec.priority)):
            orc.restore_bound(v)
            removed_now.remove(v)
            if orc.feasible_one(pod, ni):
                victims = [p for p in victims
                           if p.metadata.uid != v.metadata.uid]
            else:
                orc.remove_bound(v)  # still needed
                removed_now.append(v)
        violations = sum(1 for v in victims if v.metadata.uid in violating_uids)
        return victims, violations
    finally:
        for v in removed_now:
            orc.restore_bound(v)
