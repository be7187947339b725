"""Tensor scale-up/scale-down simulation.

Reference: ``cluster-autoscaler/simulator/`` (SchedulerBasedPredicateChecker
+ BinpackingNodeEstimator for scale-up; ``simulator.FindPlaceFor`` for
scale-down's "does every resident pod fit elsewhere?" proof). The reference
asks the scheduler framework one (pod, candidate-node) pair at a time; here
every candidate group's template node overlays the encoded cluster and ONE
``run_filters`` call answers all (pending pod × candidate) questions — the
K-way expansion search becomes a single batched feasibility evaluation.

Binpacking stays host-side (numpy on the already-encoded request vectors):
it is sequential by nature and tiny next to the filter evaluation.

The PyTorch port of ``kubernetes_tpu/autoscaler/simulator.py``. The cold
paths encode on the host and run ``run_filters`` on ``device`` (None = the
card); the resident paths run on the device of the scheduler's context.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.autoscaler.nodegroup import NodeGroup
from kubernetes_tpu_torch.device import resolve_device
from kubernetes_tpu_torch.encode.scaling import UNLIMITED
from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
from kubernetes_tpu_torch.ops.filters import run_filters


@dataclass
class ScaleUpOption:
    """What expanding one group would buy (expander input)."""

    group: NodeGroup
    pod_indices: list[int]          # pending-pod indices the expansion places
    nodes_needed: int               # new nodes the binpack opened
    waste: float                    # unused fraction of opened capacity [0,1]

    @property
    def pods_placed(self) -> int:
        return len(self.pod_indices)


@dataclass
class ScaleDownPlan:
    """Nodes provably reclaimable plus the re-placement that proves it."""

    removable: list[str] = field(default_factory=list)
    # node -> [(pod_key, target_node)] re-placements backing the proof
    placements: dict[str, list[tuple[str, str]]] = field(default_factory=dict)
    blocked: dict[str, str] = field(default_factory=dict)  # node -> reason


def _free_matrix(ct, real_n: int) -> np.ndarray:
    """allocatable - requested as int64 [real_n, R] (int64 so binpack sums
    never wrap the UNLIMITED sentinel)."""
    alloc = np.asarray(ct.allocatable[:real_n], np.int64)
    req = np.asarray(ct.requested[:real_n], np.int64)
    return alloc - req


def _binpack(requests: np.ndarray, fits: np.ndarray, capacity: np.ndarray,
             max_nodes: int, waste_idx: list[int],
             ) -> tuple[list[int], int, float]:
    """First-fit pack pods (in given order) onto up to ``max_nodes`` copies
    of a node with ``capacity``. ``fits[i]`` gates pod i (the tensor filter
    verdict for the template). -> (placed indices, nodes opened, waste).

    Waste is the mean unused FRACTION over ``waste_idx`` resources
    (cpu/memory), per the reference's least-waste expander — normalizing
    per resource keeps milli-cores from being summed against Mi.
    """
    opened: list[np.ndarray] = []
    placed: list[int] = []
    cap = capacity.astype(np.int64)
    for i in np.flatnonzero(fits):
        req = requests[i]
        for free in opened:
            if np.all(req <= free):
                free -= req
                placed.append(int(i))
                break
        else:
            if len(opened) < max_nodes and np.all(req <= cap):
                free = cap.copy()
                free -= req
                opened.append(free)
                placed.append(int(i))
    if not opened:
        return placed, 0, 1.0
    fracs = []
    for r in waste_idx:
        total = float(cap[r]) * len(opened)
        if cap[r] <= 0 or cap[r] >= UNLIMITED or total <= 0:
            continue
        fracs.append(sum(float(free[r]) for free in opened) / total)
    waste = (sum(fracs) / len(fracs)) if fracs else 0.0
    return placed, len(opened), waste


def _waste_idx(resources: list) -> list[int]:
    return [resources.index(r) for r in ("cpu", "memory") if r in resources]


def _pack_options(groups: list[NodeGroup], headroom: Optional[dict],
                  requests: np.ndarray, mask_lk: np.ndarray,
                  caps: np.ndarray, waste_idx: list[int],
                  ) -> list[ScaleUpOption]:
    """Shared host core of scale-up: per-group binpack over a combined
    feasibility matrix ``mask_lk`` [P, N_live + K] — live-node columns
    first, one template column per group after. Identical whether the
    mask came from the cold overlay encode or the resident dispatch, so
    the two paths can only disagree if the masks do (the parity tests'
    contract)."""
    real_n = mask_lk.shape[1] - len(groups)
    # a pod with a feasible existing node that also has resource room isn't
    # the autoscaler's problem (mask already includes the fit filter)
    fits_existing = mask_lk[:, :real_n].any(axis=1)
    options = []
    for k, g in enumerate(groups):
        room = (headroom or {}).get(g.name, g.max_size)
        if room <= 0:
            continue
        fits = mask_lk[:, real_n + k] & ~fits_existing
        placed, opened, waste = _binpack(requests, fits, caps[k], room,
                                         waste_idx)
        if placed:
            options.append(ScaleUpOption(group=g, pod_indices=placed,
                                         nodes_needed=opened, waste=waste))
    return options


def _scale_up_resident(resident, nodes, bound_pods, pending, groups,
                       templates, headroom) -> Optional[list[ScaleUpOption]]:
    """Scale-up against the device-resident cluster image: template planes
    overlay the resident encoding and ONE dispatch on its device answers all
    (pending pod x candidate) questions. None on decline (the caller then
    runs the cold encode below, producing an identical option list)."""
    ctx = resident.plan_view(nodes, bound_pods, planner="autoscaler")
    if ctx is None:
        return None
    out = resident.overlay_mask(ctx, templates, pending)
    if out is None:
        return None
    mask_lk, caps, reqs = out
    opts = _pack_options(groups, headroom, reqs, mask_lk, caps,
                         _waste_idx(ctx["plan_meta"].resources))
    resident.hit(ctx)
    return opts


def simulate_scale_up(nodes: list[Node], bound_pods: list[Pod],
                      pending: list[Pod], groups: list[NodeGroup],
                      headroom: Optional[dict[str, int]] = None,
                      encoder: Optional[SnapshotEncoder] = None,
                      resident=None, device=None,
                      ) -> list[ScaleUpOption]:
    """Evaluate every candidate group's expansion against the pending set.

    One template node per group overlays the encoded cluster
    (``SnapshotEncoder.with_hypothetical``); ONE batched ``run_filters``
    call covers all K hypotheses; the per-group binpack then walks the
    pods whose mask row passed. ``headroom[group]`` caps how many nodes
    that group may still add (max_size - target_size); absent = max_size.

    Pods that already fit on an EXISTING node are excluded — scale-up must
    not provision for pods the scheduler merely hasn't reached yet
    (upstream filters these out via its scheduling simulation too).

    ``resident`` (an encode/overlay.ResidentPlanner) short-circuits the
    cold encode entirely in steady state: the simulation runs as one warm
    dispatch on the scheduler's device-resident encoding and the
    whole body below is skipped. Any staleness or bucket overflow declines
    back here — bit-identical either way. The cold body runs its one
    ``run_filters`` on ``device`` (None = the card).
    """
    if not pending or not groups:
        return []
    templates = [g.template_node(f"{g.name}-hypothetical") for g in groups]
    if resident is not None:
        opts = _scale_up_resident(resident, nodes, bound_pods, pending,
                                  groups, templates, headroom)
        if opts is not None:
            return opts
    device = resolve_device(device)
    enc = encoder or SnapshotEncoder()
    ct, meta = enc.encode_cluster(nodes, bound_pods, pending_pods=pending,
                                  pending_slots=False)
    ct_over, rows = enc.with_hypothetical(ct, meta, templates)
    pb = enc.encode_pods(pending, meta)
    mask = run_filters(ct_over.to(device),              # ONE call, all K
                       pb.to(device)).cpu().numpy()
    P = len(pending)
    requests = np.asarray(pb.requests[:P], np.int64)
    real_n = len(meta.node_names)
    mask_lk = np.concatenate([mask[:P, :real_n], mask[:P][:, rows]], axis=1)
    caps = np.asarray(ct_over.allocatable, np.int64)[rows]
    return _pack_options(groups, headroom, requests, mask_lk, caps,
                         _waste_idx(meta.resources))


def drain_exempt(annotations: dict, owner_references: list) -> bool:
    """Pods the drain skips (kubectl drain --ignore-daemonsets + mirror
    pods): they need no re-placement proof — the replacement daemon pod
    lives and dies with its node. ONE predicate shared by the simulation
    and the actual eviction loop so the proof and the drain can never
    disagree about which pods must move."""
    if "kubernetes.io/config.mirror" in (annotations or {}):
        return True
    return any(r.get("kind") == "DaemonSet"
               for r in owner_references or [])


def _daemon_or_mirror_pod(p: Pod) -> bool:
    return drain_exempt(p.metadata.annotations, p.metadata.owner_references)


def _utilization(free: np.ndarray, alloc: np.ndarray,
                 res_idx: list[int]) -> float:
    """Max requested/allocatable over the given resource columns (upstream
    scale-down utilization: max of cpu and memory)."""
    best = 0.0
    for r in res_idx:
        a = float(alloc[r])
        if a <= 0 or a >= UNLIMITED:
            continue
        best = max(best, (a - float(free[r])) / a)
    return best


def _scale_down_gate(plan: ScaleDownPlan, cand: list[str],
                     node_index: dict, free: np.ndarray, alloc: np.ndarray,
                     res_idx: list[int], threshold: float) -> list[str]:
    """Utilization gate — a busy node needs no re-placement proof. Blocks
    go on ``plan``; survivors come back in candidate order."""
    eligible = []
    for c in cand:
        ni = node_index.get(c)
        if ni is None:
            plan.blocked[c] = "unknown node"
            continue
        util = _utilization(free[ni], alloc[ni], res_idx)
        if util > threshold:
            plan.blocked[c] = f"utilization {util:.2f} above threshold"
            continue
        eligible.append(c)
    return eligible


def _scale_down_walk(plan: ScaleDownPlan, eligible: list[str],
                     residents: dict, node_index: dict, node_names: list,
                     free: np.ndarray, mask: np.ndarray, reqs: np.ndarray,
                     offsets: dict, pdbs, pod_dicts) -> None:
    """Shared host core of the scale-down proof: PDB budget charging plus
    the shared capacity ledger walk. Identical across the cold and
    resident paths — only the mask/reqs/free inputs differ in provenance,
    never in value (the parity tests' contract)."""
    from kubernetes_tpu_torch.api.policy import _matches, compute_pdb_status

    real_n = len(node_names)
    # PDB budgets: compute each budget's live disruptionsAllowed ONCE, then
    # CHARGE it per approved eviction — N guarded pods against a budget with
    # one disruption left must not each see "1 remaining" and all pass
    # (the Eviction API would 429 mid-drain after needless evictions).
    pdb_state: list[tuple[dict, str, str, int]] = []
    for pdb in (pdbs or []):
        pmd = pdb.get("metadata") or {}
        pns = pmd.get("namespace", "")
        ns_pods = [p for p in (pod_dicts or [])
                   if (p.get("metadata") or {}).get("namespace", "") == pns]
        allowed = compute_pdb_status(pdb, ns_pods)["disruptionsAllowed"]
        pdb_state.append((pdb, pns, pmd.get("name", ""), allowed))
    charged: dict[int, int] = {}

    # shared ledger: candidates already accepted release nothing (their
    # residents MOVE), nodes already accepted cannot receive re-placements
    ledger = free.copy()
    dead = set()
    receivers: set[int] = set()
    for c in eligible:
        res = residents[c]
        ni = node_index[c]
        if ni in receivers:
            # an earlier candidate's proof parked pods here; removing this
            # node too would invalidate that proof
            plan.blocked[c] = "holds simulated re-placements"
            continue
        moves: list[tuple[str, str]] = []
        trial = ledger.copy()
        trial_receivers: set[int] = set()
        trial_charge = dict(charged)
        reason = None
        for j, p in enumerate(res):
            if pdb_state:
                covering: list[int] = []
                for idx, (pdb, pns, pname, allowed) in enumerate(pdb_state):
                    if pns != p.metadata.namespace:
                        continue
                    if not _matches((pdb.get("spec") or {}).get("selector"),
                                    p.metadata.labels):
                        continue
                    if allowed - trial_charge.get(idx, 0) <= 0:
                        reason = f"pod {p.key} blocked by PDB {pname!r}"
                        break
                    covering.append(idx)
                if reason is not None:
                    break
                for idx in covering:
                    trial_charge[idx] = trial_charge.get(idx, 0) + 1
            row = mask[offsets[c] + j]
            req = reqs[offsets[c] + j]
            for target in np.flatnonzero(row[:real_n]):
                t = int(target)
                if t == ni or t in dead:
                    continue
                if np.all(req <= trial[t]):
                    trial[t] -= req
                    trial_receivers.add(t)
                    moves.append((p.key, node_names[t]))
                    break
            else:
                reason = f"pod {p.key} fits nowhere else"
                break
        if reason is not None:
            plan.blocked[c] = reason
            continue
        ledger = trial
        dead.add(ni)
        receivers |= trial_receivers
        charged = trial_charge
        plan.removable.append(c)
        plan.placements[c] = moves


def _unpin(pods: list[Pod]) -> list[Pod]:
    """Re-placement view: the evicted pod's replacement won't carry
    spec.nodeName, so the NodeName pin must not constrain the proof."""
    import dataclasses
    return [dataclasses.replace(
        p, spec=dataclasses.replace(p.spec, node_name=""))
        for p in pods]


def _scale_down_resident(resident, nodes, bound_pods, cand, residents,
                         threshold, pdbs, all_pod_dicts,
                         ) -> Optional[ScaleDownPlan]:
    """Scale-down against the device-resident cluster image: totals from
    the host shadow, the re-placement mask from ONE dispatch on the card.
    None on decline (the caller then runs the cold encode, producing an
    identical plan)."""
    ctx = resident.plan_view(nodes, bound_pods, planner="autoscaler")
    if ctx is None:
        return None
    arrays = resident.cluster_arrays(ctx)
    if arrays is None:
        return None
    alloc, req = arrays
    free = alloc - req
    pm = ctx["plan_meta"]
    res_idx = _waste_idx(pm.resources)
    plan = ScaleDownPlan()
    eligible = _scale_down_gate(plan, cand, pm.node_index, free, alloc,
                                res_idx, threshold)
    if not eligible:
        resident.hit(ctx)
        return plan
    all_res = [p for c in eligible for p in residents[c]]
    ms = resident.mask_scores(ctx, _unpin(all_res))
    if ms is None:
        return None
    mask, _scores, reqs = ms
    offsets = {}
    i = 0
    for c in eligible:
        offsets[c] = i
        i += len(residents[c])
    pod_dicts = all_pod_dicts
    if pod_dicts is None and pdbs:
        pod_dicts = [p.to_dict() for p in bound_pods]
    _scale_down_walk(plan, eligible, residents, pm.node_index,
                     pm.node_names, free, mask, reqs, offsets, pdbs,
                     pod_dicts)
    resident.hit(ctx)
    return plan


def simulate_scale_down(nodes: list[Node], bound_pods: list[Pod],
                        candidates: list[str],
                        utilization_threshold: float = 0.5,
                        pdbs: Optional[list[dict]] = None,
                        all_pod_dicts: Optional[list[dict]] = None,
                        encoder: Optional[SnapshotEncoder] = None,
                        resident=None, device=None,
                        ) -> ScaleDownPlan:
    """Prove which candidate nodes can drain: every resident pod must fit
    on some OTHER node per the tensor filters AND the remaining capacity
    ledger (one shared ledger across candidates, so reclaiming two nodes in
    one loop never double-books the survivors' room), and no eviction may
    violate a PodDisruptionBudget (controllers/disruption.py semantics via
    ``disruptions_allowed_for``).

    All candidates' residents evaluate in ONE ``run_filters`` call.

    ``resident`` (an encode/overlay.ResidentPlanner) serves the whole
    proof from the scheduler's device-resident encoding in steady state —
    totals from the host shadow, the mask from one warm dispatch, no cold
    encode. Declines fall through to the body below, bit-identically; it
    runs its one ``run_filters`` on ``device`` (None = the card).
    """
    plan = ScaleDownPlan()
    cand = [c for c in candidates]
    if not cand:
        return plan

    residents: dict[str, list[Pod]] = {c: [] for c in cand}
    for p in bound_pods:
        if p.spec.node_name in residents and not _daemon_or_mirror_pod(p):
            residents[p.spec.node_name].append(p)

    if resident is not None:
        out = _scale_down_resident(resident, nodes, bound_pods, cand,
                                   residents, utilization_threshold, pdbs,
                                   all_pod_dicts)
        if out is not None:
            return out

    device = resolve_device(device)
    enc = encoder or SnapshotEncoder()
    ct, meta = enc.encode_cluster(nodes, bound_pods, pending_slots=False)
    real_n = len(meta.node_names)
    free = _free_matrix(ct, real_n)
    alloc = np.asarray(ct.allocatable[:real_n], np.int64)
    res_idx = _waste_idx(meta.resources)

    eligible = _scale_down_gate(plan, cand, meta.node_index, free, alloc,
                                res_idx, utilization_threshold)
    if not eligible:
        return plan

    all_res = [p for c in eligible for p in residents[c]]
    if all_res:
        pb = enc.encode_pods(_unpin(all_res), meta)
        mask = run_filters(ct.to(device),               # ONE call, all nodes
                           pb.to(device)).cpu().numpy()
        reqs = np.asarray(pb.requests[:len(all_res)], np.int64)
    else:
        mask = np.zeros((0, real_n), bool)
        reqs = np.zeros((0, len(meta.resources)), np.int64)
    offsets = {}
    i = 0
    for c in eligible:
        offsets[c] = i
        i += len(residents[c])

    pod_dicts = all_pod_dicts
    if pod_dicts is None and pdbs:
        pod_dicts = [p.to_dict() for p in bound_pods]
    _scale_down_walk(plan, eligible, residents, meta.node_index,
                     meta.node_names, free, mask, reqs, offsets, pdbs,
                     pod_dicts)
    return plan
