"""Descheduler strategies — candidate-eviction-set generators.

Reference: ``kubernetes-sigs/descheduler`` strategy plugins
(``pkg/framework/plugins/``): nodeutilization (LowNodeUtilization /
HighNodeUtilization), removepodsviolatingnodeaffinity,
removepodsviolatingtopologyspreadconstraint, removeduplicates. Each
strategy here only NOMINATES candidate sets from the current cluster view;
every nomination is validated by the planner's single batched re-placement
simulation before anything is evicted (the reference interleaves discovery
and eviction; splitting them is what makes the one-call validation
possible).

Discovery itself stays batched where it reads scheduling semantics:
``RemovePodsViolatingNodeAffinity`` re-evaluates EVERY bound pod against
the current encoded snapshot in one ``run_filters`` call — stale placements
surface as mask[i, own_node] == False.

The PyTorch port of ``kubernetes_tpu/descheduler/strategies.py``: that
``run_filters`` call runs on ``device`` (None = the card), and SliceDefrag
pools through the port's ``topology.numpy_grids`` / ``select_eviction``.
"""

from __future__ import annotations

from typing import Optional

from kubernetes_tpu_torch.api.selectors import label_selector_matches
from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.descheduler.planner import (
    CandidateSet,
    _unpinned,
    evictable,
)
from kubernetes_tpu_torch.encode.scaling import (
    UNLIMITED,
    scale_allocatable,
    scale_request,
)
from kubernetes_tpu_torch.ops.filters import run_filters

# resources the utilization strategies measure, as upstream defaults
UTIL_RESOURCES = ("cpu", "memory")

# pods sharing this label form a gang (descheduler.py's defrag mode plans
# for pending ones; bound ones are co-placements consolidation must never
# break apart). Defined here so strategies can consult it without importing
# the control loop.
GANG_LABEL = "kubernetes-tpu.io/gang"


def _terminal(p: Pod) -> bool:
    return p.status.phase in ("Succeeded", "Failed")


def _residents(nodes: list[Node], bound_pods: list[Pod]
               ) -> dict[str, list[Pod]]:
    by_node: dict[str, list[Pod]] = {n.metadata.name: [] for n in nodes}
    for p in bound_pods:
        if p.spec.node_name in by_node and not _terminal(p):
            by_node[p.spec.node_name].append(p)
    return by_node


def node_utilization(node: Node, residents: list[Pod]) -> float:
    """Max requested/allocatable over cpu+memory (the simulator's
    scale-down gate uses the same figure — one definition, one answer)."""
    alloc = node.allocatable_canonical()
    best = 0.0
    for r in UTIL_RESOURCES:
        if r not in alloc:
            continue
        a = float(scale_allocatable(r, alloc[r]))
        if a <= 0 or a >= UNLIMITED:
            continue
        used = sum(scale_request(r, p.resource_requests().get(r, 0))
                   for p in residents)
        best = max(best, used / a)
    return best


def high_node_utilization(nodes: list[Node], bound_pods: list[Pod],
                          threshold: float = 0.3,
                          ) -> list[CandidateSet]:
    """HighNodeUtilization: drain UNDER-utilized nodes so their pods pack
    onto busier ones — the bin-packing profile that hands empty nodes to
    the autoscaler's scale-down. One candidate set per underutilized node
    (victims = its evictable residents, re-placement must avoid the node
    being drained)."""
    out = []
    res = _residents(nodes, bound_pods)
    for n in nodes:
        name = n.metadata.name
        pods = res[name]
        util = node_utilization(n, pods)
        if util >= threshold or n.spec.unschedulable:
            continue
        victims = [p for p in pods if evictable(p)]
        if not victims:
            continue
        out.append(CandidateSet(
            name=f"drain/{name}", strategy="HighNodeUtilization",
            victims=victims, exclude_targets={name},
            reason=f"utilization {util:.2f} below {threshold:.2f}"))
    # fewest-evictions-first: cheapest drains land inside the cycle budget
    out.sort(key=lambda cs: len(cs.victims))
    return out


def low_node_utilization(nodes: list[Node], bound_pods: list[Pod],
                         low: float = 0.2, high: float = 0.8,
                         ) -> list[CandidateSet]:
    """LowNodeUtilization: rebalance — evict from OVER-utilized nodes
    (above ``high``) so the scheduler spreads onto under-utilized ones
    (below ``low``). No eviction unless both sides exist, as upstream.
    Victims per hot node: smallest requests first, just enough to bring it
    to ``high``."""
    res = _residents(nodes, bound_pods)
    cold = [n for n in nodes
            if node_utilization(n, res[n.metadata.name]) < low]
    if not cold:
        return []
    out = []
    for n in nodes:
        name = n.metadata.name
        pods = res[name]
        util = node_utilization(n, pods)
        if util <= high:
            continue
        alloc = n.allocatable_canonical()
        caps = {r: float(scale_allocatable(r, alloc[r]))
                for r in UTIL_RESOURCES if r in alloc}
        victims = []
        movable = sorted(
            (p for p in pods if evictable(p)),
            key=lambda p: sum(scale_request(r, p.resource_requests().get(r, 0))
                              for r in caps))
        cur = {r: sum(scale_request(r, p.resource_requests().get(r, 0))
                      for p in pods) for r in caps}
        for p in movable:
            if all(cur[r] <= high * caps[r] for r in caps if caps[r] > 0):
                break
            victims.append(p)
            for r in caps:
                cur[r] -= scale_request(r, p.resource_requests().get(r, 0))
        if victims:
            # hot node must not receive its own overflow back; cold nodes
            # are where the planner's score-ordered walk will park them
            out.append(CandidateSet(
                name=f"rebalance/{name}", strategy="LowNodeUtilization",
                victims=victims, exclude_targets={name},
                reason=f"utilization {util:.2f} above {high:.2f}"))
    return out


def pods_violating_node_affinity(nodes: list[Node], bound_pods: list[Pod],
                                 encoder=None,
                                 device=None) -> list[CandidateSet]:
    """RemovePodsViolatingNodeAffinity: required node affinity / selector /
    taints are IgnoredDuringExecution — labels drift after binding. ONE
    ``run_filters`` over every bound pod (unpinned) against the current
    snapshot; a pod whose mask row is False at its OWN node has a stale
    placement. Each violator is its own candidate set: one stuck pod must
    not block the rest."""
    from kubernetes_tpu_torch.device import resolve_device
    from kubernetes_tpu_torch.encode.snapshot import (TENANT_LABEL,
                                                      SnapshotEncoder)
    # only a pod with a nodeSelector, required node affinity or a tenant
    # (its own or its node's) can have a False row at its own node; the
    # rest are never encoded (the reference encodes every bound pod: the
    # same sets, at 15000 pods most of a cycle's seconds)
    node_tenant = {n.metadata.name: n.metadata.labels.get(TENANT_LABEL)
                   for n in nodes}

    def constrained(p: Pod) -> bool:
        na = p.spec.affinity.node_affinity if p.spec.affinity else None
        return bool(p.spec.node_selector or (na and na.required)
                    or TENANT_LABEL in p.metadata.labels
                    or node_tenant[p.spec.node_name] is not None)

    live = [p for p in bound_pods if not _terminal(p) and evictable(p)
            and p.spec.node_name in node_tenant and constrained(p)]
    if not live:
        return []
    device = resolve_device(device)
    enc = encoder or SnapshotEncoder()
    unpinned = _unpinned(live)
    ct, meta = enc.encode_cluster(nodes, bound_pods, pending_pods=unpinned,
                                  pending_slots=False)
    pb = enc.encode_pods(unpinned, meta)
    mask = run_filters(ct.to(device), pb.to(device),
                       frozenset({"NodeAffinity"})).cpu().numpy()
    out = []
    for i, p in enumerate(live):
        row = meta.node_index.get(p.spec.node_name)
        if row is None or mask[i, row]:
            continue
        out.append(CandidateSet(
            name=f"affinity/{p.key}", strategy="RemovePodsViolatingNodeAffinity",
            victims=[p], exclude_targets=set(),
            reason=f"required affinity no longer matches {p.spec.node_name}"))
    return out


def pods_violating_topology_spread(nodes: list[Node], bound_pods: list[Pod],
                                   ) -> list[CandidateSet]:
    """RemovePodsViolatingTopologySpread: for every hard spread constraint
    carried by a bound pod, recompute the domain skew over CURRENT
    placements; domains more than maxSkew above the minimum shed their
    excess (newest pods first, like the reference's eviction sorter)."""
    node_labels = {n.metadata.name: n.metadata.labels for n in nodes}
    live = [p for p in bound_pods if not _terminal(p)
            and p.spec.node_name in node_labels]
    seen_constraints: set[tuple] = set()
    out = []
    for owner in live:
        for sc in owner.spec.topology_spread_constraints:
            if sc.when_unsatisfiable != "DoNotSchedule":
                continue
            sel = sc.label_selector
            ckey = (owner.metadata.namespace, sc.topology_key,
                    tuple(sorted((sel.match_labels or {}).items()))
                    if sel else ())
            if ckey in seen_constraints:
                continue
            seen_constraints.add(ckey)
            domains: dict[str, list[Pod]] = {}
            for p in live:
                if p.metadata.namespace != owner.metadata.namespace:
                    continue
                if not label_selector_matches(sel, p.metadata.labels):
                    continue
                dom = node_labels[p.spec.node_name].get(sc.topology_key)
                if dom is not None:
                    domains.setdefault(dom, []).append(p)
            # every node eligible for the constraint counts, even empty
            for labels in node_labels.values():
                dom = labels.get(sc.topology_key)
                if dom is not None:
                    domains.setdefault(dom, [])
            if len(domains) < 2:
                continue
            floor = min(len(ps) for ps in domains.values())
            for dom, ps in sorted(domains.items()):
                excess = len(ps) - floor - int(sc.max_skew)
                if excess <= 0:
                    continue
                victims = [p for p in ps if evictable(p)][-excess:]
                if not victims:
                    continue
                same_domain = {nn for nn, labels in node_labels.items()
                               if labels.get(sc.topology_key) == dom}
                out.append(CandidateSet(
                    name=f"spread/{sc.topology_key}={dom}",
                    strategy="RemovePodsViolatingTopologySpread",
                    victims=victims, exclude_targets=same_domain,
                    reason=f"domain skew {len(ps) - floor} over "
                           f"maxSkew {sc.max_skew}"))
    return out


def remove_duplicates(nodes: list[Node], bound_pods: list[Pod],
                      ) -> list[CandidateSet]:
    """RemoveDuplicates: >1 pod of the same controller on one node defeats
    the replica-spreading the controller wanted; evict the extras and make
    the proof find them a DIFFERENT node."""
    node_names = {n.metadata.name for n in nodes}
    groups: dict[tuple, list[Pod]] = {}
    for p in bound_pods:
        if _terminal(p) or p.spec.node_name not in node_names:
            continue
        ctrl = next((r for r in p.metadata.owner_references
                     if r.get("controller")), None)
        if ctrl is None and p.metadata.owner_references:
            ctrl = p.metadata.owner_references[0]
        if ctrl is None:
            continue
        key = (p.metadata.namespace, ctrl.get("kind", ""),
               ctrl.get("name", ""), p.spec.node_name)
        groups.setdefault(key, []).append(p)
    out = []
    for (ns, kind, owner, node), ps in sorted(groups.items()):
        if len(ps) < 2:
            continue
        victims = [p for p in sorted(ps, key=lambda p: p.metadata.name)[1:]
                   if evictable(p)]
        if not victims:
            continue
        out.append(CandidateSet(
            name=f"duplicates/{ns}/{kind}/{owner}@{node}",
            strategy="RemoveDuplicates", victims=victims,
            exclude_targets={node},
            reason=f"{len(ps)} replicas of {kind}/{owner} on {node}"))
    return out


def gang_consolidation_candidates(nodes: list[Node], bound_pods: list[Pod],
                                  max_nodes: Optional[int] = None,
                                  max_victim_priority: Optional[int] = None,
                                  pdbs: Optional[list[dict]] = None,
                                  all_pod_dicts: Optional[list[dict]] = None,
                                  ) -> list[CandidateSet]:
    """Candidate sets for gang defragmentation: cumulative drain prefixes.

    Nodes are ranked cheapest-drain-first (fewest evictable residents,
    largest capacity as tie-break) and candidate k = "drain the first k
    nodes". Prefixes are nested, so ascending prefix length IS ascending
    eviction count — the planner's fewest-evictions scan tries them in
    order and stops at the first that both re-places every victim and
    seats the whole gang. ``max_victim_priority`` restricts victims to
    pods that do not OUTRANK the gang (peers-or-below; consolidation
    preserves victims, so moving a non-gang peer is safe — the
    scheduler-side nomination shield likewise protects the gang against
    equal-priority replacements). Evicting a higher-priority pod for a
    lower-priority gang would be the priority inversion upstream never
    allows. Bound pods carrying ``GANG_LABEL`` are never victims
    regardless of priority: they are seats of an already-placed gang, and
    "consolidating" one fragments that gang — for the gang's OWN seated
    members it is endless musical chairs (evict gang-0 to seat gang-1,
    whose plan next cycle evicts gang-1 to seat gang-0).

    ``pdbs``: because candidates are CUMULATIVE prefixes, a node whose own
    drain overdraws a disruption budget poisons every prefix containing it
    — the planner would block the entire fewest-evictions scan at that
    prefix and beyond. Such nodes are excluded up front (same live
    ``disruptionsAllowed`` arithmetic the planner's ledger charges
    against), and among equally-cheap drains budget-free nodes rank first
    so guarded pods spend budget only when no unguarded drain is as cheap.
    The planner remains the authority: budgets here are per-node screens,
    cumulative charging across a prefix still happens in ``_try_set``."""
    res = _residents(nodes, bound_pods)

    budgets: list[tuple[dict, str, str, int]] = []
    if pdbs:
        from kubernetes_tpu_torch.api.policy import _matches, pdb_budgets
        if all_pod_dicts is None:
            all_pod_dicts = [p.to_dict() for p in bound_pods]
        budgets = pdb_budgets(pdbs, all_pod_dicts)

    def _pdb_charge(victims: list[Pod]) -> Optional[int]:
        """Budget charges draining ``victims`` would incur, or None when
        any single budget overdraws (node can never drain)."""
        total = 0
        for pdb, pns, _name, allowed in budgets:
            sel = (pdb.get("spec") or {}).get("selector")
            n = sum(1 for p in victims if p.metadata.namespace == pns
                    and _matches(sel, p.metadata.labels))
            if n > allowed:
                return None
            total += n
        return total

    def _cap(n: Node) -> float:
        alloc = n.allocatable_canonical()
        return float(scale_allocatable("cpu", alloc.get("cpu", 0)))

    drainable = []
    for n in nodes:
        if n.spec.unschedulable:
            continue
        pods = res[n.metadata.name]
        victims = [p for p in pods if evictable(p)
                   and GANG_LABEL not in p.metadata.labels
                   and (max_victim_priority is None
                        or p.spec.priority <= max_victim_priority)]
        if len(victims) < len([p for p in pods if evictable(p)]):
            continue  # node holds peers/protected pods: can't fully drain
        charge = _pdb_charge(victims)
        if charge is None:
            continue  # overdraws a budget alone: poisons every prefix
        drainable.append((len(victims), charge, -_cap(n),
                          n.metadata.name, victims))
    drainable.sort(key=lambda t: (t[0], t[1], t[2], t[3]))
    if max_nodes is not None:
        drainable = drainable[:max_nodes]
    out = []
    acc_victims: list[Pod] = []
    acc_nodes: set[str] = set()
    for k, (_, _, _, name, victims) in enumerate(drainable, start=1):
        acc_victims = acc_victims + victims
        acc_nodes = acc_nodes | {name}
        out.append(CandidateSet(
            name=f"consolidate/{k}-nodes", strategy="GangDefrag",
            victims=list(acc_victims), exclude_targets=set(acc_nodes),
            reason=f"drain {sorted(acc_nodes)} for pending gang"))
    return out


def slice_defrag_candidates(nodes: list[Node], bound_pods: list[Pod],
                            pending: Optional[list[Pod]] = None,
                            max_victim_priority: Optional[int] = None,
                            pdbs: Optional[list[dict]] = None,
                            all_pod_dicts: Optional[list[dict]] = None,
                            ) -> list[CandidateSet]:
    """SliceDefrag: defrag TOWARD CONTIGUITY. For each pending slice gang
    (``kubernetes-tpu.io/slice-shape``) the carver's eviction plane names
    the cheapest contiguous victim set — the fewest-evictions box that
    frees one whole placement of the requested shape — and that box
    becomes ONE candidate set (victims = the box's residents, re-placement
    must avoid the box being freed). Reuses the scheduler's exact pooling
    (topology/carve.numpy_grids + select_eviction), so the descheduler
    frees the SAME box the carver will pick next cycle. The gang-seat
    protections of gang consolidation carry over: bound GANG_LABEL pods
    are never victims, victims never outrank the pending gang, and a box
    whose drain alone overdraws a PDB is discarded."""
    from kubernetes_tpu_torch.topology.carve import numpy_grids, select_eviction
    from kubernetes_tpu_torch.topology.slicing import (coords_of_labels,
                                                 grid_dims, shape_of_labels,
                                                 shape_str)
    coords = [coords_of_labels(n.metadata.labels) for n in nodes]
    dims = grid_dims([c for c in coords if c is not None])
    if dims is None or not pending:
        return []
    gangs: dict[str, list[Pod]] = {}
    shapes: dict[str, tuple] = {}
    for p in pending:
        shape = shape_of_labels(p.metadata.labels)
        if shape is None:
            continue
        g = p.metadata.labels.get(GANG_LABEL) or f"pod:{p.key}"
        gangs.setdefault(g, []).append(p)
        shapes[g] = shape

    budgets: list = []
    if pdbs:
        from kubernetes_tpu_torch.api.policy import _matches, pdb_budgets
        if all_pod_dicts is None:
            all_pod_dicts = [p.to_dict() for p in bound_pods]
        budgets = pdb_budgets(pdbs, all_pod_dicts)

    def _overdraws(victims: list[Pod]) -> bool:
        for pdb, pns, _name, allowed in budgets:
            sel = (pdb.get("spec") or {}).get("selector")
            n = sum(1 for p in victims if p.metadata.namespace == pns
                    and _matches(sel, p.metadata.labels))
            if n > allowed:
                return True
        return False

    res = _residents(nodes, bound_pods)
    out: list[CandidateSet] = []
    claimed: set[int] = set()
    for g in sorted(gangs):
        shape = shapes[g]
        if len(gangs[g]) != shape[0] * shape[1] * shape[2]:
            continue  # malformed gang: the scheduler explains, not us
        prio = (min(p.spec.priority for p in gangs[g])
                if max_victim_priority is None else max_victim_priority)
        free, evict_ok, n_pods = [], [], []
        for i, n in enumerate(nodes):
            pods = res[n.metadata.name]
            usable = not n.spec.unschedulable and i not in claimed
            clean = all(evictable(p)
                        and GANG_LABEL not in p.metadata.labels
                        and p.spec.priority <= prio for p in pods)
            free.append(usable and not pods)
            evict_ok.append(usable and clean)
            n_pods.append(len(pods))
        sel = select_eviction(numpy_grids(coords, free, evict_ok, n_pods,
                                          dims, shape))
        if sel is None:
            continue
        node_idxs, _cells, cost = sel
        box_names = {nodes[i].metadata.name for i in node_idxs}
        victims = [p for i in node_idxs for p in res[nodes[i].metadata.name]]
        if not victims or _overdraws(victims):
            continue
        claimed.update(node_idxs)
        out.append(CandidateSet(
            name=f"slicedefrag/{g}", strategy="SliceDefrag",
            victims=victims, exclude_targets=box_names,
            reason=(f"free a contiguous {shape_str(shape)} box for gang "
                    f"{g} ({int(cost)} eviction(s))")))
    return out


STRATEGY_BUILDERS = {
    "HighNodeUtilization": high_node_utilization,
    "LowNodeUtilization": low_node_utilization,
    "RemovePodsViolatingNodeAffinity": pods_violating_node_affinity,
    "RemovePodsViolatingTopologySpread": pods_violating_topology_spread,
    "RemoveDuplicates": remove_duplicates,
    "SliceDefrag": slice_defrag_candidates,
}
