"""Tensorized preemption dry-run — DryRunPreemption as torch ops.

The PyTorch port of ``kubernetes_tpu/ops/preemption.py``. Reference:
``pkg/scheduler/framework/preemption/preemption.go`` (``DryRunPreemption``
fans the per-node victim simulation across 16 goroutines;
``SelectVictimsOnNode`` removes lower-priority pods until the preemptor
fits, non-PDB-violating victims first) and ``default_preemption.go``
(``pickOneNodeForPreemption``: fewest PDB violations, then lowest max
victim priority, then fewest victims, then node order).

The victim search is a masked ``[N, V+1]`` program — victims sorted per
node in eviction order, capacity release as an exclusive prefix sum over
the victim axis, so "does the preemptor fit node n after evicting its first
k victims?" is one comparison for every (n, k) at once. The device ranks
candidates by the reference's pickOneNode key; the host then EXACTLY
verifies the winner (full filter set incl. relational terms + reprieve)
via the same ``_victims_on_node`` the serial path uses — so the result is
always sound, the device only narrows the O(N×V) search.

Where the port differs from the reference:

- Everything runs in int32 on the device, as the reference does: the JAX
  package never enables x64, so its int64 host arrays are staged as int32.
  ``torch.cumsum`` would promote to int64, so every prefix sum names
  ``dtype=torch.int32``.
- ``_wave_scan`` is a Python loop over the preemptors (the reference's
  ``lax.scan``). The carry (requested, evicted) stays on the device and
  nothing is read on the host inside the loop; the four outputs come back
  in one copy at the end. Its ``steps`` argument stops the loop after the
  last real preemptor: a pad row (``_INT_MIN`` priority, all-False mask)
  evicts nothing, commits nothing and yields constant outputs, which the
  loop writes without running the step.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.device import resolve_device
from kubernetes_tpu_torch.encode.dictionary import next_bucket
from kubernetes_tpu_torch.encode.scaling import (scale_allocatable,
                                                 scale_request)

EFFECTS = ("NoSchedule", "NoExecute")
_INT_MIN = np.iinfo(np.int32).min + 1
_INT_MAX = np.iinfo(np.int32).max


def _first_true(mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the first True along ``dim`` (0 where none): argmax over an
    int cast, since CUDA has no bool argmax. torch's argmax returns the
    first index of the maximum, as JAX's does."""
    return torch.argmax(mask.to(torch.int32), dim=dim)


def _excl_cumsum(x: torch.Tensor) -> torch.Tensor:
    """[N,V,...] -> [N,V+1,...]: 0 then the int32 running sum over the
    victim axis."""
    run = torch.cumsum(x, dim=1, dtype=torch.int32)
    return torch.cat([torch.zeros_like(run[:, :1]), run], dim=1)


def _excl_cummax(x: torch.Tensor) -> torch.Tensor:
    """[N,V] int32 -> [N,V+1]: ``_INT_MIN`` then the running max."""
    run = torch.cummax(x, dim=1).values
    return torch.cat([torch.full_like(run[:, :1], _INT_MIN), run], dim=1)


def _dry_run(allocatable, requested, static_mask, vic_req, vic_valid,
             vic_violating, vic_prio, need):
    """[N,R],[N,R],[N],[N,V,R],[N,V],[N,V],[N,V],[R] ->
    (any_feasible [N], k_min [N], violations_at_k [N], max_prio_at_k [N]).

    k_min = fewest leading victims (in eviction order) whose removal fits
    the preemptor; prefix sums release capacity, cumulative max tracks the
    pickOneNode "highest victim priority" metric."""
    N = vic_req.shape[0]
    freed = _excl_cumsum(torch.where(vic_valid[..., None], vic_req,
                                     torch.zeros_like(vic_req)))
    fits = torch.all(requested[:, None, :] - freed + need[None, None, :]
                     <= allocatable[:, None, :], dim=-1)          # [N,V+1]
    # prefix k is only removable if victims 0..k-1 all exist
    kvalid = torch.cat(
        [torch.ones((N, 1), dtype=torch.bool, device=vic_valid.device),
         torch.cumprod(vic_valid.to(torch.int32), dim=1).bool()], dim=1)
    feasible = fits & kvalid & static_mask[:, None]
    k_min = _first_true(feasible, dim=1)
    any_f = torch.any(feasible, dim=1)
    viol_cum = _excl_cumsum((vic_violating & vic_valid).to(torch.int32))
    prio_cummax = _excl_cummax(torch.where(
        vic_valid, vic_prio, torch.full_like(vic_prio, _INT_MIN)))

    def take(a):
        return torch.gather(a, 1, k_min[:, None])[:, 0]
    return any_f, k_min, take(viol_cum), take(prio_cummax)


def _static_mask(nodes: list[Node], pod: Pod, dra=None) -> np.ndarray:
    """Victim-independent filters: unschedulable, nodeName, taints, node
    affinity, DRA claim state. Relational/ports/volume feasibility is
    settled by the exact host verification of the winning candidate
    (removing victims can only HELP those, so this mask never wrongly
    excludes a candidate — except taint/affinity/claims, which victims
    cannot change)."""
    from kubernetes_tpu_torch.sched.oracle import (
        UNSCHED_TAINT, OracleScheduler, tolerates_all)
    orc = OracleScheduler(nodes, [])
    out = np.zeros(len(nodes), bool)
    # claim state is victim-independent: an unready claim holds the pod
    # everywhere (dynamicresources PreFilter), and a claim already
    # allocated to node X pins the pod to X exactly like spec.nodeName
    claim_pin = None
    if dra is not None and pod.spec.resource_claims:
        if not dra.pod_claims_ready(pod):
            return out
        claim_pin = dra.pod_allocated_node(pod)
    for i, node in enumerate(nodes):
        # fleet visibility: preemption must never target (and therefore
        # never evict victims from) a sibling tenant's node
        if orc._tenant_of(pod.metadata.labels) != orc._tenant_of(
                node.metadata.labels):
            continue
        if node.spec.unschedulable and not any(
                t.tolerates(UNSCHED_TAINT) for t in pod.spec.tolerations):
            continue
        if pod.spec.node_name and pod.spec.node_name != node.metadata.name:
            continue
        if claim_pin and claim_pin != node.metadata.name:
            continue
        if not tolerates_all(pod.spec.tolerations, node.spec.taints, EFFECTS):
            continue
        if not orc._node_affinity_ok(pod, node):
            continue
        out[i] = True
    return out


_TOPK = 4  # device-ranked candidates surfaced per preemptor for exact re-rank


def _wave_step(allocatable, requested, evicted, vic_req, vic_valid,
               vic_violating, vic_prio, need_q, prio_q, smask_q):
    """One preemptor of the wave: rank, pick, and commit into the carry
    (``requested`` and ``evicted`` are updated in place). -> (found [],
    zero_evict [], cand_nodes [K] int32, evict_sel [V])."""
    N, V, R = vic_req.shape
    dev = vic_req.device
    evictable = vic_valid & ~evicted & (vic_prio < prio_q)        # [N,V]
    freed = _excl_cumsum(torch.where(evictable[..., None], vic_req,
                                     torch.zeros_like(vic_req)))
    # the resource axis is the UNION across the wave; each preemptor is
    # constrained only on axes it actually requests (need_q > 0) — matching
    # the serial path, where an externally-overcommitted axis the preemptor
    # never asked for does not veto the node
    fit_r = ((requested[:, None, :] + need_q[None, None, :] - freed
              <= allocatable[:, None, :]) | (need_q == 0)[None, None, :])
    fits = torch.all(fit_r, dim=-1)                               # [N,V+1]
    feasible = fits & smask_q[:, None]
    k_min = _first_true(feasible, dim=1)                          # [N]
    any_f = torch.any(feasible, dim=1)

    def take(a):
        return torch.gather(a, 1, k_min[:, None])[:, 0]
    nvic = take(_excl_cumsum(evictable.to(torch.int32)))
    viol = take(_excl_cumsum((evictable & vic_violating).to(torch.int32)))
    maxp = take(_excl_cummax(torch.where(
        evictable, vic_prio, torch.full_like(vic_prio, _INT_MIN))))
    # a zero-eviction fit means the scheduling failure was something this
    # resource model can't see (relational/ports/volumes): the caller must
    # run the exact path for this preemptor — and nothing is committed
    zero_evict = torch.any(any_f & (nvic == 0))
    cand = any_f & (nvic > 0)
    # pickOneNode: staged lexicographic argmin (viol, maxPrio, nVictims,
    # node order), repeated K times with the winner masked out — int32
    # throughout, as the reference (a packed key would overflow int32)
    big = torch.full_like(viol, _INT_MAX)
    node_ids = torch.arange(N, device=dev)

    def pick_best(avail):
        m = avail
        m = m & (viol == torch.where(m, viol, big).min())
        m = m & (maxp == torch.where(m, maxp, big).min())
        m = m & (nvic == torch.where(m, nvic, big).min())
        return _first_true(m)

    picks = []
    avail = cand
    for _ in range(min(_TOPK, N)):
        n_k = pick_best(avail)
        picks.append(torch.where(torch.any(avail), n_k,
                                 torch.full_like(n_k, -1)))
        avail = avail & (node_ids != n_k)
    cand_nodes = torch.stack(picks).to(torch.int32)               # [K]
    n_star = torch.clamp(cand_nodes[:1].long(), min=0)            # [1]
    found = torch.any(cand) & ~zero_evict
    k_star = k_min.index_select(0, n_star)                        # [1]
    evict_sel = (evictable.index_select(0, n_star)[0]
                 & (torch.arange(V, device=dev) < k_star) & found)  # [V]
    # commit: release the victims' capacity, reserve the preemptor's demand
    freed_star = torch.gather(freed.index_select(0, n_star), 1,
                              k_star.view(1, 1, 1).expand(1, 1, R))[0]
    delta = torch.where(found, need_q - freed_star[0],
                        torch.zeros_like(need_q))
    requested.index_add_(0, n_star, delta[None])
    evicted.index_copy_(0, n_star,
                        evicted.index_select(0, n_star) | evict_sel[None])
    return found, zero_evict, cand_nodes, evict_sel


def _wave_scan(allocatable, requested0, static_mask, vic_req, vic_valid,
               vic_violating, vic_prio, need, prio,
               steps: Optional[int] = None):
    """Sequential-commit preemption wave.

    [N,R], [N,R], [Q,N], [N,V,R], [N,V], [N,V], [N,V], [Q,R], [Q] ->
    (found [Q], zero_evict [Q], cand_nodes [Q,K], evict_sel [Q,V]).

    A loop over the Q preemptors carries (requested, evicted) on the
    device: each step derives its own evictable set (victims strictly lower
    priority, not yet evicted), releases capacity via exclusive prefix
    sums, ranks nodes by the pickOneNode key and COMMITS the best — its
    victims flip to evicted and the preemptor's demand is reserved on the
    node — so the next preemptor sees the mutated cluster, exactly like
    the serial failure path's evict-then-retry (``schedule_one.go``
    nominatedNodeName handling). The K-best candidate nodes (best first,
    -1 = none) go to the host for exact post-reprieve re-ranking.

    ``steps``: run only the first ``steps`` preemptors; the rows after them
    must be pad rows (their outputs are constant: not found, no
    zero-eviction fit, no candidate, no victim)."""
    N, V, R = vic_req.shape
    Q = need.shape[0]
    K = min(_TOPK, N)
    dev = vic_req.device
    steps = Q if steps is None else steps
    requested = requested0.clone()
    evicted = torch.zeros((N, V), dtype=torch.bool, device=dev)
    found = torch.zeros(Q, dtype=torch.bool, device=dev)
    zero_evict = torch.zeros(Q, dtype=torch.bool, device=dev)
    cand_nodes = torch.full((Q, K), -1, dtype=torch.int32, device=dev)
    evict_sel = torch.zeros((Q, V), dtype=torch.bool, device=dev)
    for q in range(steps):
        f, z, c, e = _wave_step(allocatable, requested, evicted, vic_req,
                                vic_valid, vic_violating, vic_prio, need[q],
                                prio[q], static_mask[q])
        found[q] = f
        zero_evict[q] = z
        cand_nodes[q] = c
        evict_sel[q] = e
    return found, zero_evict, cand_nodes, evict_sel


def _encode_cluster_arrays(nodes, bound_pods, resources, prio_cut,
                           budgets, dra=None, resident_arrays=None,
                           req_lookup=None):
    """Shared host encoding for dry-run programs: per-node totals plus the
    victim tensors in eviction order (non-violating first, priority asc —
    SelectVictimsOnNode's two-phase removal). ``prio_cut``: only pods with
    priority strictly below it are encoded as victims (for a wave, the max
    preemptor priority; the device re-masks per preemptor).

    ``resident_arrays``: optional ``fn(resources) -> (allocatable [N,R],
    requested [N,R]) | None`` — the scheduler's resident drain context
    already holds these totals (folds + churn patches keep them current),
    so a wave riding it reads them instead of re-summing every bound pod's
    requests host-side. ``req_lookup``: optional ``fn(pod, resources) ->
    [R] | None`` serving per-victim request vectors from the context's fold
    ledger (same scaled-integer encoding, remapped onto the wave's
    resource axis).
    -> (allocatable [N,R], requested [N,R], vic_req, vic_valid,
        vic_violating, vic_prio, vic_ref [N,V] indices into bound_pods),
    numpy, int64 where the reference's host arrays are."""
    from kubernetes_tpu_torch.sched.preemption import _violates
    R = len(resources)
    N = len(nodes)
    name_to_i = {n.metadata.name: i for i, n in enumerate(nodes)}

    def req_vec(p: Pod) -> np.ndarray:
        if req_lookup is not None:
            v = req_lookup(p, resources)
            if v is not None:
                return v
        pr = dict(p.resource_requests())
        if dra is not None:
            pr.update(dra.pod_demands(p))
        v = np.zeros(R, np.int64)
        for j, r in enumerate(resources):
            v[j] = scale_request(r, pr.get(r, 0)) if r != "pods" else \
                scale_request(r, pr.get(r, 1))
        return v

    precomputed = resident_arrays(resources) if resident_arrays else None
    per_node: dict[int, list[int]] = {}
    req_cache = {}
    if precomputed is not None:
        allocatable, requested = precomputed
        # victims only: the totals came from the resident encoding, so the
        # O(pods) per-pod vector pass shrinks to the below-cutoff set
        for idx, p in enumerate(bound_pods):
            i = name_to_i.get(p.spec.node_name)
            if i is not None and p.spec.priority < prio_cut:
                per_node.setdefault(i, []).append(idx)
                req_cache[idx] = req_vec(p)
    else:
        allocatable = np.zeros((N, R), np.int64)
        for i, n in enumerate(nodes):
            alloc = n.allocatable_canonical()
            if dra is not None:
                alloc.update(dra.node_capacity(n.metadata.name))
            for j, r in enumerate(resources):
                if r == "pods" and r not in alloc:
                    allocatable[i, j] = _INT_MAX
                else:
                    allocatable[i, j] = scale_allocatable(r, alloc.get(r, 0))
        requested = np.zeros((N, R), np.int64)
        for idx, p in enumerate(bound_pods):
            i = name_to_i.get(p.spec.node_name)
            if i is None:
                continue
            rv = req_vec(p)
            req_cache[idx] = rv
            requested[i] += rv
            if p.spec.priority < prio_cut:
                per_node.setdefault(i, []).append(idx)
    V = next_bucket(max((len(v) for v in per_node.values()), default=1),
                    minimum=1)
    vic_req = np.zeros((N, V, R), np.int64)
    vic_valid = np.zeros((N, V), bool)
    vic_violating = np.zeros((N, V), bool)
    vic_prio = np.zeros((N, V), np.int32)
    vic_ref = np.full((N, V), -1, np.int32)
    for i, idxs in per_node.items():
        used = [[ns, sel, allowed, 0] for (ns, sel, allowed) in budgets]
        flagged = [(idx, _violates(bound_pods[idx], used))
                   for idx in sorted(
                       idxs, key=lambda j: bound_pods[j].spec.priority)]
        ordered = ([(j, v) for j, v in flagged if not v]
                   + [(j, v) for j, v in flagged if v])
        for k, (j, v) in enumerate(ordered):
            vic_req[i, k] = req_cache[j]
            vic_valid[i, k] = True
            vic_violating[i, k] = v
            vic_prio[i, k] = bound_pods[j].spec.priority
            vic_ref[i, k] = j
    return allocatable, requested, vic_req, vic_valid, vic_violating, \
        vic_prio, vic_ref


def _stage(arrays, device) -> list[torch.Tensor]:
    """Host arrays -> device tensors, integers as int32 (the reference's
    int64 arrays run in int32: the JAX package never enables x64)."""
    out = []
    for a in arrays:
        a = np.asarray(a)
        if a.dtype != np.bool_:
            a = a.astype(np.int32)
        out.append(torch.from_numpy(np.ascontiguousarray(a)).to(device))
    return out


def wave_inputs(nodes: list[Node], bound_pods: list[Pod],
                preemptors: list[Pod], budgets: list[tuple], dra=None,
                static_masks: Optional[np.ndarray] = None, min_q: int = 1,
                resident_arrays=None, req_lookup=None, device=None):
    """The wave's host encoding, staged on ``device``: -> (the nine
    ``_wave_scan`` inputs, ``vic_ref`` [N,V] indices into ``bound_pods``).
    The wave length is bucketed as the reference buckets it (its scan
    length is structural): Qb = next_bucket(max(Q, min_q)). Pad rows are
    inert: INT_MIN priority evicts nothing and an all-False static mask
    admits nothing."""
    device = resolve_device(device)
    reqs_union: dict = {}
    for pod in preemptors:
        pr = dict(pod.resource_requests())
        if dra is not None:
            pr.update(dra.pod_demands(pod))
        reqs_union.update(pr)
    reqs_union.setdefault("pods", 1)
    resources = sorted(reqs_union)
    R = len(resources)
    Q = len(preemptors)
    Qb = next_bucket(max(Q, min_q), minimum=1)
    need = np.zeros((Qb, R), np.int64)
    prio = np.full(Qb, _INT_MIN, np.int32)
    for q, pod in enumerate(preemptors):
        pr = dict(pod.resource_requests())
        if dra is not None:
            pr.update(dra.pod_demands(pod))
        pr.setdefault("pods", 1)
        for j, r in enumerate(resources):
            need[q, j] = scale_request(r, pr.get(r, 0)) if r != "pods" \
                else scale_request(r, pr.get(r, 1))
        prio[q] = pod.spec.priority

    allocatable, requested, vic_req, vic_valid, vic_violating, vic_prio, \
        vic_ref = _encode_cluster_arrays(
            nodes, bound_pods, resources, int(prio.max(initial=0)),
            budgets, dra=dra, resident_arrays=resident_arrays,
            req_lookup=req_lookup)
    if static_masks is None:
        static_masks = np.stack([_static_mask(nodes, pod, dra=dra)
                                 for pod in preemptors])
    if static_masks.shape[0] < Qb:
        static_masks = np.concatenate(
            [static_masks,
             np.zeros((Qb - static_masks.shape[0], static_masks.shape[1]),
                      bool)])
    staged = _stage((allocatable, requested, static_masks[:Qb], vic_req,
                     vic_valid, vic_violating, vic_prio, need, prio), device)
    return staged, vic_ref


def dry_run_wave(nodes: list[Node], bound_pods: list[Pod],
                 preemptors: list[Pod], budgets: list[tuple], dra=None,
                 static_masks: Optional[np.ndarray] = None,
                 min_q: int = 1, resident_arrays=None,
                 req_lookup=None, device=None) -> list:
    """Device dry-run for a WAVE of preemptors with sequential-commit
    semantics. -> per-preemptor ``None`` (no resource-feasible eviction
    set), ``"zero_evict"`` (fits without evicting: failure was relational,
    run the exact path), or ``(cand_node_indices, [victim Pod, ...])`` —
    the device's K-best candidate nodes (best first) and its committed
    victims on the best one, to be exactly verified + re-ranked host-side.

    ``static_masks`` [Q,N]: victim-independent feasibility (taints/affinity/
    nodeName/unschedulable) per preemptor; computed via the serial host
    helper when not supplied (callers at fleet scale should supply one from
    the encoded cluster's filter masks — sched/preemption
    tensor_static_masks). ``device``: the card unless the caller asks for
    the CPU."""
    staged, vic_ref = wave_inputs(
        nodes, bound_pods, preemptors, budgets, dra=dra,
        static_masks=static_masks, min_q=min_q,
        resident_arrays=resident_arrays, req_lookup=req_lookup,
        device=device)
    Q = len(preemptors)
    # the pad rows after the last preemptor are skipped; one copy out
    found, zero_evict, cand_nodes, evict_sel = (
        t.cpu().numpy() for t in _wave_scan(*staged, steps=Q))
    out = []
    for q in range(Q):
        if zero_evict[q]:
            out.append("zero_evict")
        elif not found[q]:
            out.append(None)
        else:
            ni = int(cand_nodes[q][0])
            victims = [bound_pods[int(vic_ref[ni, k])]
                       for k in np.flatnonzero(evict_sel[q])]
            out.append(([int(c) for c in cand_nodes[q] if c >= 0], victims))
    return out


def dry_run_candidates(nodes: list[Node], bound_pods: list[Pod], pod: Pod,
                       budgets: list[tuple], dra=None, device=None
                       ) -> tuple[list[tuple[tuple, int, int]], bool]:
    """Device-ranked preemption candidates: ``([(pickOneNode_key,
    node_index, k_victims)] best-first, zero_evict_exists)``. The candidate
    list is empty when no node can be made feasible by evicting
    lower-priority pods (resource-wise); ``zero_evict_exists`` flags nodes
    that fit WITHOUT evictions — meaning the main cycle's failure was
    something this dry-run doesn't model (relational/ports/volumes) and the
    caller should run the exact scan."""
    device = resolve_device(device)
    # resource axes: everything the preemptor demands
    reqs = dict(pod.resource_requests())
    if dra is not None:
        reqs.update(dra.pod_demands(pod))
    if not reqs:
        reqs = {"pods": 1}
    reqs.setdefault("pods", 1)
    resources = sorted(reqs)
    need = np.array([scale_request(r, reqs[r]) for r in resources], np.int64)

    allocatable, requested, vic_req, vic_valid, vic_violating, vic_prio, \
        _vic_ref = _encode_cluster_arrays(
            nodes, bound_pods, resources, pod.spec.priority, budgets,
            dra=dra)
    if not vic_valid.any():
        return [], False

    staged = _stage((allocatable, requested,
                     _static_mask(nodes, pod, dra=dra), vic_req, vic_valid,
                     vic_violating, vic_prio, need), device)
    any_f, k_min, viols, maxprio = (t.cpu().numpy()
                                    for t in _dry_run(*staged))
    out = []
    zero_evict = False
    for i in range(len(nodes)):
        if not any_f[i]:
            continue
        if k_min[i] == 0:
            zero_evict = True  # fits with no eviction: failure wasn't resources
            continue
        key = (int(viols[i]), int(maxprio[i]), int(k_min[i]), i)
        out.append((key, i, int(k_min[i])))
    out.sort()
    return out, zero_evict
