"""One scheduling step for a batch of P pods.

The PyTorch port of ``kubernetes_tpu/models/schedule_step.py``: where
``schedule_one.go`` runs pop -> PreFilter -> Filter loop -> Score loop ->
NormalizeScore -> selectHost *per pod*, here the whole pipeline runs over
the [P, N] batch:

    feasible[P,N] = AND of plugin masks        (ops/filters.py, ops/topology.py)
    scores[P,N]   = sum_w w * normalize(raw)   (ops/scores.py)
    choice[P]     = argmax + seeded tie-break

Gang conflict resolution (capacity, anti-affinity among batch members) lives
in models/gang.py and calls back into this step between rounds.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from kubernetes_tpu_torch.encode.snapshot import ClusterTensors, PodBatch
from kubernetes_tpu_torch.ops import topology
from kubernetes_tpu_torch.ops.filters import run_filters, tenant_local_rank
from kubernetes_tpu_torch.ops.scores import combined_score, select_host


@dataclass
class StepResult:
    choice: torch.Tensor     # [P] int32 node index (valid only where assigned)
    assigned: torch.Tensor   # [P] bool
    feasible: torch.Tensor   # [P,N] bool
    scores: torch.Tensor     # [P,N] float32 (-inf infeasible)


def evaluate(ct: ClusterTensors, pb: PodBatch, seed: int = 0,
             weights=None, fit_strategy: str = "LeastAllocated",
             topo_keys: tuple[int, ...] = (),
             enabled_filters=None, ext_mask=None,
             ext_scores=None, plugins: tuple = ()) -> StepResult:
    """Filter + score + select for the whole batch, assuming an EMPTY batch
    context (no intra-batch interactions — gang.py supplies those).

    ``topo_keys``: tuple of distinct topology key-ids in play
    (meta.topo_keys). ``weights`` / ``enabled_filters``: the active
    profile's plugin config (None = reference defaults / all filters).
    ``ext_mask``/``ext_scores`` [P,N] (tensors on the batch's device):
    host-computed scheduler-extender feasibility veto and weighted score
    overlay (sched/extender.py) — the findNodesThatPassExtenders position
    in the cycle. ``plugins``: tuple of out-of-tree TensorPlugins
    (sched/framework.py) run inside this step — their filters AND into
    feasibility after the extender veto, their scores merge through the
    shared normalize pipeline ahead of the relational scores, as in the
    reference, so the float sum runs in the same order."""
    def _on(name):
        return enabled_filters is None or name in enabled_filters

    feasible = run_filters(ct, pb, enabled=enabled_filters)
    # the spread mask and the spread score count the same selectors: once
    spread_cnt = (topology.spread_count_pn(ct, pb)
                  if pb.sc_valid.shape[1] > 0 else None)
    if _on("PodTopologySpread"):
        feasible &= topology.spread_mask(ct, pb, topo_keys, cnt_pn=spread_cnt)
    if _on("InterPodAffinity"):
        feasible &= topology.interpod_required_mask(ct, pb, topo_keys)
        feasible &= topology.interpod_symmetry_mask(ct, pb, topo_keys)
    if ext_mask is not None:
        feasible &= ext_mask
    for plugin in plugins:
        if plugin.filter_fn is not None:
            feasible &= plugin.filter_fn(ct, pb, topo_keys)
    extra = {}
    score_plugins = [p for p in plugins if p.score_fn is not None]
    if score_plugins:
        # weight applies AFTER normalization, exactly like in-tree plugins;
        # plugin defaults sit UNDER the profile map so a profile's
        # scoreWeights override — including disable(0) — wins
        weights = {**{p.name: p.weight for p in score_plugins},
                   **(weights or {})}
    for plugin in score_plugins:
        extra[plugin.name] = (plugin.score_fn(ct, pb, topo_keys),
                              plugin.normalize, None)
    if pb.sc_valid.shape[1] > 0:
        extra["PodTopologySpread"] = (
            topology.spread_score_raw(ct, pb, topo_keys, cnt_pn=spread_cnt),
            "default_reverse",
            torch.any(pb.sc_valid & ~pb.sc_hard, dim=1))
    if pb.paff_valid.shape[1] > 0:
        extra["InterPodAffinity"] = (
            topology.interpod_score_raw(ct, pb, topo_keys), "minmax",
            torch.any(pb.paff_valid, dim=1))
    scores = combined_score(ct, pb, feasible, weights=weights, extra_raw=extra,
                            fit_strategy=fit_strategy)
    if ext_scores is not None:
        scores = torch.where(feasible, scores + ext_scores, scores)
    # tenant-local tie-break identity: arange(N) for single-tenant
    # clusters, the per-tenant rank under a fleet
    choice, has = select_host(scores, seed=seed,
                              node_rank=tenant_local_rank(ct))
    return StepResult(choice=choice.to(torch.int32),
                      assigned=has & torch.any(feasible, dim=-1),
                      feasible=feasible, scores=scores)


def schedule_step(ct: ClusterTensors, pb: PodBatch, seed: int = 0,
                  fit_strategy: str = "LeastAllocated",
                  topo_keys: tuple[int, ...] = ()) -> StepResult:
    """Single-shot evaluate (default weights)."""
    return evaluate(ct, pb, seed=seed, fit_strategy=fit_strategy,
                    topo_keys=topo_keys)
