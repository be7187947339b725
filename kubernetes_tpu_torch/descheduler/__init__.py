"""Descheduler — tensor-batched eviction planning and gang defragmentation.

The corrective half of the convergence loop: the scheduler/autoscaler grow
placements forward; churn and gang arrivals decay them; the descheduler
proposes eviction plans whose re-placement feasibility is proven by ONE
batched ``run_filters``/``run_scores`` simulation before anything moves.

The PyTorch port of ``kubernetes_tpu/descheduler``.
"""

from kubernetes_tpu_torch.descheduler.descheduler import (
    DEFAULT_STRATEGIES,
    GANG_LABEL,
    STATUS_CONFIGMAP,
    Descheduler,
    DeschedulerConfiguration,
)
from kubernetes_tpu_torch.descheduler.planner import (
    AcceptedSet,
    CandidateSet,
    EvictionPlan,
    GangDefragPlan,
    plan_evictions,
    plan_evictions_naive,
    plan_gang_defrag,
)
from kubernetes_tpu_torch.descheduler.strategies import (
    STRATEGY_BUILDERS,
    gang_consolidation_candidates,
    slice_defrag_candidates,
)

__all__ = [
    "AcceptedSet", "CandidateSet", "DEFAULT_STRATEGIES", "Descheduler",
    "DeschedulerConfiguration", "EvictionPlan", "GANG_LABEL",
    "GangDefragPlan", "STATUS_CONFIGMAP", "STRATEGY_BUILDERS",
    "gang_consolidation_candidates", "plan_evictions",
    "plan_evictions_naive", "plan_gang_defrag", "slice_defrag_candidates",
]
