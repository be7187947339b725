"""Expanders — pick one scale-up option among the viable groups.

Reference: ``cluster-autoscaler/expander/`` (``Strategy.BestOption``):
least-waste minimizes unused capacity on the nodes it would open, priority
honors a per-group rank, random breaks ties uniformly. All strategies here
filter to the best score first and tie-break deterministically from the
given seed (the reference nests random inside every strategy the same way).
The PyTorch port of ``kubernetes_tpu/autoscaler/expander.py``, unchanged.
"""

from __future__ import annotations

import random
from typing import Optional

from kubernetes_tpu_torch.autoscaler.simulator import ScaleUpOption


def _pick(options: list[ScaleUpOption], score, seed: int) -> ScaleUpOption:
    """Highest score wins; equal scores tie-break by seeded choice."""
    best = max(score(o) for o in options)
    tied = [o for o in options if score(o) == best]
    if len(tied) == 1:
        return tied[0]
    return random.Random(seed).choice(tied)


def least_waste(options: list[ScaleUpOption],
                seed: int = 0) -> Optional[ScaleUpOption]:
    """Most pods placed per unit of capacity opened (waste minimized)."""
    if not options:
        return None
    return _pick(options, lambda o: (-o.waste, o.pods_placed,
                                     -o.nodes_needed), seed)


def most_pods(options: list[ScaleUpOption],
              seed: int = 0) -> Optional[ScaleUpOption]:
    if not options:
        return None
    return _pick(options, lambda o: (o.pods_placed, -o.nodes_needed), seed)


def priority(options: list[ScaleUpOption],
             seed: int = 0) -> Optional[ScaleUpOption]:
    """Highest group priority wins; pods placed breaks priority ties."""
    if not options:
        return None
    return _pick(options, lambda o: (o.group.priority, o.pods_placed), seed)


def random_expander(options: list[ScaleUpOption],
                    seed: int = 0) -> Optional[ScaleUpOption]:
    if not options:
        return None
    return random.Random(seed).choice(options)


EXPANDERS = {
    "least-waste": least_waste,
    "most-pods": most_pods,
    "priority": priority,
    "random": random_expander,
}
