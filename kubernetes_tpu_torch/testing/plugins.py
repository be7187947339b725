"""Two out-of-tree tensor plugins (sched/framework.py) for tests and the
card's smoke run: a filter that vetoes a fixed stripe of nodes by index,
and a score that prefers nodes whose cpu is already in use (bin packing,
against the default LeastAllocated spread). Both are torch ops only, so
they run inside the captured gang rounds; ``stripe_allows`` is the
filter's numpy copy, for checking placements on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetes_tpu_torch.encode.scaling import UNLIMITED
from kubernetes_tpu_torch.sched.framework import TensorPlugin

STRIPE_FILTER = "NodeStripeVeto"
CPU_PACKING_SCORE = "CpuPacking"
# cpu's column in the encoder's resource names (``meta.resources``): the
# encoder puts it first
CPU_INDEX = 0
# the score's weight: enough to steer placements off the default spread
CPU_PACKING_WEIGHT = 5.0


def stripe_allows(n_nodes: int, modulus: int) -> np.ndarray:
    """[N] bool: the nodes the stripe filter lets through (index % modulus
    != 0)."""
    return np.arange(n_nodes) % modulus != 0


def stripe_filter(modulus: int = 10) -> TensorPlugin:
    """Vetoes every node whose index is a multiple of ``modulus``."""

    def filter_fn(ct, pb, topo_keys):
        n = ct.node_valid.shape[0]
        allow = torch.arange(n, device=ct.node_valid.device) % modulus != 0
        return allow[None, :].expand(pb.pod_valid.shape[0], n)

    return TensorPlugin(name=STRIPE_FILTER, filter_fn=filter_fn)


def cpu_packing_score() -> TensorPlugin:
    """Raw score: the share of the node's cpu already requested. Padded
    rows, nodes with no cpu and UNLIMITED cpu score 0."""

    def score_fn(ct, pb, topo_keys):
        alloc = ct.allocatable[:, CPU_INDEX]
        used = ct.requested[:, CPU_INDEX].to(torch.float32)
        ok = ct.node_valid & (alloc > 0) & (alloc < UNLIMITED)
        share = torch.where(ok, used / torch.clamp(alloc, min=1).to(
            torch.float32), 0.0)
        return share[None, :].expand(pb.pod_valid.shape[0], -1)

    return TensorPlugin(name=CPU_PACKING_SCORE, score_fn=score_fn,
                        normalize="minmax", weight=CPU_PACKING_WEIGHT)


def smoke_plugins(modulus: int = 10) -> tuple:
    """The filter and the score, order-stable by name as
    ``Registry.tensor_plugins`` gives them."""
    return tuple(sorted((stripe_filter(modulus), cpu_packing_score()),
                        key=lambda p: p.name))
