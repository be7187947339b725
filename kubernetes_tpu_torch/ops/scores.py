"""Score terms — the in-tree Score plugins as additive [P,N] float tensors.

The PyTorch port of ``kubernetes_tpu/ops/scores.py``. Reference semantics
(pkg/scheduler/framework/plugins/):
  NodeResourcesFit/LeastAllocated   noderesources/least_allocated.go
  NodeResourcesBalancedAllocation   noderesources/balanced_allocation.go
  ImageLocality                     imagelocality/image_locality.go
  NodeAffinity (preferred)          nodeaffinity/node_affinity.go Score
  TaintToleration (PreferNoSchedule) tainttoleration/taint_toleration.go

Each plugin is one broadcasted tensor expression producing raw [P,N];
normalization is a max/min reduction over the node axis; the weighted sum
is one combine. All normalize helpers mask infeasible nodes out of the
reductions the same way the reference only scores feasible nodes.

On a device mesh (parallel/mesh.py) each shard scores its own node slice:
the reductions over the node axis (the image spread, the normalize max
and min, ``select_host``) combine the shards' partial results, all
exactly, and the tie-break identity is the GLOBAL node index.
"""

from __future__ import annotations

import torch

from kubernetes_tpu_torch.encode.scaling import UNLIMITED
from kubernetes_tpu_torch.encode.snapshot import ClusterTensors, PodBatch
from kubernetes_tpu_torch.ops.exprs import eval_term_set
from kubernetes_tpu_torch.ops.filters import (tenant_pair_mask,
                                              untolerated_prefer_count)
from kubernetes_tpu_torch.parallel import mesh

MAX_NODE_SCORE = 100.0

# ImageLocality constants (image_locality.go).
_MB = 1024.0 * 1024.0
IMG_MIN_THRESHOLD = 23.0 * _MB
IMG_MAX_CONTAINER_THRESHOLD = 1000.0 * _MB

# Reference default plugin weights (default_plugins.go).
DEFAULT_WEIGHTS = {
    "NodeResourcesFit": 1.0,
    "NodeResourcesBalancedAllocation": 1.0,
    "ImageLocality": 1.0,
    "NodeAffinity": 2.0,
    "TaintToleration": 3.0,
    "PodTopologySpread": 2.0,
    "InterPodAffinity": 2.0,
}

_U32 = 0xFFFFFFFF


def _cpu_mem_fractions(ct: ClusterTensors, pb: PodBatch):
    """Utilization fraction (requested+pod)/allocatable for cpu & memory -> [P,N,2].

    Resource axis positions 0,1 are always cpu,memory (encoder fixes the
    order). UNLIMITED/zero allocatable scores as fraction 0 (or 1 when the pod
    actually requests it), matching the oracle.
    """
    alloc_i = ct.allocatable[None, :, :2]
    alloc = alloc_i.to(torch.float32)                               # [1,N,2]
    used = (ct.requested[None, :, :2] + pb.requests[:, None, :2]).to(torch.float32)
    frac = used / torch.clamp(alloc, min=1.0)
    degenerate = (alloc_i <= 0) | (alloc_i >= UNLIMITED)
    requests_it = pb.requests[:, None, :2] > 0
    frac = torch.where(degenerate, requests_it.to(torch.float32), frac)
    return torch.clamp(frac, 0.0, 1.0)


def least_allocated(ct: ClusterTensors, pb: PodBatch):
    """mean over {cpu, memory} of 100 * (1 - fraction)."""
    frac = _cpu_mem_fractions(ct, pb)
    return torch.mean(MAX_NODE_SCORE * (1.0 - frac), dim=-1)


def most_allocated(ct: ClusterTensors, pb: PodBatch):
    """MostAllocated strategy (bin-packing): mean of 100 * fraction."""
    frac = _cpu_mem_fractions(ct, pb)
    return torch.mean(MAX_NODE_SCORE * frac, dim=-1)


def requested_to_capacity_ratio(ct: ClusterTensors, pb: PodBatch,
                                shape_x=(0.0, 1.0), shape_y=(0.0, 10.0)):
    """RequestedToCapacityRatio strategy: piecewise-linear bin-packing curve
    over utilization (requested_to_capacity_ratio.go). Default shape maps
    utilization 0->0, 1->10 (scaled to 0-100)."""
    frac = torch.mean(_cpu_mem_fractions(ct, pb), dim=-1)
    x0, x1 = shape_x
    y0, y1 = shape_y
    t = torch.clamp((frac - x0) / max(x1 - x0, 1e-9), 0.0, 1.0)
    return (y0 + t * (y1 - y0)) * (MAX_NODE_SCORE / max(y1, y0, 1e-9))


def balanced_allocation(ct: ClusterTensors, pb: PodBatch):
    """100 * (1 - std(fractions)) over {cpu, memory}."""
    frac = _cpu_mem_fractions(ct, pb)
    mean = torch.mean(frac, dim=-1, keepdim=True)
    std = torch.sqrt(torch.mean((frac - mean) ** 2, dim=-1))
    return MAX_NODE_SCORE * (1.0 - std)


def image_locality(ct: ClusterTensors, pb: PodBatch):
    """Threshold ramp over summed scaled sizes of pod images present on node.

    scaled size = size_bytes * (#nodes with image / #nodes). Under a fleet,
    "#nodes" means the POD'S TENANT'S nodes (the tenant visibility mask).
    """
    CI = pb.pod_images.shape[1]
    if CI == 0 or ct.node_images.shape[1] == 0:
        return torch.zeros(tuple(pb.pod_valid.shape) + tuple(ct.node_valid.shape),
                           dtype=torch.float32, device=ct.node_valid.device)
    pod_img = pb.pod_images[:, :, None, None]              # [P,CI,1,1]
    node_img = ct.node_images[None, None, :, :]            # [1,1,N,I]
    present = torch.any((pod_img == node_img) & (pod_img >= 0), dim=-1)  # [P,CI,N]
    tmask = tenant_pair_mask(ct, pb)
    visible = (ct.node_valid[None, :] if tmask is None
               else ct.node_valid[None, :] & tmask)        # [P,N] (or [1,N])
    # integer counts over the node axis, summed across shards before the
    # float cast
    num_with = mesh.reduce_nodes(torch.sum(present & visible[:, None, :],
                                           dim=-1, keepdim=True),
                                 "sum").to(torch.float32)                # [P,CI,1]
    total = torch.clamp(mesh.reduce_nodes(torch.sum(visible, dim=-1), "sum")
                        .to(torch.float32), min=1.0)[:, None, None]      # [P,1,1]
    IMG = ct.image_sizes.shape[0]
    sizes = ct.image_sizes[pb.pod_images.clamp(0, max(IMG - 1, 0)).long()]  # [P,CI]
    sizes = torch.where(pb.pod_images >= 0, sizes, 0.0)
    ssum = torch.sum(present * sizes[:, :, None] * (num_with / total), dim=1)  # [P,N]
    n_images = torch.sum(pb.pod_images >= 0, dim=1).to(torch.float32)      # [P]
    max_thr = IMG_MAX_CONTAINER_THRESHOLD * torch.clamp(n_images, min=1.0)
    val = (ssum - IMG_MIN_THRESHOLD) / (max_thr[:, None] - IMG_MIN_THRESHOLD)
    return torch.clamp(val, 0.0, 1.0) * MAX_NODE_SCORE


def node_affinity_preferred_raw(ct: ClusterTensors, pb: PodBatch):
    """Raw sum of matching preferred-term weights [P,N] (normalized later)."""
    term = eval_term_set(pb.pref_terms, ct.node_labels, ct.label_value_num)  # [N,P,T]
    return torch.sum(torch.where(term, pb.pref_terms.weight[None], 0.0), dim=-1).T


def taint_toleration_raw(ct: ClusterTensors, pb: PodBatch):
    """Raw count of intolerable PreferNoSchedule taints [P,N] (reverse-normalized)."""
    return untolerated_prefer_count(ct, pb)


def default_normalize(raw, feasible, reverse: bool):
    """helper.DefaultNormalizeScore over the node axis, feasible nodes only.
    max==0: the reference gives all-100 when reversed, all-0 otherwise."""
    masked = torch.where(feasible, raw, 0.0)
    mx = mesh.reduce_nodes(torch.amax(masked, dim=-1, keepdim=True), "max")
    safe = torch.clamp(mx, min=1e-9)
    s = raw * MAX_NODE_SCORE / safe
    s = torch.where(mx > 0, s, 0.0)
    out = MAX_NODE_SCORE - s if reverse else s
    return torch.where(mx > 0, out, MAX_NODE_SCORE if reverse else 0.0)


def minmax_normalize(raw, feasible):
    """InterPodAffinity-style min-max normalize to 0-100 over feasible nodes."""
    big = 3.4e38
    mn = mesh.reduce_nodes(torch.amin(torch.where(feasible, raw, big),
                                      dim=-1, keepdim=True), "min")
    mx = mesh.reduce_nodes(torch.amax(torch.where(feasible, raw, -big),
                                      dim=-1, keepdim=True), "max")
    diff = mx - mn
    out = (raw - mn) * MAX_NODE_SCORE / torch.clamp(diff, min=1e-9)
    return torch.where(diff > 0, out, 0.0)


def combined_score(ct: ClusterTensors, pb: PodBatch, feasible, weights=None,
                   extra_raw=None, fit_strategy: str = "LeastAllocated"):
    """Weighted sum of normalized plugin scores [P,N]; -inf on infeasible.

    ``extra_raw``: dict name -> (raw [P,N], normalize_kind, active [P] | None)
    for relational plugins computed elsewhere (spread / inter-pod affinity),
    normalize_kind in {"default", "default_reverse", "minmax"}. ``active``
    marks pods whose PreScore would NOT skip — inactive pods contribute 0
    (the reference skips the plugin entirely, so no normalized floor).
    """
    w = dict(DEFAULT_WEIGHTS)
    if weights:
        w.update(weights)
    fit_fn = {"LeastAllocated": least_allocated, "MostAllocated": most_allocated,
              "RequestedToCapacityRatio": requested_to_capacity_ratio}[fit_strategy]
    total = torch.zeros(feasible.shape, dtype=torch.float32, device=feasible.device)
    if w.get("NodeResourcesFit"):
        total += w["NodeResourcesFit"] * fit_fn(ct, pb)
    if w.get("NodeResourcesBalancedAllocation"):
        total += w["NodeResourcesBalancedAllocation"] * balanced_allocation(ct, pb)
    if w.get("ImageLocality"):
        total += w["ImageLocality"] * image_locality(ct, pb)
    if w.get("NodeAffinity"):
        raw = node_affinity_preferred_raw(ct, pb)
        total += w["NodeAffinity"] * default_normalize(raw, feasible, reverse=False)
    if w.get("TaintToleration"):
        raw = taint_toleration_raw(ct, pb)
        total += w["TaintToleration"] * default_normalize(raw, feasible, reverse=True)
    for name, (raw, kind, active) in (extra_raw or {}).items():
        if not w.get(name):
            continue
        if kind == "default":
            s = default_normalize(raw, feasible, reverse=False)
        elif kind == "default_reverse":
            s = default_normalize(raw, feasible, reverse=True)
        else:
            s = minmax_normalize(raw, feasible)
        if active is not None:
            s = torch.where(active[:, None], s, 0.0)
        total += w[name] * s
    return torch.where(feasible, total, float("-inf"))


def _mul_u32(a, c: int):
    """(a * c) mod 2**32 for int64 ``a`` in [0, 2**32) and a constant
    ``c`` < 2**32, without overflowing int64: split c into 16-bit halves."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def select_host(scores, seed: int = 0, node_rank=None):
    """argmax with seeded deterministic tie-break -> (node idx [P], has_node [P]).

    Matches oracle.tie_break exactly; the salt varies per batch position so
    equal-score pods spread across tied nodes instead of piling onto one.
    The reference hashes in uint32; torch has no uint32 arithmetic on the
    CPU, so the hash runs in int64 masked to 32 bits after every step.

    ``node_rank`` [N] int32: the tie-break identity per node — by default
    the node's index, under a fleet its TENANT-LOCAL rank
    (ops/filters.tenant_local_rank).

    On a mesh shard: the identity is the node's GLOBAL index (or its
    global rank), the salt the pod's batch position, and the (least key,
    first index) pair is combined across shards, so the choice (a global
    node id) is the single-device one. Keys are 30-bit and can tie.
    """
    P, N = scores.shape
    dev = scores.device
    has = mesh.reduce_nodes(torch.any(torch.isfinite(scores), dim=-1), "any")
    best = mesh.reduce_nodes(torch.amax(scores, dim=-1, keepdim=True), "max")
    is_best = scores == best
    pos = mesh.pod_ids(P, dev)
    salt = _mul_u32(((seed & _U32) + pos) & _U32, 2246822519)
    ident = (mesh.node_ids(N, dev) if node_rank is None
             else node_rank.to(torch.int64) & _U32)
    tb = (_mul_u32(ident, 2654435761)[None, :] ^ salt[:, None]) & 0x3FFFFFFF
    key = torch.where(is_best, tb, 0x7FFFFFFF)
    choice = mesh.argmin_nodes(key)
    return choice, has
