"""Relational plugins: PodTopologySpread and InterPodAffinity.

The PyTorch port of ``kubernetes_tpu/ops/topology.py``. Reference semantics:
  PodTopologySpread  podtopologyspread/{common,filtering,scoring}.go
  InterPodAffinity   interpodaffinity/{filtering,scoring}.go (incl. the
                     existing-pod anti-affinity *symmetry* veto)

The counting factors into two steps:

    cnt_pn[P,T,N]  = matching existing pods per (pod, term) per node
                     (``count_pn``: a hand-written CUDA kernel on the card)
    cnt_dom[P,T,N] = cnt_pn x same_domain_k[N,N]      (contraction over N)

same_domain_k is per *distinct topology key* (zone, hostname, ...), a static
Python tuple; there are only ever a handful.

Namespace semantics: a term with no explicit namespaces applies to the
owning pod's own namespace; terms with ``namespaces``/``namespaceSelector``
carry an encode-time-resolved namespace-id mask (``*_ns_explicit`` +
``*_ns_mask`` — see encode/termprep.py), matched here by gather.

Spread eligibility: nodes failing the incoming pod's nodeSelector/nodeAffinity
(nodeAffinityPolicy=Honor, the default) or carrying untolerated taints
(nodeTaintsPolicy=Honor) are excluded from skew counts and the global
minimum. ``minDomains``: when fewer eligible domains exist, the global
minimum is 0 (filtering.go minMatchNum).
"""

from __future__ import annotations

import array
import contextlib
import ctypes
import functools
import os
from dataclasses import dataclass

import torch

from kubernetes_tpu_torch.encode.snapshot import ClusterTensors, PodBatch
from kubernetes_tpu_torch.ops import kernels
from kubernetes_tpu_torch.ops.exprs import eval_selector_set

# Above this node count the [N,N] same-domain matmuls are replaced by a
# FACTORED formulation — scatter-add per interned domain VALUE then gather
# back per node: O(P*T*(N+V)) memory instead of O(N^2).
# KTPU_DOMAIN_FACTORED=1/0 forces; unset = auto by threshold, a pure
# function of the node-bucket shape.
_FACTORED_THRESHOLD = 8192


def _use_factored(n_nodes: int) -> bool:
    flag = os.environ.get("KTPU_DOMAIN_FACTORED", "auto").lower()
    if flag in ("1", "true", "on"):
        return True
    if flag in ("0", "false", "off"):
        return False
    return n_nodes > _FACTORED_THRESHOLD


@contextlib.contextmanager
def _full_fp32():
    """Count products run in full float32: TF32 keeps 10 mantissa bits and
    would round counts above 2**11. Set here, at the call, and restored."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _count_einsum(eq, a, b):
    """einsum of 0/1 and integer-count float32 operands, exact below 2**24."""
    with _full_fp32():
        return torch.einsum(eq, a, b)


def _gather_ns(ns_mask, ids):
    """ns_mask [..., T, NSB] gathered at interned ids [M] -> [..., T, M]
    (False for out-of-range ids: they were interned after the mask was
    built, so no term's resolved set can contain them)."""
    NSB = ns_mask.shape[-1]
    hit = ns_mask[..., ids.clamp(0, NSB - 1).long()]
    return hit & ((ids >= 0) & (ids < NSB))


def _term_match_epods(ct: ClusterTensors, sel, pod_ns,
                      ns_explicit=None, ns_mask=None):
    """Selector match per (existing pod, pod, term) incl. namespace + validity.
    sel: SelectorSet with leading dims [P,T]. -> [E,P,T] float32."""
    m = eval_selector_set(sel, ct.epod_labels)               # [E,P,T]
    own_ok = ct.epod_ns[:, None] == pod_ns[None, :]          # [E,P]
    if ns_explicit is None:
        ns_ok = own_ok[:, :, None]
    else:
        exp = _gather_ns(ns_mask, ct.epod_ns)                # [P,T,E]
        exp = exp.movedim(2, 0)                              # [E,P,T]
        ns_ok = torch.where(ns_explicit[None], exp, own_ok[:, :, None])
    return (m & ns_ok & ct.epod_valid[:, None, None]).to(torch.float32)


def _self_ns_ok(pb: PodBatch, ns_explicit, ns_mask):
    """Does each pod's own namespace fall in its terms' namespace sets?
    -> [P,T] (True for implicit own-namespace terms)."""
    NSB = ns_mask.shape[-1]
    P, T = ns_explicit.shape
    idx = pb.pod_ns.clamp(0, NSB - 1).long()[:, None, None].expand(P, T, 1)
    hit = torch.gather(ns_mask, 2, idx)[..., 0]              # [P,T]
    hit = hit & ((pb.pod_ns >= 0) & (pb.pod_ns < NSB))[:, None]
    return torch.where(ns_explicit, hit, True)


def _count_pn_plain(ct: ClusterTensors, sel, pod_ns, ns_explicit=None,
                    ns_mask=None):
    """cnt_pn [P,T,N] f32, the reference's formulation: selector match
    [E,P,T] contracted against the node one-hot [E,N] in full float32. The
    CPU path of ``_count_pn`` and the yardstick its kernel is held to."""
    N = ct.node_valid.shape[0]
    match_ept = _term_match_epods(ct, sel, pod_ns, ns_explicit, ns_mask)
    nodes = torch.arange(N, device=ct.epod_node.device)
    onehot = (ct.epod_node[:, None] == nodes[None, :]).to(torch.float32)
    return _count_einsum("ept,en->ptn", match_ept, onehot)   # [P,T,N]


# Launch geometry of csrc/count_pn.cu, computed here so that the CPU tests
# can check it: a block owns ``pt_tile`` selectors and ``node_range`` nodes
# and keeps their counters in shared memory.
SMEM_PER_BLOCK = 232_448      # bytes of shared memory one Hopper block may use
GRID_X_MAX = 2**31 - 1
PT_TILES = (1, 2, 4, 8)       # the selector tiles count_pn.cu is built for
_SMS = 132                    # streaming multiprocessors of an H100
# The fastest geometry of ``chip_smoke.py --sweep`` at the path's shapes
# (every count_pn row of its kernels phase); count_pn_geometry starts here.
_PT_TILE, _NODE_RANGE, _THREADS = 2, 8192, 512


def _align16(n: int) -> int:
    return (n + 15) & ~15


def _smem_layout(pt_tile, node_range, X, V, NSB) -> int:
    """Dynamic shared-memory bytes of one block, region by region as
    count_pn.cu ``smem_layout`` lays them out (the launcher refuses a
    size that disagrees): counters, key, op, id sets, own namespace,
    validity, explicit flag, ns_mask."""
    regions = (pt_tile * node_range * 4,
               pt_tile * X * 4, pt_tile * X * 4, pt_tile * X * V * 4,
               pt_tile * 4, pt_tile, pt_tile, pt_tile * NSB)
    total = 0
    for size in regions:
        total = _align16(total + size)
    return total


@dataclass(frozen=True)
class CountPnGeometry:
    PT: int
    N: int
    pt_tile: int          # selectors per block, one of PT_TILES
    node_range: int       # nodes per block, a multiple of 4
    threads: int          # threads per block, a multiple of 32 up to 512
    smem_bytes: int       # dynamic shared memory per block

    @property
    def pt_tiles(self) -> int:
        return -(-self.PT // self.pt_tile)

    @property
    def n_ranges(self) -> int:
        return -(-self.N // self.node_range)

    @property
    def blocks(self) -> int:
        return self.pt_tiles * self.n_ranges

    def block_slice(self, b: int) -> tuple[int, int, int, int]:
        """(pt0, pt1, n0, n1): the selectors and nodes block ``b`` writes,
        derived from ``b`` as the kernel derives them."""
        pt0 = (b // self.n_ranges) * self.pt_tile
        n0 = (b % self.n_ranges) * self.node_range
        return (pt0, min(pt0 + self.pt_tile, self.PT),
                n0, min(n0 + self.node_range, self.N))


@functools.lru_cache(maxsize=256)
def count_pn_geometry(PT: int, N: int, X: int, V: int,
                      NSB: int) -> CountPnGeometry:
    """The launch geometry for cnt [PT, N]. From _PT_TILE, _NODE_RANGE and
    _THREADS: ``pt_tile`` is cut to PT and ``node_range`` to N, then
    ``node_range`` is halved (then ``pt_tile``) while a block's shared
    memory would exceed SMEM_PER_BLOCK, and ``pt_tile`` is halved while
    the grid would leave SMs idle. Raises ``kernels.KernelInputError`` (a
    ValueError) when one selector's staging alone does not fit or the grid
    exceeds its limit."""
    pt_tile = next(p for p in PT_TILES if p >= min(_PT_TILE, PT))
    node_range = min(_NODE_RANGE, -(-N // 4) * 4)
    while _smem_layout(pt_tile, node_range, X, V, NSB) > SMEM_PER_BLOCK:
        if node_range > 256:
            node_range = max(4, -(-(node_range // 2) // 4) * 4)
        elif pt_tile > 1:
            pt_tile //= 2
        else:
            raise kernels.KernelInputError(
                f"count_pn: one selector (X={X}, V={V}, NSB={NSB}) does not "
                f"fit a block's {SMEM_PER_BLOCK} bytes of shared memory")

    def geometry():
        return CountPnGeometry(PT, N, pt_tile, node_range, _THREADS,
                               _smem_layout(pt_tile, node_range, X, V, NSB))

    while pt_tile > 1 and geometry().blocks < _SMS:
        pt_tile //= 2
    g = geometry()
    if g.blocks > GRID_X_MAX:
        raise kernels.KernelInputError(
            f"count_pn: {g.blocks} blocks exceed the grid")
    return g


_INPUTS = ("epod_labels", "epod_node", "epod_ns", "epod_valid", "key", "op",
           "vals", "expr_valid", "valid", "pod_ns", "ns_explicit", "ns_mask")
_DTYPES = (torch.int32, torch.int32, torch.int32, torch.bool, torch.int32,
           torch.int32, torch.int32, torch.bool, torch.bool, torch.int32,
           torch.bool, torch.bool)
# count_pn.cu ``Args``: the input pointers in _INPUTS order, then these
_N_ARGS = len(_INPUTS) + 16   # cnt, stream, E, K, PT, T, X, V, NSB, N,
                              # pt_tile, node_range, n_ranges, blocks,
                              # threads, smem_bytes


def _refuse(name, t, dtype, shape, dev):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        why = f"is {t.dtype} {tuple(t.shape)}, expected {dtype} {tuple(shape)}"
    elif not t.is_cuda:
        why = f"is on {t.device}, not on the card"
    elif t.get_device() != dev:
        why = f"is on {t.device}, the other inputs on cuda:{dev}"
    else:
        why = "is not contiguous"
    raise kernels.KernelInputError(f"count_pn: {name} {why}")


def _count_pn_fn():
    fn = kernels.library("count_pn").count_pn_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        fn.restype = ctypes.c_int
    return fn


def count_pn(ct: ClusterTensors, sel, pod_ns, ns_explicit=None, ns_mask=None,
             geometry: CountPnGeometry | None = None):
    """cnt_pn [P,T,N] f32 through the CUDA kernel ``csrc/count_pn.cu``.
    Takes tensors on one card only; raises ``kernels.KernelInputError`` on
    anything the kernel does not take, and ``kernels.KernelError`` when
    the build or the launch fails. ``geometry`` overrides the default
    launch geometry (for tuning); its PT and N must be this call's."""
    labels = ct.epod_labels
    E, K = labels.shape
    P, T, X = sel.key.shape
    V = sel.vals.shape[3]
    N = ct.node_valid.shape[0]
    tensors = (labels, ct.epod_node, ct.epod_ns, ct.epod_valid, sel.key,
               sel.op, sel.vals, sel.expr_valid, sel.valid, pod_ns)
    shapes = ((E, K), (E,), (E,), (E,), (P, T, X), (P, T, X), (P, T, X, V),
              (P, T, X), (P, T), (P,))
    NSB = 0
    if ns_explicit is not None:
        NSB = ns_mask.shape[2]
        tensors += (ns_explicit, ns_mask)
        shapes += ((P, T), (P, T, NSB))
    dev = labels.get_device()
    for name, t, dtype, shape in zip(_INPUTS, tensors, _DTYPES, shapes):
        if (t.dtype != dtype or t.shape != shape or t.get_device() != dev
                or not t.is_contiguous()):
            _refuse(name, t, dtype, shape, dev)
    if dev < 0:
        _refuse("epod_labels", labels, torch.int32, (E, K), dev)
    cnt = torch.empty((P, T, N), dtype=torch.float32, device=labels.device)
    PT = P * T
    if PT * N == 0:
        return cnt
    g = geometry or count_pn_geometry(PT, N, X, V, NSB)
    if (g.PT, g.N) != (PT, N):
        raise kernels.KernelInputError(
            f"count_pn: geometry for {(g.PT, g.N)}, called with {(PT, N)}")
    args = array.array("q", [t.data_ptr() for t in tensors])
    if ns_explicit is None:
        args.extend((0, 0))
    args.extend((cnt.data_ptr(), torch._C._cuda_getCurrentRawStream(dev),
                 E, K, PT, T, X, V, NSB, N, g.pt_tile, g.node_range,
                 g.n_ranges, g.blocks, g.threads, g.smem_bytes))
    err = _count_pn_fn()(args.buffer_info()[0], _N_ARGS)
    if err != 0:
        raise kernels.KernelError(
            "count_pn launch failed: " + ("geometry disagrees with the "
            "kernel's shared-memory layout" if err == -1
            else f"CUDA error {err}"))
    kernels.LAUNCHES["count_pn"] += 1
    return cnt


def _count_pn(ct: ClusterTensors, sel, pod_ns, ns_explicit=None, ns_mask=None):
    """cnt_pn [P,T,N] f32: matching existing pods per (pod, term) per NODE,
    before domain aggregation. On the card this is the ``count_pn`` kernel;
    on the CPU it is the plain version."""
    if ct.epod_node.is_cuda:
        return count_pn(ct, sel, pod_ns, ns_explicit, ns_mask)
    return _count_pn_plain(ct, sel, pod_ns, ns_explicit, ns_mask)


def _domain_counts(ct: ClusterTensors, cnt_pn, term_topo, topo_keys,
                   elig=None, want_domains=False):
    """-> (cnt_dom [P,T,N] f32, node_has_key [P,T,N] bool,
           num_domains [P,T] f32 | None).

    cnt_dom[p,t,n] = # existing pods matching term (p,t) whose node shares
    node n's domain for the term's topology key (``cnt_pn`` [P,T,N] from
    ``_count_pn``). Nodes lacking the key have has_key False and count 0.
    ``elig`` [P,T,N] restricts which nodes' pods participate (spread
    node-inclusion policies); ``want_domains`` additionally counts distinct
    domains with >=1 eligible node.
    """
    N = ct.node_valid.shape[0]
    dev = cnt_pn.device
    if elig is not None:
        cnt_pn = cnt_pn * elig.to(torch.float32)
    cnt_dom = torch.zeros_like(cnt_pn)
    has_key = torch.zeros(cnt_pn.shape, dtype=torch.bool, device=dev)
    num_dom = (torch.zeros(cnt_pn.shape[:2], dtype=torch.float32, device=dev)
               if want_domains else None)
    K = ct.node_labels.shape[1]
    V = ct.label_value_num.shape[0]
    factored = _use_factored(int(N))
    idx_n = torch.arange(N, device=dev)
    for k in topo_keys:
        if k < 0 or k >= K:
            continue
        dv = ct.node_labels[:, k]                             # [N]
        present = dv >= 0
        sel = term_topo == k                                  # [P,T]
        dv_safe = dv.clamp(0, max(V - 1, 0)).long()
        if factored:
            # scatter per-VALUE, gather per node: O(P*T*(N+V)), no [N,N]
            src = cnt_pn * present[None, None, :].to(torch.float32)
            cnt_val = torch.zeros(cnt_pn.shape[:2] + (V,), dtype=torch.float32,
                                  device=dev).index_add_(2, dv_safe, src)
            agg = cnt_val[:, :, dv_safe] * present[None, None, :]
        else:
            same = ((dv[:, None] == dv[None, :])
                    & present[:, None] & present[None, :])
            agg = _count_einsum("ptn,nm->ptm", cnt_pn, same.to(torch.float32))
        cnt_dom = torch.where(sel[..., None], agg, cnt_dom)
        has_key = has_key | (sel[..., None] & present[None, None, :])
        if want_domains:
            ek = (present[None, None, :] if elig is None
                  else elig & present[None, None, :])         # [P,T,N]
            if factored:
                # distinct domains = distinct values hit by >=1 eligible node
                ek_f = ek.to(torch.float32).expand(cnt_pn.shape)
                hit = torch.zeros(cnt_pn.shape[:2] + (V,), dtype=torch.float32,
                                  device=dev).index_add_(2, dv_safe, ek_f)
                nd_k = torch.sum((hit > 0.0).to(torch.float32), dim=-1)
            else:
                # count nodes that are the FIRST eligible node of their
                # domain (no eligible same-domain predecessor)
                lower = (same & (idx_n[:, None] < idx_n[None, :])
                         ).to(torch.float32)
                ek_f = ek.to(torch.float32).expand(cnt_pn.shape)
                prior = _count_einsum("ptm,mn->ptn", ek_f, lower) > 0.0
                nd_k = torch.sum((ek & ~prior).to(torch.float32), dim=-1)
            num_dom = torch.where(sel, nd_k, num_dom)
    return cnt_dom, has_key, num_dom


# ------------------------------------------------------------------- spread

def _spread_policy_elig(ct: ClusterTensors, pb: PodBatch):
    """Per-constraint node participation [P,S,N]: valid nodes passing
    nodeAffinityPolicy (Honor default: pod's nodeSelector + required node
    affinity) and nodeTaintsPolicy (Honor: NoSchedule/NoExecute tolerated;
    Ignore default)."""
    from kubernetes_tpu_torch.ops.filters import (node_affinity_mask,
                                                  taint_toleration_mask,
                                                  tenant_pair_mask)
    na = node_affinity_mask(ct, pb)                           # [P,N]
    tt = taint_toleration_mask(ct, pb)                        # [P,N]
    ok = (~pb.sc_honor_affinity[..., None] | na[:, None, :])
    ok &= (~pb.sc_honor_taints[..., None] | tt[:, None, :])
    # fleet isolation: a sibling tenant's nodes neither count toward skew
    # nor anchor the global minimum / minDomains
    tmask = tenant_pair_mask(ct, pb)
    if tmask is not None:
        ok &= tmask[:, None, :]
    return ok & ct.node_valid[None, None, :]


def _diag_self_match(sel, pod_labels):
    """[P,T]: does pod p match its own term t? (the diagonal of
    eval_selector_set over all pods)."""
    m = eval_selector_set(sel, pod_labels)                    # [Pt,P,T]
    P = m.shape[0]
    ar = torch.arange(P, device=m.device)
    return m[ar, ar, :]


def spread_count_pn(ct: ClusterTensors, pb: PodBatch):
    """cnt_pn [P,S,N] of the spread constraints' selectors, the count that
    ``spread_mask`` and ``spread_score_raw`` both start from."""
    return _count_pn(ct, pb.sc_sel, pb.pod_ns)


def spread_mask(ct: ClusterTensors, pb: PodBatch, topo_keys: tuple[int, ...] = (),
                cnt_pn=None):
    """DoNotSchedule constraints: count(domain) + self - min(domain counts)
    must not exceed maxSkew; nodes lacking the topology key are infeasible.
    ``cnt_pn``: ``spread_count_pn(ct, pb)`` when the caller already has it."""
    if pb.sc_valid.shape[1] == 0:
        return torch.ones(tuple(pb.pod_valid.shape) + tuple(ct.node_valid.shape),
                          dtype=torch.bool, device=ct.node_valid.device)
    pol = _spread_policy_elig(ct, pb)                         # [P,S,N]
    if cnt_pn is None:
        cnt_pn = spread_count_pn(ct, pb)                      # [P,S,N]
    cnt, has_key, num_dom = _domain_counts(
        ct, cnt_pn, pb.sc_topo, topo_keys, elig=pol, want_domains=True)
    # does the pod match its own constraint selector? (it lands in the domain)
    self_match = _diag_self_match(pb.sc_sel, pb.pod_labels)   # [P,S]
    big = 3.4e38
    eligible = has_key & pol
    min_cnt = torch.amin(torch.where(eligible, cnt, big), dim=-1, keepdim=True)
    min_cnt = torch.where(torch.any(eligible, dim=-1, keepdim=True), min_cnt, 0.0)
    # minDomains (DoNotSchedule only): fewer eligible domains than required
    # -> global minimum treated as 0
    min_unmet = (pb.sc_min_domains > 0) & \
        (num_dom < pb.sc_min_domains.to(torch.float32))       # [P,S]
    min_cnt = torch.where(min_unmet[..., None], 0.0, min_cnt)
    skew = cnt + self_match[..., None].to(torch.float32) - min_cnt
    ok = has_key & (skew <= pb.sc_maxskew[..., None].to(torch.float32))
    active = (pb.sc_valid & pb.sc_hard)[..., None]            # soft/pad -> neutral
    return torch.all(ok | ~active, dim=1)                     # [P,N]


def spread_score_raw(ct: ClusterTensors, pb: PodBatch, topo_keys: tuple[int, ...] = (),
                     cnt_pn=None):
    """ScheduleAnyway constraints: raw = sum of matching counts in the node's
    domain (fewer is better; reverse-normalized by the caller). ``cnt_pn``:
    ``spread_count_pn(ct, pb)`` when the caller already has it."""
    P, N = pb.pod_valid.shape[0], ct.node_valid.shape[0]
    if pb.sc_valid.shape[1] == 0:
        return torch.zeros((P, N), dtype=torch.float32, device=ct.node_valid.device)
    pol = _spread_policy_elig(ct, pb)
    if cnt_pn is None:
        cnt_pn = spread_count_pn(ct, pb)
    cnt, has_key, _ = _domain_counts(ct, cnt_pn, pb.sc_topo, topo_keys,
                                     elig=pol)
    active = (pb.sc_valid & ~pb.sc_hard)[..., None]
    return torch.sum(torch.where(active & has_key, cnt, 0.0), dim=1)


# ------------------------------------------------------- inter-pod affinity

def interpod_required_mask(ct: ClusterTensors, pb: PodBatch,
                           topo_keys: tuple[int, ...] = ()):
    """Required affinity: every term needs >=1 matching existing pod in the
    node's domain. Required anti-affinity: no matching existing pod in the
    node's domain (nodes lacking the key satisfy anti trivially)."""
    P, N = pb.pod_valid.shape[0], ct.node_valid.shape[0]
    out = torch.ones((P, N), dtype=torch.bool, device=ct.node_valid.device)
    if pb.aff_valid.shape[1] > 0:
        cnt_pn = _count_pn(ct, pb.aff_sel, pb.pod_ns,
                           pb.aff_ns_explicit, pb.aff_ns_mask)
        cnt, has_key, _ = _domain_counts(ct, cnt_pn, pb.aff_topo, topo_keys)
        valid = pb.aff_valid[..., None]                         # [P,T,1]
        # filtering.go satisfyPodAffinity: every term's topology key must
        # exist on the node, unconditionally.
        has_all_keys = torch.all(has_key | ~valid, dim=1)       # [P,N]
        sat = torch.all((has_key & (cnt >= 1.0)) | ~valid, dim=1)
        # Bootstrap: only when NO term has a matching pair cluster-wide AND
        # the incoming pod matches ALL its own term selectors INCLUDING their
        # namespace sets (the first pod of a self-affine gang).
        self_match = _diag_self_match(pb.aff_sel, pb.pod_labels)  # [P,T]
        self_match &= _self_ns_ok(pb, pb.aff_ns_explicit, pb.aff_ns_mask)
        none_any_all = torch.all(~torch.any(cnt >= 1.0, dim=-1) | ~pb.aff_valid,
                                 dim=1)
        self_all = torch.all(self_match | ~pb.aff_valid, dim=1)
        bootstrap = none_any_all & self_all                     # [P]
        out &= has_all_keys & (sat | bootstrap[:, None])
    if pb.anti_valid.shape[1] > 0:
        cnt_pn = _count_pn(ct, pb.anti_sel, pb.pod_ns,
                           pb.anti_ns_explicit, pb.anti_ns_mask)
        cnt, has_key, _ = _domain_counts(ct, cnt_pn, pb.anti_topo, topo_keys)
        viol = has_key & (cnt >= 1.0)
        out &= torch.all(~viol | ~pb.anti_valid[..., None], dim=1)
    return out


def interpod_symmetry_mask(ct: ClusterTensors, pb: PodBatch,
                           topo_keys: tuple[int, ...] = ()):
    """Existing pods' required anti-affinity vetoes the newcomer: if existing
    pod e has an anti term whose selector matches the incoming pod (and the
    incoming pod's namespace is in the term's set — own ns or explicit) and
    node n shares e's domain for that term's key -> n infeasible
    (interpodaffinity/filtering.go existingPodAntiAffinityMap)."""
    P, N = pb.pod_valid.shape[0], ct.node_valid.shape[0]
    dev = ct.node_valid.device
    if ct.ea_valid.shape[1] == 0:
        return torch.ones((P, N), dtype=torch.bool, device=dev)
    # match of each existing anti term against incoming pods: [P,E,ET]
    m = eval_selector_set(ct.ea_sel, pb.pod_labels)           # [P,E,ET]
    own_ok = pb.pod_ns[:, None] == ct.epod_ns[None, :]        # [P,E]
    exp = _gather_ns(ct.ea_ns_mask, pb.pod_ns)                # [E,ET,P]
    exp = exp.movedim(2, 0)                                   # [P,E,ET]
    ns_ok = torch.where(ct.ea_ns_explicit[None], exp, own_ok[:, :, None])
    m = m & ns_ok & ct.epod_valid[None, :, None] & ct.ea_valid[None]
    veto = torch.zeros((P, N), dtype=torch.bool, device=dev)
    K = ct.node_labels.shape[1]
    V = ct.label_value_num.shape[0]
    factored = _use_factored(int(N))
    for k in topo_keys:
        if k < 0 or k >= K:
            continue
        dv = ct.node_labels[:, k]                             # [N]
        dv_e = dv[ct.epod_node.clamp(0, max(N - 1, 0)).long()]
        dv_e = torch.where(ct.epod_node >= 0, dv_e, -1)       # [E]
        wm = torch.any(m & (ct.ea_topo == k)[None], dim=-1)   # [P,E]
        if factored:
            # veto per VALUE then gather per node: no [E,N] materialization
            dve_safe = dv_e.clamp(0, max(V - 1, 0)).long()
            src = (wm & (dv_e >= 0)[None, :]).to(torch.float32)
            vv = torch.zeros((P, V), dtype=torch.float32, device=dev) \
                .index_add_(1, dve_safe, src)                 # [P,V]
            dv_safe = dv.clamp(0, max(V - 1, 0)).long()
            veto |= (vv[:, dv_safe] > 0.0) & (dv >= 0)[None, :]
        else:
            same = ((dv_e[:, None] == dv[None, :])
                    & (dv_e[:, None] >= 0))                   # [E,N]
            veto |= _count_einsum("pe,en->pn", wm.to(torch.float32),
                                  same.to(torch.float32)) > 0.0
    return ~veto


def interpod_score_raw(ct: ClusterTensors, pb: PodBatch,
                       topo_keys: tuple[int, ...] = ()):
    """Preferred (anti)affinity of the incoming pod: +/-weight per matching
    existing pod in the node's domain. -> raw [P,N] (min-max normalized later)."""
    P, N = pb.pod_valid.shape[0], ct.node_valid.shape[0]
    if pb.paff_valid.shape[1] == 0:
        return torch.zeros((P, N), dtype=torch.float32, device=ct.node_valid.device)
    cnt_pn = _count_pn(ct, pb.paff_sel, pb.pod_ns,
                       pb.paff_ns_explicit, pb.paff_ns_mask)
    cnt, has_key, _ = _domain_counts(ct, cnt_pn, pb.paff_topo, topo_keys)  # [P,C,N]
    w = torch.where(pb.paff_valid, pb.paff_weight, 0.0)[..., None]
    return torch.sum(torch.where(has_key, cnt, 0.0) * w, dim=1)
