"""Device mesh + sharding of the scheduling tensors.

The PyTorch port of ``kubernetes_tpu/parallel/mesh.py``. The reference
scales the filter/score loop with 16 goroutines chunked over nodes
(framework/parallelize/parallelism.go); the TPU package shards a 2-D
``Mesh("pods", "nodes")`` and lets GSPMD insert the collectives. The port
keeps the mesh and the shardings, and makes the collectives explicit:

  node-major cluster tensors  -> split over the "nodes" axis: shard j owns
                                 the contiguous node range [n0, n1)
  pod-major batch tensors     -> split over the "pods" axis: shard i
                                 evaluates the pod rows [p0, p1)
  [P,N] intermediates         -> split over both
  existing pods, intern tables,
  nominees                    -> replicated (each shard its own copy)

**One process, several devices.** The port's scheduler is one threaded
process, as the reference is one JAX controller. A mesh is a (pods x
nodes) grid of ``torch.device``s, and ``run`` drives a function on every
shard at once, one thread per shard, each running the single-device code
on its own pieces. Where that code reduces across the node axis (the
normalize max and min, ``select_host``'s argmax and tie-break, the spread
minimum, the domain counts, the capacity read at a proposed node) or
needs every pod (the capacity accept and the [P,P] veto), it calls the
collectives below: ``reduce_nodes``, ``gather_nodes``, ``gather_pods``,
``argmin_nodes``. They are identities outside a shard, so the
single-device path runs the same code unchanged. A collective is a
rendezvous of the group's threads: each deposits its piece, and each
folds the pieces in shard order on its own device (a peer copy
``tensor.to(device)`` between cards, over NVLink; nothing to copy for
shards that share a device). Every reduction of the path is exact (max,
min, integer sums, and float32 sums of integer counts below 2**24), so a
sharded drain equals the single-device one bit for bit.

**Repeated devices.** A mesh may name one device several times (logical
shards): the CPU tests shard over ``cpu``, and ``chip_smoke.py`` over one
card. Such a mesh is built only from the caller's explicit device list
(``make_mesh(devices)``); ``mesh_from_shape`` counts real devices. Every
shard holds its own copy of what it writes in place (the resident
context's requested totals, the existing-pod slots), so shards that share
a device never alias one another's writes.

**Not captured.** A shard's rounds run eagerly: the collectives are host
rendezvous between threads, which a CUDA graph cannot hold. The graph key
names the mesh (``models/graphs.py``), and the mesh path never replays a
graph captured single-device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from kubernetes_tpu_torch.encode.snapshot import (ClusterTensors, PodBatch,
                                                  _Tensors)

AXES = ("pods", "nodes")

# The reference's node-major field set (``cluster_shardings``' node_dim).
NODE_DIM = frozenset({
    "allocatable", "requested", "node_valid", "unschedulable",
    "node_labels", "taint_key", "taint_val", "taint_effect", "taint_valid",
    "port_proto", "port_port", "port_ip", "port_valid", "node_images"})
# The port splits these [N]-leading fields too: a shard runs the
# single-device code on its pieces, so every node-major field must be its
# slice (the reference leaves them replicated and GSPMD reshards them).
PORT_NODE_DIM = NODE_DIM | frozenset({
    "used_rwo", "used_rwo_valid", "attach_used", "attach_limit"})

# bytes the collectives moved: through every exchange, and between two
# distinct devices (peer copies) -- the mesh's cost a drain
EXCHANGED_BYTES = 0
PEER_BYTES = 0
_COUNT_LOCK = threading.Lock()


class Mesh:
    """A (pods, nodes) grid of ``torch.device``s (``devices[i, j]``)."""

    axis_names = AXES

    def __init__(self, grid):
        arr = np.empty((len(grid), len(grid[0])), dtype=object)
        for i, row in enumerate(grid):
            if len(row) != arr.shape[1]:
                raise ValueError("a mesh's rows must be equally long")
            for j, d in enumerate(row):
                arr[i, j] = torch.device(d)
        self.devices = arr

    @property
    def shape(self) -> dict:
        return {"pods": int(self.devices.shape[0]),
                "nodes": int(self.devices.shape[1])}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_list(self) -> list:
        """The devices in row-major (shard) order."""
        return list(self.devices.reshape(-1))

    def distinct_devices(self) -> list:
        out = []
        for d in self.device_list():
            if d not in out:
                out.append(d)
        return out

    @property
    def lead(self) -> torch.device:
        return self.devices[0, 0]

    def describe(self) -> dict:
        """The mesh as ``publish_status`` and ``ktpu status`` show it."""
        return {"shape": self.shape, "devices": self.size,
                "deviceIds": [str(d) for d in self.device_list()]}

    def __repr__(self):
        return (f"Mesh({self.shape['pods']}x{self.shape['nodes']}, "
                f"{[str(d) for d in self.device_list()]})")


def _default_devices() -> list:
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(devices=None, pods_axis: int = 1) -> Mesh:
    """Build a ("pods", "nodes") mesh. With k devices, pods_axis x
    (k/pods_axis). ``devices`` may repeat a device (logical shards)."""
    devices = list(devices) if devices is not None else _default_devices()
    k = len(devices)
    while k % pods_axis:
        pods_axis -= 1
    n = k // pods_axis
    return Mesh([devices[i * n:(i + 1) * n] for i in range(pods_axis)])


def parse_mesh_shape(value) -> "tuple[int, int] | None":
    """Mesh-shape wire forms -> (pods_axis, nodes_axis) | None.

    Accepted: None/""/"off" (disabled), "PxN" / "P,N" strings (KTPU_MESH),
    a bare int/"N" (1 x N: node-axis only, the common single-host case),
    or a 2-sequence (YAML ``meshShape: [1, 2]``)."""
    if value is None:
        return None
    if isinstance(value, str):
        s = value.strip().lower()
        if s in ("", "0", "off", "none"):
            return None
        for sep in ("x", ","):
            if sep in s:
                p, n = s.split(sep, 1)
                return (int(p), int(n))
        return (1, int(s))
    if isinstance(value, int):
        return None if value <= 1 else (1, value)
    if len(value) != 2:
        raise ValueError(f"mesh shape must be (pods, nodes), got {value!r}")
    p, n = value
    return (int(p), int(n))


def mesh_from_shape(shape: tuple[int, int], devices=None) -> Mesh:
    """An EXACT (pods, nodes) mesh from the first pods*nodes devices -- the
    live scheduler's configured shape, unlike make_mesh's best-fit. With no
    ``devices``, the real ones (``torch.cuda.device_count()``). Raises
    ValueError when there are too few (callers decide whether that
    degrades to single-device or aborts)."""
    pods_axis, nodes_axis = int(shape[0]), int(shape[1])
    want = pods_axis * nodes_axis
    devices = list(devices) if devices is not None else (
        [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if torch.cuda.is_available() else [])
    if len(devices) < want:
        raise ValueError(
            f"mesh shape {pods_axis}x{nodes_axis} needs {want} devices, "
            f"backend has {len(devices)}")
    return make_mesh(devices[:want], pods_axis=pods_axis)


# ---- shardings ---------------------------------------------------------------

@dataclass(frozen=True)
class Sharding:
    """Where a leaf lives on a mesh: split on ``axis`` at ``dim``, or
    replicated (``axis`` None)."""
    axis: Optional[str] = None
    dim: int = 0


def replicated(mesh: Mesh) -> Sharding:
    """Fully replicated -- the drain's compact winners view (assignment rows
    and the fill scalar) is this: it ends up in one place, O(P) bytes."""
    return Sharding()


def _split_or_replicate(mesh: Mesh, leaf, axis_index: int,
                        axis_name: str) -> Sharding:
    """Split ``leaf`` on ``axis_name`` at ``axis_index`` -- or REPLICATE
    when the dim isn't divisible by the mesh axis (a bucket can shrink
    below the axis size: a scaled-down cluster's N=4 under a 1x8 mesh).
    Replication is always semantics-preserving: the mesh stays a
    throughput knob, never a crash."""
    size = mesh.shape[axis_name]
    if axis_index < leaf.ndim and leaf.shape[axis_index] % size == 0:
        return Sharding(axis_name, axis_index)
    return Sharding()


def _tree_map(fn, tree, path=()):
    if isinstance(tree, _Tensors):
        return tree.replace(**{
            f.name: _tree_map(fn, getattr(tree, f.name), path + (f.name,))
            for f in dataclasses.fields(tree)})
    return fn(path, tree)


def cluster_shardings(mesh: Mesh, ct: ClusterTensors) -> ClusterTensors:
    """Sharding tree for ClusterTensors: the node-leading fields
    (``PORT_NODE_DIM``) split on "nodes", the rest replicated. All node
    fields share N, so they split or replicate together."""
    return _tree_map(
        lambda path, leaf: (_split_or_replicate(mesh, leaf, 0, "nodes")
                            if len(path) == 1 and path[0] in PORT_NODE_DIM
                            else Sharding()), ct)


def batch_shardings(mesh: Mesh, pb: PodBatch) -> PodBatch:
    """Sharding tree for PodBatch: every pod-leading array splits on
    "pods"."""
    return _tree_map(lambda _p, leaf: _split_or_replicate(mesh, leaf, 0,
                                                          "pods"), pb)


def stack_shardings(mesh: Mesh, pb_stack: PodBatch) -> PodBatch:
    """Sharding tree for a STACKED drain batch [B,P,...]: the pod axis
    (axis 1) splits over "pods"; the scan axis B stays replicated (the
    drain runs its batches in order: capacity carries batch to batch)."""
    return _tree_map(lambda _p, leaf: _split_or_replicate(mesh, leaf, 1,
                                                          "pods"), pb_stack)


# ---- layouts: which rows each shard owns -------------------------------------

def _bounds(total: int, parts: int, split: bool) -> list:
    if not split:
        return [(0, total)] * parts
    w = total // parts
    return [(k * w, (k + 1) * w) for k in range(parts)]


@dataclass(frozen=True)
class Layout:
    """The rows of one sharded problem: N nodes split over "nodes" when
    the axis divides N, P pods over "pods" when it divides P."""
    mesh: Mesh
    N: int
    P: int

    @property
    def node_split(self) -> bool:
        n = self.mesh.shape["nodes"]
        return n > 1 and self.N % n == 0

    @property
    def pod_split(self) -> bool:
        p = self.mesh.shape["pods"]
        return p > 1 and self.P % p == 0

    def node_bounds(self) -> list:
        return _bounds(self.N, self.mesh.shape["nodes"], self.node_split)

    def pod_bounds(self) -> list:
        return _bounds(self.P, self.mesh.shape["pods"], self.pod_split)


def _node_piece(ct: ClusterTensors, shardings: ClusterTensors, n0: int,
                n1: int, device) -> ClusterTensors:
    """Shard ``[n0, n1)`` of ``ct`` on ``device`` (the leaves that
    ``shardings`` splits), every leaf a fresh copy: the shard writes it in
    place, and shards never alias one another."""
    specs = iter(_leaves(shardings))

    def piece(_path, leaf):
        t = torch.as_tensor(leaf)
        if next(specs).axis == "nodes":
            t = t[n0:n1]
        return t.to(device, copy=True)
    return _tree_map(piece, ct)


def _leaves(tree) -> list:
    if isinstance(tree, _Tensors):
        return [x for f in dataclasses.fields(tree)
                for x in _leaves(getattr(tree, f.name))]
    return [tree]


class ShardedCluster:
    """A cluster encoding split over a mesh: ``pieces[s]`` is shard s's
    (row-major) ClusterTensors, its node slice and its own copy of every
    replicated field. Replicated fields read through from shard 0
    (``ct.epod_labels``); a node-major field must be read with ``gather``,
    which assembles a full copy on the mesh's lead device -- a read, never
    the next drain's input (the folded state stays on its owner shards)."""

    def __init__(self, layout: Layout, pieces: list):
        self.layout = layout
        self.mesh = layout.mesh
        self.pieces = pieces

    def __getattr__(self, name):
        if name in PORT_NODE_DIM:
            raise AttributeError(
                f"{name} is split over the mesh: read it with gather()")
        return getattr(self.__dict__["pieces"][0], name)

    def gather(self) -> ClusterTensors:
        """A full ClusterTensors on the lead device (a copy)."""
        lead = self.mesh.lead
        n = self.mesh.shape["nodes"]
        row = self.pieces[:n]
        if not self.layout.node_split:
            return self.pieces[0].to(lead)

        def cat(path, leaf):
            if len(path) == 1 and path[0] in PORT_NODE_DIM:
                return torch.cat([getattr(p, path[0]).to(lead)
                                  for p in row])
            return leaf.to(lead)
        return _tree_map(cat, self.pieces[0])


def full_view(ct):
    """``ct`` itself, or a sharded cluster gathered (a read-only copy)."""
    return ct.gather() if isinstance(ct, ShardedCluster) else ct


def shard_cluster(mesh: Mesh, ct: ClusterTensors) -> ShardedCluster:
    """``ct`` (numpy or tensors) split over ``mesh`` by
    ``cluster_shardings``: one piece per shard, each on its device."""
    N = int(np.shape(ct.node_valid)[0])
    layout = Layout(mesh, N, 0)
    bounds = layout.node_bounds()
    n = mesh.shape["nodes"]
    shardings = cluster_shardings(mesh, ct)
    pieces = [_node_piece(ct, shardings, *bounds[s % n], d)
              for s, d in enumerate(mesh.device_list())]
    return ShardedCluster(layout, pieces)


def constrain_cluster(mesh: Mesh, ct: ShardedCluster) -> ShardedCluster:
    """The reference pins a drain's output to the cluster shardings so the
    next drain's input is never re-laid out. The port's folded state is
    written in place on its owner shards, so a drain's output IS its
    input: this checks that ``ct`` is laid out on ``mesh``."""
    if not isinstance(ct, ShardedCluster) or ct.mesh is not mesh:
        raise ValueError("the cluster is not sharded over this mesh")
    return ct


def shard_batch(mesh: Mesh, pb: PodBatch) -> dict:
    """``pb`` staged for ``mesh``: one copy on each distinct device
    ({device: PodBatch}). Every shard reads the whole batch (the capacity
    accept and the [P,P] veto run over it) and evaluates its own pod rows
    (``pod_rows``): the [P,N] work is what the "pods" axis splits."""
    return {d: pb.to(d) for d in mesh.distinct_devices()}


def presplit_stack(mesh: Mesh, pb_stack: PodBatch) -> dict:
    """The staging arena's upload of a STACKED drain batch [B,P,...] for
    ``mesh``: one copy on each distinct device, as ``shard_batch``."""
    return shard_batch(mesh, pb_stack)


def shard_drain(mesh: Mesh, ct_all: ClusterTensors, pb_stack: PodBatch):
    """Stage a fused-drain problem onto the mesh: the cluster split on
    "nodes", the stacked batches staged for every device."""
    return shard_cluster(mesh, ct_all), presplit_stack(mesh, pb_stack)


# ---- shards and their collectives ---------------------------------------------

class _Group:
    """The threads of one axis group (a mesh row or column) meeting at a
    collective: each deposits its piece, all read every piece."""

    def __init__(self, n: int):
        self.barrier = threading.Barrier(n)
        self.slots = [None] * n

    def exchange(self, pos: int, x) -> list:
        self.slots[pos] = x
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out


@dataclass
class Shard:
    """The shard a thread runs as: its place on the mesh, its rows, and
    the groups it meets in."""
    mesh: Mesh
    i: int
    j: int
    device: torch.device
    n0: int
    n1: int
    N: int
    p0: int
    p1: int
    P: int
    node_group: Optional[_Group]
    pod_group: Optional[_Group]

    @property
    def index(self) -> int:
        return self.i * self.mesh.shape["nodes"] + self.j

    @property
    def lead(self) -> bool:
        return self.i == 0 and self.j == 0


_TLS = threading.local()


def current() -> Optional[Shard]:
    """The shard this thread runs as, or None (single-device)."""
    return getattr(_TLS, "shard", None)


def is_lead() -> bool:
    s = current()
    return s is None or s.lead


def _fetch(x: torch.Tensor, device) -> torch.Tensor:
    global EXCHANGED_BYTES, PEER_BYTES
    nbytes = x.numel() * x.element_size()
    moved = x.device != device
    with _COUNT_LOCK:
        EXCHANGED_BYTES += nbytes
        if moved:
            PEER_BYTES += nbytes
    return x.to(device, non_blocking=True) if moved else x


def _exchange(group: _Group, pos: int, x: torch.Tensor) -> list:
    s = current()
    return [_fetch(v, s.device) for v in group.exchange(pos, x)]


_FOLD = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum,
         "any": torch.logical_or}


def _reduce(parts: list, op: str) -> torch.Tensor:
    out = parts[0]
    for p in parts[1:]:
        out = _FOLD[op](out, p)
    return out


def reduce_nodes(x: torch.Tensor, op: str) -> torch.Tensor:
    """``x`` (a shard's partial reduction over its nodes) combined over
    the node axis: ``op`` is "sum", "max", "min" or "any"."""
    s = current()
    if s is None or s.node_group is None:
        return x
    return _reduce(_exchange(s.node_group, s.j, x), op)


def reduce_pods(x: torch.Tensor, op: str) -> torch.Tensor:
    """``x`` combined over the pod axis (as ``reduce_nodes``)."""
    s = current()
    if s is None or s.pod_group is None:
        return x
    return _reduce(_exchange(s.pod_group, s.i, x), op)


def gather_nodes(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The shards' node slices of ``x`` along ``dim`` joined into the
    whole node axis."""
    s = current()
    if s is None or s.node_group is None:
        return x
    return torch.cat(_exchange(s.node_group, s.j, x), dim=dim)


def gather_pods(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The shards' pod rows of ``x`` along ``dim`` joined into the whole
    batch."""
    s = current()
    if s is None or s.pod_group is None:
        return x
    return torch.cat(_exchange(s.pod_group, s.i, x), dim=dim)


def nodes_split() -> bool:
    """True on a shard that holds a slice of the node axis."""
    s = current()
    return s is not None and s.node_group is not None


def n_global(n_local: int) -> int:
    """The whole node axis' length (``n_local`` outside a shard)."""
    s = current()
    return n_local if s is None else s.N


def node_ids(n_local: int, device) -> torch.Tensor:
    """The GLOBAL index of each local node: the tie-break identity and the
    row a choice names are the whole cluster's, never the shard's."""
    s = current()
    n0 = 0 if s is None else s.n0
    return torch.arange(n0, n0 + n_local, dtype=torch.int64, device=device)


def pod_ids(p_local: int, device) -> torch.Tensor:
    """The batch position of each local pod row (the tie-break salt)."""
    s = current()
    p0 = 0 if s is None else s.p0
    return torch.arange(p0, p0 + p_local, dtype=torch.int64, device=device)


def own_nodes(idx: torch.Tensor, n_local: int):
    """Global node ids -> (local rows clamped into [0, n_local), owned
    mask | None). Outside a shard the mask is None: every row is owned."""
    s = current()
    if s is None or s.node_group is None:
        return idx.clamp(0, max(n_local - 1, 0)).long(), None
    loc = idx.long() - s.n0
    own = (loc >= 0) & (loc < n_local)
    return loc.clamp(0, max(n_local - 1, 0)), own


def local_nodes(ids: torch.Tensor) -> torch.Tensor:
    """Global node ids in the shard's local numbering: an id outside
    ``[n0, n1)`` (or a -1 pad) becomes -1. ``count_pn`` takes the existing
    pods' ids so (a pod on another shard's node counts nowhere here, and
    the kernel keeps its arguments); a churn patch's node rows are routed
    to their owner shard so."""
    s = current()
    if s is None or s.node_group is None:
        return ids
    loc = torch.where(ids >= 0, ids - s.n0, torch.full_like(ids, -1))
    return torch.where((loc >= 0) & (loc < s.n1 - s.n0), loc,
                       torch.full_like(loc, -1))


def node_slice(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The shard's node slice of a whole-axis tensor."""
    s = current()
    if s is None or s.node_group is None:
        return x
    return x.narrow(dim, s.n0, s.n1 - s.n0)


def pod_rows(pb):
    """The shard's pod rows (views) of a whole batch ``pb``: a PodBatch or
    a tensor."""
    s = current()
    if s is None or s.pod_group is None:
        return pb
    if not isinstance(pb, _Tensors):
        return pb[s.p0:s.p1]
    return _tree_map(lambda _p, leaf: leaf[s.p0:s.p1], pb)


def argmin_nodes(key: torch.Tensor) -> torch.Tensor:
    """``torch.argmin(key, dim=-1)`` over the whole node axis, as GLOBAL
    node ids: each shard's (least key, global index) pair is combined so
    that ties resolve to the first occurrence, as on one device (keys are
    non-negative and below 2**31)."""
    local = torch.argmin(key, dim=-1)
    s = current()
    if s is None or s.node_group is None:
        return local
    best = torch.gather(key, -1, local[..., None])[..., 0].to(torch.int64)
    packed = (best << 32) | (local.to(torch.int64) + s.n0)
    return reduce_nodes(packed, "min") & 0xFFFFFFFF


# ---- running on every shard ----------------------------------------------------

@contextlib.contextmanager
def _as_shard(shard: Shard):
    _TLS.shard = shard
    try:
        if shard.device.type == "cuda":
            with torch.cuda.device(shard.device):
                yield
        else:
            yield
    finally:
        _TLS.shard = None


def run(layout: Layout, fn, args: list) -> list:
    """``fn(*args[s])`` on every shard s of ``layout.mesh`` at once, one
    thread each, in the shard's context -> the results in shard order.
    A shard's exception breaks every group's rendezvous, so no shard
    waits forever, and the first one is re-raised here as it was raised."""
    mesh = layout.mesh
    pa, na = mesh.shape["pods"], mesh.shape["nodes"]
    nb, pbounds = layout.node_bounds(), layout.pod_bounds()
    row_groups = [_Group(na) if layout.node_split else None
                  for _ in range(pa)]
    col_groups = [_Group(pa) if layout.pod_split else None
                  for _ in range(na)]
    shards = [Shard(mesh, i, j, mesh.devices[i, j], *nb[j], layout.N,
                    *pbounds[i], layout.P, row_groups[i], col_groups[j])
              for i in range(pa) for j in range(na)]
    results = [None] * len(shards)
    errors: list = []

    def body(s: Shard):
        try:
            with _as_shard(s):
                results[s.index] = fn(*args[s.index])
        except BaseException as e:  # noqa: BLE001 -- re-raised below
            errors.append((s.index, e))
            for g in row_groups + col_groups:
                if g is not None:
                    g.barrier.abort()

    if len(shards) == 1:
        with _as_shard(shards[0]):
            return [fn(*args[0])]
    cuda = any(d.type == "cuda" for d in mesh.device_list())
    prev = torch.backends.cuda.matmul.allow_tf32
    if cuda:
        # count products run in full float32 (ops/topology._full_fp32);
        # the flag is process-wide, so it is held off for the whole run
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        threads = [threading.Thread(target=body, args=(s,),
                                    name=f"mesh-shard-{s.i}-{s.j}",
                                    daemon=True) for s in shards]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        if cuda:
            torch.backends.cuda.matmul.allow_tf32 = prev
    if errors:
        first = [e for _, e in sorted(errors, key=lambda x: x[0])
                 if not isinstance(e, threading.BrokenBarrierError)]
        raise (first or [errors[0][1]])[0]
    return results
