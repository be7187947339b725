"""The slice carver — contiguous ICI sub-slice placement as one batched
pass over the cluster encoding.

The PyTorch port of ``kubernetes_tpu/topology/carve.py``: an XLA program
in the reference, plain torch ops on an explicit device here (the
reference's docstring records a hand kernel of this pass at 120x slower
than the fused form; it becomes one only if a card run shows it hot).

The feasibility grid is DERIVED, not stored: node coordinates ride the
pre-interned ``kubernetes-tpu.io/topology-{x,y,z}`` label columns of
``ClusterTensors`` (encode/snapshot.py), so the scatter into the dense
[X,Y,Z] occupancy grid happens inside the pass and node churn keeps it
current through the existing patch path.

One ``carve_step`` call evaluates, for a requested shape, EVERY
wrap-around torus origin x EVERY axis-order rotation at once:

  - per-node ``free`` (valid, on-grid, schedulable, tenant-visible,
    capacity fits one member, not claimed by an earlier gang this cycle)
    scatters to the free grid;
  - a separable box-sum (``sum_i roll(g, -i, axis)`` per axis — wrap-around
    is free on a torus) turns the grid into per-origin slice-fit counts;
    ``count == a*b*c`` IS the slice-fit score plane;
  - the SAME box-sum over the bound-occupancy grid (existing-pod counts,
    infinity where a cell can never host) is the
    "fewest-evictions-to-free-a-slice" plane that slice preemption reads.

Where the port differs from the reference:

- ``.at[flat].max(..., mode="drop")`` has no torch form: off-grid rows
  scatter into one extra slot of an ``X*Y*Z + 1`` buffer
  (``scatter_reduce_`` "amax"), which is sliced off.
- XLA's float -> int32 conversion saturates; torch's is undefined out of
  range on the CPU (a coordinate label of 1e10 casts to INT_MIN there), so
  the parsed coordinate is clamped to the int32 range before the cast.

Host-side selection is deliberately tiny (argmax/argmin over the read-back
grids) and shared, ORDER AND ALL, with the numpy twin ``numpy_grids`` —
the bit-parity contract the oracle carver (sched/oracle.py) and the
ParitySentinel carve site build on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from kubernetes_tpu_torch.encode.snapshot import (
    TENANT_KEY_ID,
    TOPO_X_KEY_ID,
    TOPO_Y_KEY_ID,
    TOPO_Z_KEY_ID,
    ClusterTensors,
)
from kubernetes_tpu_torch.topology.slicing import box_cells, rotations

# the largest float32 below 2**31: a saturating float -> int32 cast
_I32_MAX_F = 2147483520.0


@dataclass
class CarveResult:
    """Read-back of one carve call (device or numpy twin — identical
    layout, identical selection semantics)."""

    fits: np.ndarray       # [R?,X,Y,Z] bool: origin hosts the whole slice
    cost: np.ndarray       # [R?,X,Y,Z] float32: evictions to free it (inf = never)
    node_grid: np.ndarray  # [X,Y,Z] int32 node index, -1 = no node at cell
    free_grid: np.ndarray  # [X,Y,Z] bool
    rots: tuple            # rotation r -> (a, b, c) extents
    dims: tuple            # grid extents (X, Y, Z)
    shape: tuple           # requested shape as labelled


def _box_sum(g, rot):
    """Separable wrap-around box sum: S[o] = sum over the rot-shaped box
    anchored at o. One roll per unit of extent; wrap-around is what
    ``torch.roll``/``np.roll`` do natively, so the torus costs nothing."""
    is_t = isinstance(g, torch.Tensor)
    for ax, d in enumerate(rot):
        acc = g
        for i in range(1, d):
            acc = acc + (torch.roll(g, -i, dims=ax) if is_t
                         else np.roll(g, -i, axis=ax))
        g = acc
    return g


def carve_step(ct: ClusterTensors, member_req, pod_tenant, claimed,
               dims: tuple, rots: tuple):
    """-> (fits [R,X,Y,Z] bool, cost [R,X,Y,Z] f32, node_grid [X,Y,Z] i32,
    free_grid [X,Y,Z] bool), on the device of ``ct``'s tensors.
    ``member_req`` [R] int32, ``claimed`` [N] bool (tensors there, or
    host arrays copied in), ``pod_tenant`` an int value id; ``dims`` the
    grid extents and ``rots`` the (already dims-filtered) rotations."""
    dev = ct.node_valid.device
    X, Y, Z = dims
    N = ct.node_valid.shape[0]
    K = ct.node_labels.shape[1]
    V = ct.label_value_num.shape[0]
    member_req = torch.as_tensor(member_req, device=dev)
    claimed = torch.as_tensor(claimed, dtype=torch.bool, device=dev)

    def coord(kid):
        # label-column coordinate: value-id -> numeric parse via the
        # label_value_num plane (churn patches already ship it)
        vid = ct.node_labels[:, kid]
        val = ct.label_value_num[vid.clamp(0, V - 1).long()]
        ok = (vid >= 0) & ~torch.isnan(val) & (val >= 0)
        val = torch.where(ok, val, torch.full_like(val, -1.0))
        return val.clamp(max=_I32_MAX_F).to(torch.int32), ok

    if K > TOPO_Z_KEY_ID:
        x, okx = coord(TOPO_X_KEY_ID)
        y, oky = coord(TOPO_Y_KEY_ID)
        z, okz = coord(TOPO_Z_KEY_ID)
        on_grid = (okx & oky & okz & (x < X) & (y < Y) & (z < Z)
                   & ct.node_valid)
    else:
        # hand-built tensors predating the topology columns: no grid
        x = y = z = torch.zeros(N, dtype=torch.int32, device=dev)
        on_grid = torch.zeros(N, dtype=torch.bool, device=dev)
    if K > TENANT_KEY_ID:
        visible = ct.node_labels[:, TENANT_KEY_ID] == pod_tenant
    else:
        visible = torch.ones(N, dtype=torch.bool, device=dev)

    free_cap = torch.all(member_req[None, :] <= ct.allocatable - ct.requested,
                         dim=-1)
    alone_cap = torch.all(member_req[None, :] <= ct.allocatable, dim=-1)
    usable = on_grid & visible & ~ct.unschedulable & ~claimed
    free = usable & free_cap
    evictable = usable & alone_cap

    # cell -> node: flat scatter, HIGHEST node index wins a duplicated
    # coordinate (deterministic; the numpy twin iterates ascending so its
    # last write is the same winner). Off-grid rows land in the extra last
    # slot, which is dropped.
    n_cells = X * Y * Z
    flat = torch.where(on_grid, (x * Y + y) * Z + z,
                       torch.full_like(x, n_cells))
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    grid = torch.full((n_cells + 1,), -1, dtype=torch.int32, device=dev)
    grid.scatter_reduce_(0, flat.long(),
                         torch.where(on_grid, idx, torch.full_like(idx, -1)),
                         "amax", include_self=True)
    node_grid = grid[:n_cells].reshape(X, Y, Z)
    in_t = node_grid >= 0
    gi = node_grid.clamp(min=0).long()
    free_grid = in_t & free[gi]

    # bound-occupancy plane: existing pods per node (epod slots are the
    # encoder's bound set; pending/pad slots are invalid and weigh 0).
    # Integer counts in float32: exact below 2**24 in any order.
    pods_on = torch.zeros(N, dtype=torch.float32, device=dev).index_add_(
        0, ct.epod_node.clamp(0, N - 1).long(),
        ct.epod_valid.to(torch.float32))
    cell_cost = torch.where(
        in_t & evictable[gi],
        torch.where(free_grid, torch.zeros((), device=dev), pods_on[gi]),
        torch.full((), float("inf"), device=dev))

    fits, costs = [], []
    free_i = free_grid.to(torch.int32)
    for rot in rots:
        want = rot[0] * rot[1] * rot[2]
        fits.append(_box_sum(free_i, rot) == want)
        costs.append(_box_sum(cell_cost, rot))
    return torch.stack(fits), torch.stack(costs), node_grid, free_grid


def _read_back(tensors) -> list[np.ndarray]:
    """The planes on the host with ONE wait: non-blocking copies into
    pinned buffers, then one synchronize of the stream."""
    dev = tensors[0].device
    if dev.type != "cuda":
        return [t.numpy() for t in tensors]
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(dev).synchronize()
    return [h.numpy() for h in host]


def carve_device(ct: ClusterTensors, member_req, pod_tenant: int, claimed,
                 dims: tuple, shape: tuple) -> Optional[CarveResult]:
    """Run one carve on ``ct``'s device and read the four planes back. None
    when no rotation of ``shape`` fits ``dims`` at all (the shape can NEVER
    be carved on this torus — a static verdict, no device needed)."""
    rots = rotations(shape, dims)
    if not rots:
        return None
    dev = ct.node_valid.device
    fits, cost, node_grid, free_grid = _read_back(carve_step(
        ct, torch.from_numpy(np.ascontiguousarray(member_req)).to(dev),
        int(pod_tenant),
        torch.from_numpy(np.ascontiguousarray(claimed, bool)).to(dev),
        dims=dims, rots=rots))
    return CarveResult(fits=fits, cost=cost, node_grid=node_grid,
                       free_grid=free_grid, rots=rots, dims=dims,
                       shape=shape)


def numpy_grids(coords: list, free: list, evictable: list, n_pods: list,
                dims: tuple, shape: tuple) -> Optional[CarveResult]:
    """The carver's numpy twin over per-node host verdicts: ``coords[i]``
    is node i's (x, y, z) or None, ``free``/``evictable``/``n_pods`` its
    host-judged cell state. Same max-wins scatter, same roll-based box
    sums, same rotation order — bit-equal planes to ``carve_step`` by
    construction, asserted by the parity tests and the sentinel."""
    rots = rotations(shape, dims)
    if not rots:
        return None
    node_grid = np.full(dims, -1, np.int32)
    for i, c in enumerate(coords):
        if c is None or not all(0 <= v < d for v, d in zip(c, dims)):
            continue
        node_grid[c] = i  # ascending i: last write == max-wins
    in_t = node_grid >= 0
    gi = np.clip(node_grid, 0, None)
    free_grid = np.where(in_t, np.asarray(free, bool)[gi], False)
    evict_grid = np.where(in_t, np.asarray(evictable, bool)[gi], False)
    cell_cost = np.where(
        evict_grid,
        np.where(free_grid, 0.0, np.asarray(n_pods, np.float32)[gi]),
        np.inf).astype(np.float32)
    fits = np.stack([
        _box_sum(free_grid.astype(np.int32), rot) == rot[0] * rot[1] * rot[2]
        for rot in rots])
    cost = np.stack([_box_sum(cell_cost, rot) for rot in rots])
    return CarveResult(fits=fits, cost=cost, node_grid=node_grid,
                       free_grid=free_grid, rots=rots, dims=dims,
                       shape=shape)


# ---- host-side selection (shared by device and twin paths) ----------------

def select_assignment(res: Optional[CarveResult]
                      ) -> Optional[list[int]]:
    """First-fit origin in flat (rotation, x, y, z) order -> the member ->
    node-index assignment (C-order box cells, slicing.box_cells). None
    when no origin hosts the slice."""
    if res is None or res.fits.size == 0:
        return None
    flat = res.fits.reshape(-1)
    i = int(np.argmax(flat))  # argmax over bool = FIRST True
    if not flat[i]:
        return None
    r, ox, oy, oz = np.unravel_index(i, res.fits.shape)
    return [int(res.node_grid[c])
            for c in box_cells((int(ox), int(oy), int(oz)),
                               res.rots[r], res.dims)]


def select_eviction(res: Optional[CarveResult]
                    ) -> Optional[tuple[list[int], list[tuple], float]]:
    """Cheapest contiguous victim set: the finite-minimum origin of the
    eviction plane (first minimum in flat order) -> (node indices of the
    slice's cells, the cells themselves, total eviction cost). None when
    no origin can EVER host the slice (an unusable cell in every box)."""
    if res is None or res.cost.size == 0:
        return None
    flat = res.cost.reshape(-1)
    i = int(np.argmin(flat))  # first minimum in flat order
    if not np.isfinite(flat[i]):
        return None
    r, ox, oy, oz = np.unravel_index(i, res.cost.shape)
    cells = box_cells((int(ox), int(oy), int(oz)), res.rots[r], res.dims)
    nodes = [int(res.node_grid[c]) for c in cells]
    return nodes, cells, float(flat[i])


def _covered_grid(res: CarveResult) -> np.ndarray:
    """[X,Y,Z] bool: cell belongs to SOME carveable placement of the shape
    (any rotation, any fitting origin)."""
    covered = np.zeros(res.dims, bool)
    for r, rot in enumerate(res.rots):
        f = res.fits[r]
        for cell in box_cells((0, 0, 0), rot, res.dims):
            covered |= np.roll(f, cell, axis=(0, 1, 2))
    return covered


def covered_nodes(res: Optional[CarveResult], n_nodes: int) -> list[bool]:
    """Per-node verdict "this node sits inside some carveable placement" —
    the oracle explainer's SliceCarve filter plane (a node outside every
    placement can never host a member of the requested slice as things
    stand)."""
    out = [False] * n_nodes
    if res is None:
        return out
    covered = _covered_grid(res)
    for cell in np.argwhere(covered):
        ni = int(res.node_grid[tuple(cell)])
        if 0 <= ni < n_nodes:
            out[ni] = True
    return out


def coverage_stats(res: Optional[CarveResult]) -> dict:
    """Status-surface numbers for one shape: carveable origin count and
    fragmentation % — the share of free cells that sit in NO carveable
    placement of the shape (100% = plenty of free nodes, none of them
    composable into a slice; 0% = every free cell is part of some fit)."""
    if res is None:
        return {"origins": 0, "fragmentationPct": None}
    covered = _covered_grid(res)
    n_free = int(res.free_grid.sum())
    frag = (100.0 * (1.0 - int((covered & res.free_grid).sum()) / n_free)
            if n_free else 0.0)
    return {"origins": int(res.fits.sum()),
            "fragmentationPct": round(float(frag), 1)}
