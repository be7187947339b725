"""Slice-shape vocabulary — the host half of topology-aware carving.

A TPU fleet's gangs do not want "N feasible nodes"; they want a CONTIGUOUS
sub-slice of the ICI torus (2x2x1, 2x2x4, ...) so ring collectives never
leave the wrap-around mesh. This module owns the shape vocabulary every
other layer speaks:

  - nodes advertise their torus coordinate via the
    ``kubernetes-tpu.io/topology-{x,y,z}`` labels (pre-interned in
    encode/snapshot.py, so the coordinate planes ride the label COLUMNS of
    the resident encoding and churn patches update them with no new
    dispatch);
  - gangs request a shape via ``kubernetes-tpu.io/slice-shape: "2x2x4"``
    (or a slice-shaped ResourceClaim — sched/dra.py routes those here);
  - ``rotations`` enumerates the distinct axis-order orientations a shape
    can land in, filtered to those that fit the grid without a
    wrap-around cell counting twice;
  - ``is_contiguous_slice`` is the audit-side truth predicate (torus
    box under some rotation + wrap-around), shared by the
    ``slice_contiguity`` invariant and the bench gates.

Everything here is deliberately numpy/stdlib-only: the device carver
(topology/carve.py) and its numpy oracle twin both import THIS vocabulary,
which is what keeps their bit-parity honest.
"""

from __future__ import annotations

from itertools import permutations
from typing import Optional

# Label a gang (or claim) requests its slice shape with. The gang identity
# label is owned by descheduler/strategies.py; re-declared here (same
# convention as audit/invariants.py) to avoid a low-level package importing
# the descheduler.
SLICE_SHAPE_LABEL = "kubernetes-tpu.io/slice-shape"
GANG_LABEL = "kubernetes-tpu.io/gang"  # descheduler/strategies.py owner

# DRA attribute names a ResourceSlice's devices use to publish the SAME
# coordinates node labels carry (sched/dra.py reads these).
TOPO_ATTRS = ("topology-x", "topology-y", "topology-z")


def parse_shape(s: Optional[str]) -> Optional[tuple[int, int, int]]:
    """``"2x2x4"`` -> (2, 2, 4); None/empty/malformed -> None (a pod with
    a malformed shape label schedules as a NORMAL pod — the label is a
    request, not a trap; the invariant only judges parseable shapes)."""
    if not s:
        return None
    parts = str(s).lower().split("x")
    if len(parts) != 3:
        return None
    try:
        dims = tuple(int(p) for p in parts)
    except ValueError:
        return None
    if any(d <= 0 for d in dims):
        return None
    return dims  # type: ignore[return-value]


def shape_str(shape: tuple[int, int, int]) -> str:
    return "x".join(str(d) for d in shape)


def shape_of_labels(labels: Optional[dict]) -> Optional[tuple[int, int, int]]:
    """The ONE way to read an object's requested slice shape from labels
    (mirrors encode/snapshot.tenant_label_of for the tenant plane)."""
    return parse_shape((labels or {}).get(SLICE_SHAPE_LABEL))


def rotations(shape: tuple[int, int, int],
              dims: tuple[int, int, int]) -> tuple[tuple[int, int, int], ...]:
    """Distinct axis-order orientations of ``shape`` that fit ``dims``.

    Sorted for determinism (the carver's first-fit selection order is
    (rotation, x, y, z), so this order is part of the bit-parity
    contract). An orientation with any extent LARGER than the grid axis is
    dropped: with wrap-around, extent > axis would count a torus cell
    twice and "fit" a slice onto fewer physical nodes than it needs
    (extent == axis is fine — the box covers the whole ring exactly
    once)."""
    return tuple(sorted(
        r for r in set(permutations(shape))
        if all(e <= d for e, d in zip(r, dims))))


def coords_of_labels(labels: Optional[dict]
                     ) -> Optional[tuple[int, int, int]]:
    """A node's ICI-torus coordinate from its topology labels, or None
    when any axis label is absent/non-integer (the node is off-grid and
    never hosts a slice member)."""
    labels = labels or {}
    out = []
    for axis in ("x", "y", "z"):
        v = labels.get(f"kubernetes-tpu.io/topology-{axis}")
        if v is None:
            return None
        try:
            out.append(int(v))
        except (TypeError, ValueError):
            return None
    if any(c < 0 for c in out):
        return None
    return tuple(out)  # type: ignore[return-value]


def topology_labels(x: int, y: int, z: int) -> dict[str, str]:
    """The label stamp for a node at (x, y, z) — test/bench helper kept
    next to the vocabulary so fixtures can't drift from the reader."""
    return {"kubernetes-tpu.io/topology-x": str(x),
            "kubernetes-tpu.io/topology-y": str(y),
            "kubernetes-tpu.io/topology-z": str(z)}


def grid_dims(coords: list[tuple[int, int, int]]
              ) -> Optional[tuple[int, int, int]]:
    """Dense grid extent covering every known coordinate: (max+1) per
    axis. None when no node carries coordinates (topology disabled)."""
    if not coords:
        return None
    return (max(c[0] for c in coords) + 1,
            max(c[1] for c in coords) + 1,
            max(c[2] for c in coords) + 1)


def box_cells(origin: tuple[int, int, int], rot: tuple[int, int, int],
              dims: tuple[int, int, int]) -> list[tuple[int, int, int]]:
    """The torus cells of a ``rot``-shaped box at ``origin`` (wrap-around),
    in C order — member m of a gang sits on ``box_cells(...)[m]``. The C
    order is part of the parity contract between the device carver, the
    numpy oracle and the audit invariant."""
    a, b, c = rot
    X, Y, Z = dims
    return [((origin[0] + i) % X, (origin[1] + j) % Y, (origin[2] + k) % Z)
            for i in range(a) for j in range(b) for k in range(c)]


def is_contiguous_slice(coords: list[tuple[int, int, int]],
                        shape: tuple[int, int, int],
                        dims: tuple[int, int, int]) -> bool:
    """Audit-side truth: do ``coords`` form ONE contiguous torus box of
    ``shape`` under some rotation + wrap-around? Distinctness is required
    (two members on one node is never a slice)."""
    want = len(coords)
    if want != shape[0] * shape[1] * shape[2]:
        return False
    cs = set(coords)
    if len(cs) != want:
        return False
    c0 = next(iter(cs))
    for rot in rotations(shape, dims):
        # c0 must sit SOMEWHERE in the box, so the only viable anchors are
        # (c0 - offset) mod dims for each in-box offset — O(|box|) anchors,
        # not O(X*Y*Z)
        for i in range(rot[0]):
            for j in range(rot[1]):
                for k in range(rot[2]):
                    anchor = ((c0[0] - i) % dims[0],
                              (c0[1] - j) % dims[1],
                              (c0[2] - k) % dims[2])
                    if cs == set(box_cells(anchor, rot, dims)):
                        return True
    return False
