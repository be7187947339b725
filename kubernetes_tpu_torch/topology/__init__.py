"""Topology-aware slice carving: contiguous ICI sub-slice scheduling.

``slicing`` is the host vocabulary (shapes, rotations, coordinates,
contiguity truth); ``carve`` is the batched carver on a torch device and
its numpy twin. sched/scheduler.py drives the carve inside
``_schedule_group``; sched/oracle.py hosts the oracle carver the parity
machinery judges against.
"""

from kubernetes_tpu_torch.topology.slicing import (  # noqa: F401
    GANG_LABEL,
    SLICE_SHAPE_LABEL,
    TOPO_ATTRS,
    box_cells,
    coords_of_labels,
    grid_dims,
    is_contiguous_slice,
    parse_shape,
    rotations,
    shape_of_labels,
    shape_str,
    topology_labels,
)
from kubernetes_tpu_torch.topology.carve import (  # noqa: F401
    CarveResult,
    carve_device,
    carve_step,
    coverage_stats,
    covered_nodes,
    numpy_grids,
    select_assignment,
    select_eviction,
)
