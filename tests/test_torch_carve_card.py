"""The port's slice carver on the CUDA card against the CPU.

This file imports no JAX, so the card's machine runs it
(``python -m pytest --noconftest -m gpu tests/test_torch_carve_card.py``).
Every test needs the card and skips without one:

- ``carve_step`` (through ``carve_device``, the read-back included) on
  the card and on the CPU over one encoding of the 16x16x16 cluster of
  ``chip_smoke.carve_full_parity`` (empty, full and mixed 4x4x4 cubes,
  claimed cells): ``fits``, ``cost``, ``node_grid`` and ``free_grid``
  bit-equal for each shape of the ``slice`` phase and the failing 8x8x16,
  and both selections equal;
- ``chip_smoke.slice_parity_phase``: the small SliceCarve layout through
  the Scheduler equal on the card and the CPU, and the full-size carve on
  the card equal to the numpy twin.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from kubernetes_tpu_torch.topology import carve
from kubernetes_tpu_torch.topology.slicing import parse_shape


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [s for s, _w in chip_smoke.SLICE_SHAPES]
                         + [chip_smoke.SLICE_FAIL])
def test_carve_step_on_card_equals_cpu(shape):
    _card()
    nodes, bound, claimed, member = chip_smoke.carve_full_cluster()
    got = {}
    for device in ("cuda", "cpu"):
        ct, member_req, tenant = chip_smoke.carve_full_encoding(
            nodes, bound, member, device)
        claimed_np = np.zeros(ct.node_valid.shape[0], bool)
        claimed_np[sorted(claimed)] = True
        got[device] = carve.carve_device(ct, member_req, tenant, claimed_np,
                                         chip_smoke.SLICE_DIMS,
                                         parse_shape(shape))
    a, b = got["cuda"], got["cpu"]
    for f in ("fits", "cost", "node_grid", "free_grid"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)  # tolerance 0
    assert a.rots == b.rots
    assert carve.select_assignment(a) == carve.select_assignment(b)
    assert carve.select_eviction(a) == carve.select_eviction(b)


@pytest.mark.gpu
def test_slice_parity_phase_on_card():
    _card()
    out = chip_smoke.slice_parity_phase()
    assert out["small"]["carve_stats"]["slicePreempts"] == 1
    assert out["full"]["2x2x4"]["rotations"] == 3
