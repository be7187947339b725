"""The port's default preemption on the CUDA card against the CPU.

This file imports no JAX, so the card's machine runs it
(``python -m pytest --noconftest -m gpu tests/test_torch_preemption_card.py``).
Every test needs the card and skips without one:

- ``_wave_scan``'s four outputs and ``_dry_run``'s bit-equal on the card
  and the CPU, on seeded inputs with pad rows and the unlimited ``"pods"``
  allocatable, all Qb steps and stopped after the last preemptor;
- ``preempt_wave`` gives the same results on both at 1024 saturated nodes
  and 128 preemptors, its static masks from the encoded cluster;
- the three legs of ``chip_smoke.preemption_parity_phase`` (the raw scan
  and static masks, the Scheduler at depth 1 and 2, the runner over a
  DirectClient) are equal on the card and the CPU.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from kubernetes_tpu_torch.ops import preemption as ops
from kubernetes_tpu_torch.sched import preemption as pre
from kubernetes_tpu_torch.testing.workloads import build_saturated


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _arrays(seed, N=256, V=4, R=3, Q=100, Qb=128):
    rng = np.random.default_rng(seed)
    allocatable = rng.integers(4, 16, (N, R)).astype(np.int32)
    requested = (allocatable - rng.integers(-1, 2, (N, R))).astype(np.int32)
    allocatable[:, -1] = np.iinfo(np.int32).max
    counts = rng.integers(0, V + 1, N)
    vic_valid = np.arange(V)[None, :] < counts[:, None]
    vic_req = (rng.integers(1, 5, (N, V, R)) * vic_valid[..., None]) \
        .astype(np.int32)
    vic_violating = (rng.random((N, V)) < 0.3) & vic_valid
    vic_prio = np.where(vic_valid, rng.integers(0, 30, (N, V)), 0) \
        .astype(np.int32)
    need = np.zeros((Qb, R), np.int32)
    need[:Q] = rng.integers(0, 5, (Q, R))
    need[:Q, 0] = rng.integers(2, 5, Q)
    prio = np.full(Qb, ops._INT_MIN, np.int32)
    prio[:Q] = rng.integers(5, 40, Q)
    smask = np.zeros((Qb, N), bool)
    smask[:Q] = rng.random((Q, N)) < 0.8
    return (allocatable, requested, smask, vic_req, vic_valid,
            vic_violating, vic_prio, need, prio)


def _on(arrays, device):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_wave_scan_on_card_equals_cpu(seed):
    _card()
    arrays = _arrays(seed)
    cpu = [t.numpy() for t in ops._wave_scan(*_on(arrays, "cpu"))]
    assert cpu[0].any()
    for steps in (None, 100):
        card = [t.cpu().numpy() for t in
                ops._wave_scan(*_on(arrays, "cuda"), steps=steps)]
        for a, b in zip(cpu, card):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.gpu
def test_dry_run_on_card_equals_cpu():
    _card()
    a = _arrays(2)
    arrays = (a[0], a[1], a[2][0], a[3], a[4], a[5], a[6], a[7][0])
    cpu = [t.numpy() for t in ops._dry_run(*_on(arrays, "cpu"))]
    card = [t.cpu().numpy() for t in ops._dry_run(*_on(arrays, "cuda"))]
    for x, y in zip(cpu, card):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.gpu
def test_preempt_wave_on_card_equals_cpu():
    _card()
    nodes, bound = build_saturated(1024)
    pods = chip_smoke.preemptors(128)
    out = {}
    for device in ("cuda", "cpu"):
        masks = pre.tensor_static_masks(nodes, pods, bound_pods=bound,
                                        min_p=pre.WAVE_BUCKET, device=device)
        out[device] = (masks, chip_smoke._result_keys(pre.preempt_wave(
            nodes, bound, pods, static_masks=masks, min_q=pre.WAVE_BUCKET,
            device=device)))
    assert np.array_equal(out["cuda"][0], out["cpu"][0])
    assert out["cuda"][1] == out["cpu"][1]
    assert all(k is not None and len(k[1]) == 2 for k in out["cuda"][1])


@pytest.mark.gpu
def test_preemption_parity_phase_on_card():
    _card()
    out = chip_smoke.preemption_parity_phase(devices=("cuda", "cpu"))
    assert out["scan"]["found"] > 0
    for depth in ("scheduler_depth_1", "scheduler_depth_2"):
        assert out[depth]["evicted"] == 20
    assert out["runner"]["bound"] == 12
