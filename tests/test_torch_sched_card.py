"""The port's scheduling loop on the CUDA card against the CPU.

This file imports no JAX, so the card's machine runs it
(``python -m pytest --noconftest -m gpu tests/test_torch_sched_card.py``).
Every test needs the card and skips without one:

- the port's Scheduler over a small relational_mix cluster with churn
  between pops gives the same binder log, ctx_stats and folded resident
  context on ``cuda`` as on ``cpu`` (``chip_smoke.sched_parity_phase``);
- the staging arena's side-stream copies into pinned buffers equal an
  inline copy, read on the current stream behind a deliberately long
  kernel, with more batches submitted than there are pinned buffers;
- a pinned buffer is not written again while its copy is still queued
  behind a long kernel on the side stream: the arena declines a third
  batch until a copy has completed.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
from kubernetes_tpu_torch.models.gang import (_tree_leaves, stack_batches,
                                              unify_batches)
from kubernetes_tpu_torch.sched.staging import StagingArena
from kubernetes_tpu_torch.testing.workloads import relational_mix


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_scheduler_on_card_equals_cpu():
    _card()
    out = chip_smoke.sched_parity_phase(devices=("cuda", "cpu"),
                                        depths=(1, 2))
    for depth in ("depth_1", "depth_2"):
        assert out[depth]["placed"] >= 40
        assert out[depth]["ctx_stats"]["folds"] >= 3


def _stacks(n, P=16):
    nodes, bound, pending, ns = relational_mix(pods=n * 2 * P, nodes=8,
                                               bound=4, seed=7)
    enc = SnapshotEncoder()
    enc.set_namespaces(ns)
    _, meta = enc.encode_cluster(nodes, bound, pending_pods=pending)
    out = []
    for i in range(n):
        pods = pending[i * 2 * P:(i + 1) * 2 * P]
        pbs = [enc.encode_pods(pods[b * P:(b + 1) * P], meta, min_p=P)
               for b in range(2)]
        out.append(stack_batches(unify_batches(pbs)))
    return out


def _assert_staged_equals(stack, leaves):
    for host, dev in zip(_tree_leaves(stack), leaves):
        inline = torch.from_numpy(np.asarray(host)).to("cuda").cpu().numpy()
        assert dev.device.type == "cuda"
        assert np.array_equal(dev.cpu().numpy(), inline,
                              equal_nan=inline.dtype.kind == "f")


@pytest.mark.gpu
def test_staging_side_stream_equals_inline_copy():
    """Each batch is submitted while the current stream runs a long kernel
    (the drain the copy overlaps), redeemed, and read on the current
    stream: it equals the inline copy of the same host stack. Six batches
    through two pinned buffers, each redeemed before the next is
    submitted: no batch sees another's bytes."""
    _card()
    arena = StagingArena(depth=2)
    try:
        stacks = _stacks(6)
        got = []
        for stack in stacks:
            torch.cuda._sleep(50_000_000)  # ~tens of ms of device time
            ticket = arena.submit(stack, "cuda")
            staged = (arena.redeem(ticket, "cuda") if ticket is not None
                      else None)
            assert staged is not None, arena.stats()
            got.append([leaf.clone() for leaf in _tree_leaves(staged)])
        torch.cuda.synchronize()
        for stack, leaves in zip(stacks, got):
            _assert_staged_equals(stack, leaves)
        st = arena.stats()
        assert st["swaps"] == 6 and st["fallbacks"] == 0
        assert st["inflight"] == 0
        assert st["bytesStaged"] == sum(np.asarray(a).nbytes
                                        for s in stacks
                                        for a in _tree_leaves(s))
    finally:
        arena.close()


@pytest.mark.gpu
def test_staging_pinned_buffer_waits_for_its_copy():
    """Two batches are submitted before either is redeemed, behind a long
    kernel queued on the arena's side stream, so neither copy has run.
    Once both uploads are issued (none in flight), a third submit is still
    declined: both pinned buffers wait for their copies' events. Each
    redeemed batch equals its own host stack; once the copies complete,
    the third batch takes one of the two buffers and equals its own."""
    _card()
    arena = StagingArena(depth=2)
    try:
        stacks = _stacks(3)
        arena._stream = torch.cuda.Stream()
        with torch.cuda.stream(arena._stream):
            torch.cuda._sleep(2_000_000_000)  # about a second of the card
        tickets = [arena.submit(s, "cuda") for s in stacks[:2]]
        assert all(t is not None for t in tickets), arena.stats()
        assert all(t.done.wait(10.0) for t in tickets)
        assert arena.stats()["inflight"] == 0
        assert all(t.error is None and not t.event.query() for t in tickets)
        assert tickets[0].slot is not tickets[1].slot
        assert arena.submit(stacks[2], "cuda") is None
        got = [[leaf.clone() for leaf in _tree_leaves(arena.redeem(t, "cuda"))]
               for t in tickets]
        torch.cuda.synchronize()
        third = arena.submit(stacks[2], "cuda")
        assert third is not None, arena.stats()
        assert any(third.slot is t.slot for t in tickets)
        got.append([leaf.clone()
                    for leaf in _tree_leaves(arena.redeem(third, "cuda"))])
        torch.cuda.synchronize()
        for stack, leaves in zip(stacks, got):
            _assert_staged_equals(stack, leaves)
        st = arena.stats()
        assert st["swaps"] == 3 and st["fallbacks"] == 0
        assert st["submits"] == 3 and st["inflight"] == 0
    finally:
        arena.close()
