"""The port's StagingArena and ResidentShadow (sched/staging.py), on the CPU.

The arena keeps the reference's contract (``tests/test_staging.py``): a
redeemed swap equals the submitted host stack, and every invalidation path
— an invalidate between submit and redeem, a redeem for another device, a
failed upload, a full double buffer — declines into the inline path with
the counters saying so, and no depth slot leaks. On the CPU staging is the
plain conversion; the card's pinned buffers and side stream are held
against an inline copy by ``tests/test_torch_sched_card.py``.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
from kubernetes_tpu_torch.models.gang import (_tree_leaves, stack_batches,
                                              unify_batches)
from kubernetes_tpu_torch.sched.staging import ResidentShadow, StagingArena
from kubernetes_tpu_torch.testing.workloads import relational_mix


def _stack(n_batches=2, P=8, seed=0):
    """A stacked PodBatch of numpy leaves, as the drain stages it."""
    nodes, bound, pending, ns = relational_mix(pods=n_batches * P, nodes=8,
                                               bound=4, seed=seed)
    enc = SnapshotEncoder()
    enc.set_namespaces(ns)
    _, meta = enc.encode_cluster(nodes, bound, pending_pods=pending)
    pbs = [enc.encode_pods(pending[b * P:(b + 1) * P], meta, min_p=P)
           for b in range(n_batches)]
    return stack_batches(unify_batches(pbs))


class _Blocking:
    """A stack whose conversion waits until released (a slow upload)."""

    nbytes = 64

    def __init__(self):
        self.release = threading.Event()

    def to(self, device):
        assert self.release.wait(10)
        return ("staged", id(self))


class _Failing:
    nbytes = 64

    def to(self, device):
        raise RuntimeError("injected upload failure")


def test_submit_redeem_equals_host_stack():
    arena = StagingArena()
    try:
        stack = _stack()
        ticket = arena.submit(stack, "cpu")
        assert ticket is not None
        staged = arena.redeem(ticket, "cpu")
        assert staged is not None
        for host, dev in zip(_tree_leaves(stack), _tree_leaves(staged)):
            assert isinstance(dev, torch.Tensor)
            assert np.array_equal(host, dev.numpy(),
                                  equal_nan=host.dtype.kind == "f")
        st = arena.stats()
        assert st["submits"] == st["swaps"] == 1 and st["fallbacks"] == 0
        assert st["bytesStaged"] == sum(a.nbytes
                                        for a in _tree_leaves(stack))
        assert st["inflight"] == 0
        # a redeemed ticket never aliases its buffers a second time
        assert ticket.staged is None
    finally:
        arena.close()


def test_invalidate_and_other_device_decline():
    arena = StagingArena()
    try:
        t = arena.submit(_stack(), "cpu")
        arena.invalidate()
        assert arena.redeem(t, "cpu") is None
        t2 = arena.submit(_stack(), "cpu")
        assert arena.redeem(t2, "meta") is None
        assert arena.redeem(None, "cpu") is None
        st = arena.stats()
        assert st["fallbacks"] == 2 and st["swaps"] == 0
        assert st["inflight"] == 0
    finally:
        arena.close()


def test_failed_upload_declines_and_frees_its_slot():
    arena = StagingArena(depth=1)
    try:
        t = arena.submit(_Failing(), "cpu")
        assert arena.redeem(t, "cpu") is None
        assert isinstance(t.error, RuntimeError)
        assert arena.stats()["inflight"] == 0
        # the slot came back: the next submit is taken
        t2 = arena.submit(_stack(), "cpu")
        assert t2 is not None and arena.redeem(t2, "cpu") is not None
    finally:
        arena.close()


def test_double_buffer_bound_and_no_leaked_slots():
    """At most ``depth`` uploads in flight: a third submit while two are
    uploading declines (the caller stages inline); once they finish, the
    slots are free again, whether or not the tickets were redeemed."""
    arena = StagingArena(depth=2)
    try:
        a, b = _Blocking(), _Blocking()
        ta, tb = arena.submit(a, "cpu"), arena.submit(b, "cpu")
        assert ta is not None and tb is not None
        assert arena.submit(_stack(), "cpu") is None
        assert arena.stats()["inflight"] == 2
        a.release.set()
        b.release.set()
        assert arena.redeem(ta, "cpu") == ("staged", id(a))
        assert tb.done.wait(10)  # never redeemed: its slot frees anyway
        assert arena.stats()["inflight"] == 0
        tc = arena.submit(_stack(), "cpu")
        assert tc is not None and arena.redeem(tc, "cpu") is not None
        st = arena.stats()
        assert st["submits"] == 3 and st["swaps"] == 2
    finally:
        arena.close()


def test_redeem_wait_is_bounded():
    arena = StagingArena()
    try:
        blocked = _Blocking()
        t = arena.submit(blocked, "cpu")
        assert arena.redeem(t, "cpu", timeout=0.5) is None
        assert arena.stats()["fallbacks"] == 1
        blocked.release.set()
        assert t.done.wait(10)
    finally:
        arena.close()


def test_shadow_holds_its_own_copies():
    """The shadow is cut from the host encoding; the resident context is
    updated in place, and on the CPU a tensor of a numpy array shares its
    memory. Writes to such a tensor must not reach the shadow."""
    alloc = np.arange(12, dtype=np.int32).reshape(4, 3)
    req = np.zeros((4, 3), np.int32)
    shadow = ResidentShadow(torch.from_numpy(alloc), req)
    torch.from_numpy(alloc).add_(100)
    torch.from_numpy(req).add_(7)
    got_alloc, got_req = shadow.arrays()
    assert got_alloc.dtype == np.int64
    assert np.array_equal(got_alloc, np.arange(12).reshape(4, 3))
    assert not got_req.any()


def test_shadow_patch_order_contract():
    """A patch applied with winner folds still pending poisons the shadow
    (readers fall back), as in the reference."""
    shadow = ResidentShadow(np.full((3, 2), 10), np.zeros((3, 2)))
    shadow.fold_winners([("pod-a", 1)])
    assert shadow.arrays() is None  # behind until caught up
    patch = {"node_row": np.array([1, -1]),
             "n_alloc": np.array([[5, 5], [0, 0]]),
             "n_reset": np.array([True, False]),
             "req_delta": np.zeros((3, 2), np.int64)}
    shadow.apply_patch(patch)
    assert not shadow.ok and shadow.arrays() is None
    good = ResidentShadow(np.full((3, 2), 10), np.zeros((3, 2)))
    good.fold_winners([("pod-a", 1)])
    good.catch_up(lambda pod: np.array([2, 3]))
    good.apply_patch(dict(patch, req_delta=np.ones((3, 2), np.int64)))
    alloc, req = good.arrays()
    assert alloc.tolist() == [[10, 10], [5, 5], [10, 10]]
    assert req.tolist() == [[1, 1], [1, 1], [1, 1]]


def test_arena_counters_hold_under_thread_switching():
    """Submit/redeem against the stager thread with a tiny switch
    interval: every submit is either swapped or declined, and no depth
    slot leaks."""
    import sys
    stack = _stack(P=4)
    arena = StagingArena(depth=2)
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        taken = declined = 0
        tickets = []
        for i in range(200):
            t = arena.submit(stack, "cpu")
            if t is None:
                declined += 1
            else:
                taken += 1
                tickets.append(t)
            if i % 3 == 2:
                while tickets:
                    assert arena.redeem(tickets.pop(0), "cpu") is not None
        for t in tickets:
            assert arena.redeem(t, "cpu") is not None
        st = arena.stats()
        assert st["submits"] == taken == st["swaps"]
        assert taken + declined == 200 and st["fallbacks"] == 0
        assert st["inflight"] == 0
    finally:
        sys.setswitchinterval(prev)
        arena.close()
