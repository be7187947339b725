"""Double-buffered batch staging, and the resident-totals host shadow.

The PyTorch port of ``kubernetes_tpu/sched/staging.py``. Two pieces:

``StagingArena``
    A background "batch-stager" thread stages drain K+1's stacked pod
    batch while the scheduling thread finishes drain K's host work. On the
    card, the host stack is written into PINNED host buffers and copied to
    the device with ``non_blocking=True`` on a side CUDA stream; the copy
    records an event. At dispatch ``Scheduler._stage_batch`` REDEEMS the
    ticket: the drain's stream waits on that event (``wait_event``) and
    every staged tensor is ``record_stream``-ed onto it, so the caching
    allocator never hands the memory out again while the drain still reads
    it. Double-buffered: at most ``depth`` pinned buffers, and a buffer is
    not written again until its copy's event has completed. On the CPU,
    staging is the plain conversion (``PodBatch.to``), through the same
    thread, tickets and counters. A ticket invalidated since submit, a
    failed upload, a dead stager or a full double buffer DECLINES into the
    inline path (``SchedulerCache.stage_drain_batch``): the staged copy is
    a faithful snapshot of the submitted host stack, so a declined swap
    loses only the overlap, never data.

``ResidentShadow``
    Host mirror of the resident cluster encoding's [N,R] allocatable /
    requested totals, maintained from data the host already touches:
    winner folds mirrored at resolve (request vectors computed lazily),
    churn patches replayed from their host arrays. It holds its OWN numpy
    copies: the port's ``drain_step`` updates the resident tensors in
    place, and on the CPU a tensor made with ``torch.from_numpy`` shares
    its memory — a view would follow the device state the shadow mirrors.

Under a device mesh (parallel/mesh.py) a ticket carries the mesh it was
staged for, and the upload is the mesh's pre-split staging
(``presplit_stack``: one copy of the stack on each of its devices); a
redeem under another mesh, or after ``invalidate`` (a mesh install or
reshape), declines into the inline path, which stages for the current
layout.
"""

from __future__ import annotations

import logging
import queue as queue_mod
import threading
from typing import Any, Optional

import numpy as np
import torch

_LOG = logging.getLogger(__name__)

# bounded wait for an in-flight upload at redeem time: a stuck stager
# thread must degrade to the inline path, never hang the scheduling loop
REDEEM_WAIT_S = 30.0


def _leaves(tree) -> list:
    from kubernetes_tpu_torch.models.gang import _tree_leaves
    return _tree_leaves(tree)


def _tree_nbytes(tree) -> int:
    return int(sum(leaf.nbytes for leaf in _leaves(tree)))


class _Slot:
    """One pinned host buffer set (one per leaf of the stacked batch) and
    the event of the last copy out of it."""

    __slots__ = ("pinned", "event", "claimed")

    def __init__(self):
        self.pinned: list = []
        self.event = None
        self.claimed = False

    def free(self) -> bool:
        return not self.claimed and (self.event is None
                                     or self.event.query())


class StageTicket:
    """One submitted upload: done Event + result slot + validity stamps."""

    __slots__ = ("done", "staged", "error", "epoch", "device", "nbytes",
                 "event", "slot", "mesh")

    def __init__(self, epoch: int, device: torch.device,
                 slot: Optional[_Slot], mesh=None):
        self.done = threading.Event()
        self.staged = None
        self.error: Optional[BaseException] = None
        self.epoch = epoch
        self.device = device
        self.nbytes = 0
        self.event = None    # the copy's CUDA event (None on the CPU)
        self.slot = slot
        self.mesh = mesh     # the mesh it was staged for (None: device)


class StagingArena:
    """Double-buffered device staging for drain batch stacks."""

    def __init__(self, depth: int = 2):
        self.depth = max(1, int(depth))
        self._lock = threading.Lock()
        self._q: "queue_mod.Queue" = queue_mod.Queue()
        self._thread: Optional[threading.Thread] = None
        self._stream = None  # the side CUDA stream, made on first use
        self._slots = [_Slot() for _ in range(self.depth)]  # guarded by: self._lock
        self._epoch = 0    # guarded by: self._lock
        self._inflight = 0  # guarded by: self._lock
        # health counters, shared between the stager thread, the dispatch
        # thread and status readers
        self.swaps = 0        # guarded by: self._lock
        self.fallbacks = 0    # guarded by: self._lock
        self.submits = 0      # guarded by: self._lock
        self.bytes_staged = 0  # guarded by: self._lock

    # ---- lifecycle -------------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            t = threading.Thread(target=self._loop, daemon=True,
                                 name="batch-stager")
            self._thread = t
            t.start()

    def _upload(self, ticket: StageTicket, pb_stack):
        """The staged copy of ``pb_stack`` on ``ticket.device`` (under a
        mesh, its pre-split copies: {device: stack})."""
        if ticket.mesh is not None:
            from kubernetes_tpu_torch.parallel.mesh import presplit_stack
            return presplit_stack(ticket.mesh, pb_stack)
        if ticket.device.type != "cuda":
            return pb_stack.to(ticket.device)
        from kubernetes_tpu_torch.models.gang import _tree_map
        slot = ticket.slot
        leaves = _leaves(pb_stack)
        # a buffer set keeps its pinned tensors while the shapes hold (the
        # resident context pins the batch shapes, so the steady state
        # allocates pinned memory once per slot)
        if [(tuple(p.shape), p.dtype) for p in slot.pinned] != [
                (tuple(a.shape), torch.from_numpy(a[:0]).dtype)
                for a in leaves]:
            slot.pinned = [torch.empty(a.shape,
                                       dtype=torch.from_numpy(a[:0]).dtype,
                                       pin_memory=True) for a in leaves]
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=ticket.device)
        pinned = iter(slot.pinned)

        def copy(a):
            host = next(pinned)
            host.numpy()[...] = a
            return host.to(ticket.device, non_blocking=True)

        with torch.cuda.stream(self._stream):
            out = _tree_map(copy, pb_stack)
            ticket.event = torch.cuda.Event()
            ticket.event.record(self._stream)
        # the buffer set is free again once this event completes (_Slot.free)
        slot.event = ticket.event
        return out

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:  # poison pill from close()
                return
            ticket, pb_stack = item
            try:
                ticket.staged = self._upload(ticket, pb_stack)
                ticket.nbytes = _tree_nbytes(pb_stack)
            except BaseException as e:  # noqa: BLE001 — redeem reports it
                ticket.error = e
                _LOG.warning("batch staging upload failed; dispatch will "
                             "stage inline", exc_info=True)
            finally:
                # the depth slot frees when the UPLOAD is issued, not at
                # redeem: a ticket a failed cycle never redeems must not pin
                # a slot forever; the pinned buffer itself stays guarded by
                # its copy's event
                with self._lock:
                    self._inflight = max(0, self._inflight - 1)
                    if ticket.slot is not None:
                        ticket.slot.claimed = False
                ticket.done.set()

    def close(self) -> None:
        t = self._thread
        if t is not None:
            self._q.put(None)
            self._thread = None
            t.join(timeout=2.0)  # drains the poison pill; uploads are short

    # ---- submit / redeem -------------------------------------------------

    def submit(self, pb_stack, device, mesh=None) -> Optional[StageTicket]:
        """Enqueue an upload of ``pb_stack`` (a stacked PodBatch of numpy
        leaves) to ``device``; returns a ticket to redeem at dispatch, or
        None when the double buffer is full (caller stages inline — never
        queues unboundedly behind a slow copy)."""
        device = torch.device(device)
        with self._lock:
            if self._inflight >= self.depth:
                return None
            slot = None
            if device.type == "cuda" and mesh is None:
                slot = next((s for s in self._slots if s.free()), None)
                if slot is None:
                    return None  # both pinned buffers still being copied
                slot.claimed = True
            self._inflight += 1
            self.submits += 1
            ticket = StageTicket(self._epoch, device, slot, mesh)
        self._ensure_thread()
        self._q.put((ticket, pb_stack))
        return ticket

    def redeem(self, ticket: Optional[StageTicket], device, mesh=None,
               timeout: float = REDEEM_WAIT_S):
        """The staged batch, ready for use on the current stream, or None
        (caller falls back to the inline path). Declines when the arena
        was invalidated since submit, the upload failed, the stager thread
        died, or the bounded wait expired."""
        if ticket is None:
            return None
        try:
            deadline = timeout
            while not ticket.done.wait(min(0.25, deadline)):
                deadline -= 0.25
                t = self._thread
                if deadline <= 0 or t is None or not t.is_alive():
                    _LOG.warning("batch-stager %s; staging inline",
                                 "died" if (t is None or not t.is_alive())
                                 else f"silent for {timeout:.0f}s")
                    with self._lock:
                        self.fallbacks += 1
                    return None
            with self._lock:
                stale = (ticket.epoch != self._epoch
                         or ticket.device != torch.device(device)
                         or ticket.mesh is not mesh)
                if stale or ticket.error is not None \
                        or ticket.staged is None:
                    self.fallbacks += 1
                    return None
                self.swaps += 1
                self.bytes_staged += ticket.nbytes
                swaps = self.swaps
            staged = ticket.staged
            if ticket.event is not None:
                # the drain runs on the caller's stream: order it after the
                # side-stream copy, and keep the allocator from reusing the
                # staged memory until that stream's work is done
                stream = torch.cuda.current_stream(ticket.device)
                stream.wait_event(ticket.event)
                for leaf in _leaves(staged):
                    leaf.record_stream(stream)
            from kubernetes_tpu_torch.metrics.registry import (
                STAGE_BUFFER_REUSE, STAGE_BYTES)
            STAGE_BYTES.inc({"path": "arena"}, by=ticket.nbytes)
            STAGE_BUFFER_REUSE.set(swaps)
            return staged
        finally:
            ticket.staged = None  # the arena never aliases redeemed buffers

    def invalidate(self) -> None:
        """Drop every in-flight ticket's validity: redeems after this fall
        back to the inline path."""
        with self._lock:
            self._epoch += 1

    def stats(self) -> dict:
        with self._lock:
            return {"submits": self.submits, "swaps": self.swaps,
                    "fallbacks": self.fallbacks,
                    "bytesStaged": self.bytes_staged,
                    "inflight": self._inflight}


def _host_copy(a) -> np.ndarray:
    """An int64 numpy array of ``a`` (numpy or a tensor on any device) that
    shares no memory with it."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.array(a, dtype=np.int64, copy=True)


class ResidentShadow:
    """Host mirror of the resident encoding's [N,R] totals (int64 numpy).

    Fed from three host-side sources that are exact mirrors of what the
    device program does to the resident arrays:

    - winner folds: ``drain_step`` adds each committed pod's request row
      into ``requested`` — the resolve loop appends (pod, node row) here
      and the vectors are computed LAZILY (``catch_up``) only when a
      reader actually needs the totals;
    - churn patches: ``_apply_patch`` zeroes reset rows, adds
      ``req_delta``, and rewrites ``allocatable`` rows — ``apply_patch``
      replays the same numpy arrays the patch compile produced;
    - rebuilds: a fresh shadow is cut from the host encoding that staged
      the context.

    Any exception poisons the shadow (``ok`` False); a reader then falls
    back to the device readback — drift degrades to a fetch, never to a
    wrong answer.

    Thread contract: ``fold_winners`` may run on another thread than
    ``catch_up``/``apply_patch``/``arrays``, so every access holds the lock.
    """

    def __init__(self, allocatable, requested):
        self._lock = threading.Lock()
        self.alloc = _host_copy(allocatable)  # guarded by: self._lock
        self.req = _host_copy(requested)  # guarded by: self._lock
        self.pending: list[tuple[Any, int]] = []  # guarded by: self._lock
        self.ok = True  # guarded by: self._lock

    def fold_winners(self, pairs: list) -> None:
        """Record winners mirrored at resolve: [(Pod, node_row)]."""
        with self._lock:
            self.pending.extend(pairs)

    def catch_up(self, vec_fn) -> None:
        """Fold pending winners' request vectors into ``requested``.
        ``vec_fn(pod) -> [R] int vector`` on the RESIDENT resource axis
        (the same ``_request_vector`` the encode and the device fold's
        batch rows use, so the mirror is bit-consistent)."""
        with self._lock:
            if not self.pending:
                return
            pending, self.pending = self.pending, []
            try:
                for pod, row in pending:
                    self.req[row] += np.asarray(vec_fn(pod), np.int64)
            except Exception:
                self.ok = False
                _LOG.exception("resident shadow catch-up failed; readers "
                               "fall back to the device readback")

    def apply_patch(self, patch: dict) -> None:
        """Mirror ``_apply_patch``'s requested/allocatable writes.

        ORDER CONTRACT: pending winner folds must be caught up FIRST (the
        scheduler calls ``catch_up`` before this) — on device the folds
        happened in earlier dispatches, strictly before this patch, so a
        patch that resets a row the device already folded a winner into
        must zero the winner's contribution too. Un-caught-up pending
        entries poison the shadow rather than silently mis-mirroring."""
        with self._lock:
            if self.pending:
                self.ok = False
                _LOG.error("resident shadow patch applied with %d winner "
                           "folds pending; poisoning the shadow",
                           len(self.pending))
                return
            try:
                rows = np.asarray(patch["node_row"])
                live = rows >= 0
                if live.any():
                    idx = rows[live]
                    self.alloc[idx] = np.asarray(patch["n_alloc"])[live]
                    reset = np.asarray(patch["n_reset"], bool) & live
                    if reset.any():
                        self.req[rows[reset]] = 0
                self.req += np.asarray(patch["req_delta"])
            except Exception:
                self.ok = False
                _LOG.exception("resident shadow patch mirror failed; "
                               "readers fall back to the device readback")

    def arrays(self):
        """(allocatable, requested) or None when the shadow is poisoned or
        still behind (pending winners not yet caught up). The returned
        arrays are the live mirrors (not copies)."""
        with self._lock:
            if not self.ok or self.pending:
                return None
            return self.alloc, self.req
