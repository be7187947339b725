"""Captured CUDA graphs of the gang rounds: the port's counterpart of
``jax.jit``'s executable cache.

The reference runs a batch's whole convergence as one XLA program, compiled
once per static signature and found again in jit's cache. Eager PyTorch has
no program to keep; on the card the counterpart is a ``torch.cuda.CUDAGraph``
of a chunk of K masked rounds (``models/gang._converge``), captured once per
key and replayed.

- **The key** (``graph_key``) names the body, its static arguments (seed,
  fit strategy, topology keys, weights, filters, serial, slot start, the
  round limit, K) and, for every input tensor, its address, shape, strides
  and dtype. A graph reads its inputs at the addresses it captured, so a
  replay is exact whenever every input of the key sits where it did at
  capture; a context rebuilt elsewhere, or a wider bucket, is a new key
  and a new capture (counted).
- **Inputs.** The resident drain context is captured where it lives: it is
  updated in place, so its addresses hold. Tensors made anew for each call
  (a pop's batch, the extended cluster of ``gang_schedule``, the extender
  overlay) are first copied into persistent buffers (``stable``), one set
  per shape, so the graphs see the same addresses at every call.
- **State.** Each graph owns the buffers of the state it carries from chunk
  to chunk; ``replay`` copies a state into them (unless it already is
  them), replays, and returns them. They are overwritten at the graph's
  next replay: the caller copies what it keeps.
- **Memory.** Every graph draws on one pool (``graph_pool_handle``) and
  is captured on one stream (``_capture_stream``): the caching allocator
  hands a block freed in a pool back only to the stream that allocated
  it, so captures on fresh streams would each grow the pool. The graphs
  are replayed one at a time, under ``LOCK``, on the current stream, and
  keep no output in the pool (the state buffers are allocated outside
  it), so the intermediates of one may reuse those of another.
- **Counters.** ``CAPTURES`` counts captures (as ``ops/kernels.BUILDS``
  counts builds; also ``scheduler_graph_captures_total``), ``REPLAYS``
  replays; ``HOST_READS`` counts the
  convergence loop's reads of its progress flag. A hand kernel launched
  while a graph is captured is not counted then: its launches are counted
  at each replay (``ops/kernels.count_launch``).
- **No fallback.** A capture or a replay that fails raises ``GraphError``,
  which ``sched/faults.is_fatal`` calls fatal; nothing falls back to the
  eager loop. A failed capture does not fail the process's later
  captures (``_end_failed_capture``). The eager loop on the card runs
  only when a caller passes ``capture=False`` (the smoke's and the card
  tests' comparisons).
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import torch

from kubernetes_tpu_torch.metrics.registry import GRAPH_CAPTURES
from kubernetes_tpu_torch.ops import kernels

CAPTURES = 0
REPLAYS = 0
HOST_READS = 0
# bounds on what is kept: graphs and persistent input buffers, least
# recently used first out
MAX_GRAPHS = 64
MAX_STABLE = 16

LOCK = threading.RLock()
_GRAPHS: "OrderedDict[tuple, _Graph]" = OrderedDict()
_STABLE: "OrderedDict[tuple, list]" = OrderedDict()
# graphs whose capture failed, kept alive for the life of the process
# (_end_failed_capture)
_FAILED: list = []
_POOL = None
_STREAM = None


class GraphError(RuntimeError):
    """A CUDA graph of the rounds failed to capture or to replay."""


class _Graph:
    def __init__(self, graph, state: list, launches: dict):
        self.graph = graph
        self.state = state
        self.launches = launches


def reset() -> None:
    """Drop every graph and persistent buffer (their memory goes back to
    the allocator once nothing else holds it). The counters only grow:
    callers diff them."""
    global _POOL, _STREAM
    with LOCK:
        _GRAPHS.clear()
        _STABLE.clear()
        _POOL = _STREAM = None


def counters() -> dict:
    return {"captures": CAPTURES, "replays": REPLAYS,
            "host_reads": HOST_READS, "keys": len(_GRAPHS)}


def count_host_read() -> None:
    global HOST_READS
    HOST_READS += 1


def _layout(t, address: bool = True):
    if t is None:
        return None
    return ((t.data_ptr() if address else None), tuple(t.shape),
            tuple(t.stride()), t.dtype, str(t.device))


def graph_key(tag: str, statics: tuple, tensors, carried=()) -> tuple:
    """The key of a graph of body ``tag``: its static arguments, the
    address and layout of every input tensor it reads where it lies (None
    for an absent one), and the layout of the state it carries (copied
    into the graph's own buffers, so its address does not matter)."""
    return (tag, statics, tuple(_layout(t) for t in tensors),
            tuple(_layout(t, address=False) for t in carried))


def stable(tag: str, leaves: list) -> list:
    """Persistent buffers holding a copy of ``leaves`` (tensors on one
    card), one set per tag and shapes: a graph keyed on them finds the
    same addresses at the next call of the same shapes."""
    key = (tag, tuple(None if t is None else (tuple(t.shape), t.dtype,
                                              str(t.device))
                      for t in leaves))
    with LOCK:
        bufs = _STABLE.get(key)
        if bufs is None:
            bufs = [None if t is None else torch.empty_like(
                t, memory_format=torch.contiguous_format) for t in leaves]
            _STABLE[key] = bufs
            while len(_STABLE) > MAX_STABLE:
                _STABLE.popitem(last=False)
        else:
            _STABLE.move_to_end(key)
        for b, t in zip(bufs, leaves):
            if t is not None:
                b.copy_(t)
        return bufs


def pool_bytes() -> int:
    """Bytes the caching allocator holds in graph pools (every graph
    shares one pool here): the allocator's snapshot names each segment's
    pool, and the general pool's id is (0, 0)."""
    return sum(int(seg.get("total_size", 0))
               for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


def _capture(body, state: list) -> _Graph:
    """Capture ``body`` on the capture stream. The idiom's eager warm-up
    runs first on that stream, so lazy initialisation (libraries,
    workspaces, the kernel's shared-memory opt-in) happens outside the
    capture. The capture itself is ``capture_begin``/``capture_end``, not
    the ``torch.cuda.graph`` context: that one synchronises the whole card
    and collects the garbage of every thread first, and the scheduler
    captures while its other threads (informers, explainer, staging) use
    the card; the capture stream waits on the current one instead."""
    global CAPTURES, _POOL, _STREAM
    static = [t.clone() for t in state]
    cur = torch.cuda.current_stream()
    if _STREAM is None:
        _STREAM = torch.cuda.Stream()
    side = _STREAM
    before = dict(kernels.CAPTURED)
    graph = None
    try:
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            body(static)
            if _POOL is None:
                _POOL = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=_POOL,
                                capture_error_mode="thread_local")
            try:
                new = body(static)
                for s, t in zip(static, new):
                    s.copy_(t)
            finally:
                graph.capture_end()
        cur.wait_stream(side)
    except GraphError:
        raise
    except Exception as e:
        if graph is not None:
            _end_failed_capture(graph)
        raise GraphError(f"CUDA graph capture of the rounds failed: "
                         f"{type(e).__name__}: {e}") from e
    CAPTURES += 1
    GRAPH_CAPTURES.inc()
    launches = {k: kernels.CAPTURED[k] - before.get(k, 0)
                for k in kernels.CAPTURED}
    # the warm-up's launches were real: count_launch counted them as such
    return _Graph(graph, static, launches)


def _end_failed_capture(graph) -> None:
    """After a capture the card refused (a host read in the body
    invalidates it), ``CUDAGraph.capture_end`` raises before it ends the
    caching allocator's recording into the pool, and the allocator keeps
    the graph's stream filter: a later capture into that pool fails
    ("already recording"). End the recording where the allocator lets us,
    keep the graph object alive (its filter stays valid, and matches no
    later capture), and give later captures a fresh pool."""
    global _POOL
    _FAILED.append(graph)
    try:
        torch._C._cuda_endAllocateToPool(torch.cuda.current_device(), _POOL)
    except RuntimeError:
        pass  # the capture ended its recording itself
    _POOL = None


def replay(key: tuple, body, state: list) -> list:
    """Run ``body(state) -> new state`` (lists of tensors on the card) as
    the graph of ``key``, capturing it at first use; -> the graph's state
    buffers, holding the new state. Call under ``LOCK``."""
    global REPLAYS
    entry = _GRAPHS.get(key)
    if entry is None:
        entry = _capture(body, state)
        _GRAPHS[key] = entry
        while len(_GRAPHS) > MAX_GRAPHS:
            _GRAPHS.popitem(last=False)
    else:
        _GRAPHS.move_to_end(key)
    for s, t in zip(entry.state, state):
        if s is not t:
            s.copy_(t)
    try:
        entry.graph.replay()
    except Exception as e:
        raise GraphError(f"CUDA graph replay of the rounds failed: "
                         f"{type(e).__name__}: {e}") from e
    REPLAYS += 1
    for name, n in entry.launches.items():
        kernels.LAUNCHES[name] += n
    return entry.state
