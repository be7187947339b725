"""Scheduler kill/restart chaos — the scheduler itself dies mid-flight.

The apiserver got this treatment first (``chaos/apiserver.py``); this is
the other half of the control plane dying. A real SchedulerRunner runs in
a subprocess against an apiserver URL; ``kill()`` SIGKILLs it —
in-flight binds tear, assumed pods never confirm, nominations go stale,
exactly like a node losing the scheduler pod — and ``restart()`` brings
a fresh process up against the same apiserver, where the boot must be:

  correct  informer sync rebuilds the cache from the API's nodeName
           truth (no duplicate binds are possible by construction) and
           the boot resync sweep clears the predecessor's stale
           nominations before the first cycle judges state;
  warm     with a kernel cache dir configured (``aotCacheDir``,
           sched/aotcache.py), the restarted child loads every kernel
           library from disk instead of building it with ``nvcc``; the
           CUDA graphs of the rounds are captured again by every process
           (a graph holds device addresses and is never written to disk).

The child runs on the card unless ``device`` says otherwise (the tests
pass ``"cpu"``); it holds a CUDA context of its own, which its SIGKILL
takes down with it.

The parent talks to the child over a Pipe: a ready dict (boot phase
timings + the kernel cache's boot report) arrives once the loop is live;
``stats()`` round-trips a live stats dict (the kernel cache's builds and
loads, the graphs captured and replayed, audit violations, parity
verdicts) so the gates read the CHILD's numbers — a zero-build claim
about some other process would be theater. The child answers stats
requests from a daemon thread, so a hung loop cannot hide by also
hanging the stats channel.
"""

from __future__ import annotations

import multiprocessing as mp
import threading
import time
from typing import Optional


def _child_stats(runner) -> dict:
    """The numbers the gates read, inside the child: the kernel cache's
    (``realBuilds``: ``nvcc`` builds since activation, ``hits``: libraries
    loaded without a build), every build of the process
    (``kernels.BUILDS``), the round graphs' captures and replays
    (``models/graphs``) and the count_pn launches; no XLA number."""
    from kubernetes_tpu_torch.audit.auditor import InvariantViolationError
    from kubernetes_tpu_torch.models import graphs
    from kubernetes_tpu_torch.ops import kernels
    auditor = runner.auditor
    try:
        auditor.run_once()  # final sweep so the verdict covers NOW
    except InvariantViolationError:
        pass  # recorded; the violation count below carries it
    except Exception:  # ktpu-lint: disable=KTL002 -- a broken final sweep must not eat the stats reply; the auditor's own loop already counts+logs sweep failures
        pass
    sentinel = runner.scheduler.sentinel
    if sentinel is not None:
        sentinel.drain()
    return {
        "aotCache": (runner.aot_cache.stats()
                     if runner.aot_cache is not None
                     else {"enabled": False}),
        "kernels": {"builds": kernels.BUILDS, "hits": kernels.HITS,
                    "loaded": sorted(kernels._LIBS),
                    "launches": dict(kernels.LAUNCHES)},
        "graphs": graphs.counters(),
        "device": str(runner.scheduler.device),
        "violations": auditor.total_violations,
        "auditFailed": auditor.failed,
        "parity": sentinel.stats() if sentinel is not None else None,
        "degradedMode": runner.scheduler.breaker.mode,
        "loopError": (repr(runner.loop_error)
                      if runner.loop_error is not None else None),
    }


def _run_scheduler(conn, url: str, cfg_dict: dict, warm: Optional[dict],
                   identity: str, device) -> None:
    """Subprocess entry: a full SchedulerRunner against ``url``. Phase
    timings ride the ready dict so a caller can attribute the recovery
    window (import vs sync vs warm); the warm phase runs BEFORE the loop
    starts, mirroring how the benches warm (and how a production boot
    would: never judge live pods with a half-built ladder)."""
    t_entry = time.monotonic()
    import faulthandler
    faulthandler.enable()  # a native abort must leave thread tracebacks
    from kubernetes_tpu_torch.client.clientset import HTTPClient
    from kubernetes_tpu_torch.config.types import SchedulerConfiguration
    from kubernetes_tpu_torch.sched.runner import SchedulerRunner
    t_import = time.monotonic()
    cfg = SchedulerConfiguration.from_dict(cfg_dict or {})
    runner = SchedulerRunner(HTTPClient(url), cfg, identity=identity,
                             device=device)
    t_runner = time.monotonic()
    runner.start(wait_sync=60.0, start_loop=False)
    t_sync = time.monotonic()
    warm_report = None
    if warm:
        from kubernetes_tpu_torch.testing.wrappers import make_pod
        n = int(warm.get("pods", 32))
        sample = [make_pod(f"warmup-{i}", "default")
                  .req(dict(warm.get("requests")
                            or {"cpu": "100m", "memory": "64Mi"})).obj()
                  for i in range(n)]
        armed = runner.scheduler.warm_drain(
            sample, slot_headroom=n + cfg.batch_size * cfg.max_drain_batches)
        warm_report = {"armed": bool(armed), "pods": n,
                       "ladder": runner.scheduler.warm_stats}
    t_warm = time.monotonic()
    runner.start_loop()
    if runner.aot_cache is not None:
        runner.aot_cache.seal()  # entries the boot just wrote
    ready = {
        "ready": True,
        "importMs": round((t_import - t_entry) * 1000.0, 1),
        # the runner's construction: on the card, the CUDA context and the
        # kernel libraries (built cold, loaded warm)
        "runnerMs": round((t_runner - t_import) * 1000.0, 1),
        "syncMs": round((t_sync - t_runner) * 1000.0, 1),
        "warmMs": round((t_warm - t_sync) * 1000.0, 1),
        "warm": warm_report,
        "aotCacheBoot": (dict(runner.aot_cache.boot)
                         if runner.aot_cache is not None else None),
    }

    stop = threading.Event()

    def serve():
        try:
            conn.send(ready)
            while True:
                msg = conn.recv()
                if msg == "stats":
                    conn.send(_child_stats(runner))
                else:
                    return  # anything else = graceful stop
        except (EOFError, OSError):
            return  # parent died/killed us-adjacent; just stop
        finally:
            stop.set()

    t = threading.Thread(target=serve, daemon=True, name="chaos-pipe")
    t.start()
    stop.wait()
    try:
        runner.stop()
    finally:
        try:
            conn.send("stopped")
        except (BrokenPipeError, OSError):
            pass


class SchedulerProcess:
    """Subprocess scheduler with kill/restart lifecycle against a stable
    apiserver URL. ``cfg`` is the YAML-shaped config dict the child's
    SchedulerConfiguration.from_dict parses (so an ``aotCacheDir``
    pointing at durable storage makes restarts warm); ``warm`` requests a
    pre-loop warm ladder: ``{"pods": N, "requests": {...}}``. ``device``
    is the child runner's device (None: the card)."""

    def __init__(self, url: str, cfg: Optional[dict] = None,
                 warm: Optional[dict] = None,
                 identity: str = "kubernetes-tpu-scheduler", device=None):
        self.url = url
        self.cfg = dict(cfg or {})
        self.warm = warm
        self.identity = identity
        self.device = None if device is None else str(device)
        self.restarts = 0
        self.ready: Optional[dict] = None
        self._ctx = mp.get_context("spawn")
        self._proc = None
        self._conn = None

    def start(self, ready_timeout: float = 180.0) -> dict:
        """Spawn + wait for the loop-live ready dict (phase timings and
        the kernel cache's boot report). Raises on timeout: a scheduler
        that never came up is a failed restart, and a missing readiness
        number must never read as a fast one."""
        if self._proc is not None and self._proc.is_alive():
            raise RuntimeError("scheduler process already running")
        parent, child = self._ctx.Pipe()
        self._proc = self._ctx.Process(
            target=_run_scheduler,
            args=(child, self.url, self.cfg, self.warm, self.identity,
                  self.device),
            daemon=True)
        self._proc.start()
        self._conn = parent
        if not parent.poll(ready_timeout):
            raise TimeoutError(
                f"scheduler subprocess not ready within {ready_timeout}s")
        self.ready = parent.recv()
        return self.ready

    @property
    def alive(self) -> bool:
        return self._proc is not None and self._proc.is_alive()

    def stats(self, timeout: float = 30.0) -> dict:
        """Round-trip the child's live gate numbers (kernel cache, graphs,
        audit violations, parity). Raises on a dead/unresponsive child —
        the gates must read real numbers or fail."""
        if not self.alive:
            raise RuntimeError("scheduler process is not running")
        self._conn.send("stats")
        if not self._conn.poll(timeout):
            raise TimeoutError(f"no stats reply within {timeout}s")
        return self._conn.recv()

    def kill(self) -> None:
        """SIGKILL — assumed pods never confirm, in-flight binds tear,
        nominations go stale. The crash the boot resync exists for."""
        if self._proc is not None:
            self._proc.kill()
            self._proc.join(timeout=10.0)

    def stop(self, timeout: float = 30.0) -> None:
        """Graceful: the child's runner.stop() drains threads first."""
        if self._proc is None:
            return
        if self._proc.is_alive():
            try:
                self._conn.send("stop")
                self._conn.poll(timeout)
            except (BrokenPipeError, OSError):
                pass
            self._proc.join(timeout=timeout)
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=5.0)

    def restart(self, ready_timeout: float = 180.0,
                graceful: bool = False) -> float:
        """Bounce the scheduler (default: SIGKILL) and bring a fresh
        process up against the same apiserver -> seconds from restart
        begin to the new loop being live (``self.ready`` holds the new
        incarnation's phase timings)."""
        t0 = time.monotonic()
        if graceful:
            self.stop()
        else:
            self.kill()
        self._proc = None
        self.restarts += 1
        self.start(ready_timeout)
        return time.monotonic() - t0
