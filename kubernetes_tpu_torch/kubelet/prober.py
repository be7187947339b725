"""Probe manager — liveness / readiness / startup workers.

Reference: ``pkg/kubelet/prober/`` (``prober_manager.go`` ``Manager``:
one worker goroutine per (pod, container, probe type); ``worker.go``
threshold accounting: ``failureThreshold`` consecutive failures flip the
result, ``successThreshold`` consecutive successes flip it back;
``results_manager.go`` caches consulted by the status manager).

Semantics mirrored:
- startup probe gates the other two: until it succeeds once, liveness and
  readiness don't run and readiness is False.
- liveness (or startup) failure -> the kubelet kills the container; the
  restart policy decides whether SyncPod restarts it.
- readiness failure -> Ready/ContainersReady conditions go False; the
  endpoints/endpointslice controllers then drop the pod from Services.

Probe execution delegates to ``ContainerRuntime.probe`` (the exec/http/tcp
handler analog — the hollow runtime reports its ``healthy`` flag).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

LIVENESS, READINESS, STARTUP = "liveness", "readiness", "startup"
_SPEC_KEYS = {LIVENESS: "livenessProbe", READINESS: "readinessProbe",
              STARTUP: "startupProbe"}


@dataclass
class ProbeSpec:
    period_s: float = 10.0
    initial_delay_s: float = 0.0
    failure_threshold: int = 3
    success_threshold: int = 1

    @classmethod
    def from_dict(cls, d: dict) -> "ProbeSpec":
        return cls(
            period_s=float(d.get("periodSeconds", 10)),
            initial_delay_s=float(d.get("initialDelaySeconds", 0)),
            failure_threshold=int(d.get("failureThreshold", 3)),
            success_threshold=int(d.get("successThreshold", 1)),
        )


@dataclass
class _Worker:
    pod_uid: str
    container: str
    kind: str
    spec: ProbeSpec
    result: bool = False      # readiness/startup start False, liveness True
    successes: int = 0
    failures: int = 0
    started_at: float = field(default_factory=time.time)
    last_run: float = 0.0


class ProbeManager:
    """Drives every configured probe from one timer thread (the per-worker
    goroutines collapse into a tick over due workers — same thresholds,
    fewer threads for hollow-node density)."""

    def __init__(self, runtime, on_liveness_failure: Callable[[str, str], None],
                 on_readiness_change: Optional[Callable[[str], None]] = None,
                 tick_s: float = 0.2):
        self.runtime = runtime
        self.on_liveness_failure = on_liveness_failure  # (pod_uid, container)
        self.on_readiness_change = on_readiness_change  # (pod_uid)
        self.tick_s = tick_s
        self._lock = threading.Lock()
        self._workers: dict[tuple, _Worker] = {}  # (uid, container, kind)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- pod lifecycle ---------------------------------------------------

    def add_pod(self, pod: dict) -> None:
        uid = (pod.get("metadata") or {}).get("uid", "")
        spec = pod.get("spec") or {}
        with self._lock:
            for c in spec.get("containers") or []:
                cname = c.get("name", "c")
                for kind, key in _SPEC_KEYS.items():
                    if c.get(key) is None:
                        self._workers.pop((uid, cname, kind), None)
                        continue
                    wkey = (uid, cname, kind)
                    if wkey not in self._workers:
                        w = _Worker(uid, cname, kind,
                                    ProbeSpec.from_dict(c[key]))
                        w.result = kind == LIVENESS  # assume alive until proven dead
                        self._workers[wkey] = w

    def remove_pod(self, pod_uid: str) -> None:
        with self._lock:
            for k in [k for k in self._workers if k[0] == pod_uid]:
                del self._workers[k]

    def container_restarted(self, pod_uid: str, container: str) -> None:
        """Reset probe state for a restarted container (worker restart in
        the reference: onHold cleared, counters zeroed)."""
        with self._lock:
            for kind in (LIVENESS, READINESS, STARTUP):
                w = self._workers.get((pod_uid, container, kind))
                if w is not None:
                    w.result = kind == LIVENESS
                    w.successes = w.failures = 0
                    w.started_at = time.time()

    # ---- results (status manager reads these) ----------------------------

    def _startup_done(self, uid: str, cname: str) -> bool:
        w = self._workers.get((uid, cname, STARTUP))
        return w is None or w.result

    def container_ready(self, pod_uid: str, container: str) -> bool:
        with self._lock:
            if not self._startup_done(pod_uid, container):
                return False
            w = self._workers.get((pod_uid, container, READINESS))
            return w is None or w.result

    def pod_ready(self, pod: dict) -> bool:
        """Every container with a readiness/startup probe reports ready."""
        uid = (pod.get("metadata") or {}).get("uid", "")
        for c in (pod.get("spec") or {}).get("containers") or []:
            if not self.container_ready(uid, c.get("name", "c")):
                return False
        return True

    # ---- the tick --------------------------------------------------------

    def start(self) -> "ProbeManager":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="probe-manager")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _loop(self) -> None:
        while not self._stop.wait(self.tick_s):
            now = time.time()
            with self._lock:
                due = [w for w in self._workers.values()
                       if now - w.last_run >= w.spec.period_s
                       and now - w.started_at >= w.spec.initial_delay_s]
            for w in due:
                self._run_one(w, now)

    def _run_one(self, w: _Worker, now: float) -> None:
        w.last_run = now
        if w.kind == STARTUP and w.result:
            # the reference STOPS the startup worker once it succeeds:
            # post-startup health is the liveness probe's judgement alone
            return
        if w.kind in (LIVENESS, READINESS) and not self._startup_done(
                w.pod_uid, w.container):
            return  # startup gates the other probes
        try:
            ok = bool(self.runtime.probe(w.pod_uid, w.container))
        except Exception:  # ktpu-lint: disable=KTL002 -- probe failure = unhealthy verdict consumed below; transitions are recorded by the prober
            ok = False
        changed = False
        if ok:
            w.successes += 1
            w.failures = 0
            if not w.result and w.successes >= w.spec.success_threshold:
                w.result = True
                changed = True
        else:
            w.failures += 1
            w.successes = 0
            if w.result and w.failures >= w.spec.failure_threshold:
                w.result = False
                changed = True
            elif not w.result and w.kind in (LIVENESS, STARTUP) \
                    and w.failures == w.spec.failure_threshold:
                changed = True  # startup/liveness never succeeded: still kill
        if not changed:
            return
        if w.kind in (LIVENESS, STARTUP) and not w.result:
            self.on_liveness_failure(w.pod_uid, w.container)
        if w.kind in (READINESS, STARTUP) and self.on_readiness_change:
            self.on_readiness_change(w.pod_uid)
