"""Self-healing primitives for the connected loop: circuit breaker + watchdog.

Reference shape: the kubelet's runtime-health circuit (``kubelet.go``
runtimeState + the PLEG relist health check) and controller-runtime's
healthz-driven restarts — a component that depends on an unreliable
substrate (here: the device/XLA layer and its own threads) must degrade to
a slower-but-correct path and recover automatically, never hang or die.

``DeviceCircuitBreaker`` tracks consecutive device-program failures and
walks an ordered ladder of degradation levels (mesh -> single-device ->
pure-numpy oracle). After a cooldown it half-opens: exactly one cycle
probes the next-better level; a probe success restores it, a probe
failure restarts the cooldown — and either way the cycle's pods still
schedule (the caller falls back within the same cycle).

``ThreadWatchdog`` monitors registered threads via liveness + heartbeat:
a dead thread restarts immediately, a stalled one (heartbeat older than
``stall_s`` while the target reports work pending) is restarted through
its owner's restart callback. Both paths taint the device-resident drain
context — a thread that died mid-dispatch leaves the resident encoding
unaccountable.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Optional

from kubernetes_tpu_torch.metrics.registry import (
    BREAKER_TRIPS,
    DEGRADED_MODE,
    WATCHDOG_RESTARTS,
)
from kubernetes_tpu_torch.utils.clock import Clock, REAL_CLOCK

_LOG = logging.getLogger(__name__)


class DeviceCircuitBreaker:
    """Consecutive-failure breaker over an ordered ladder of levels.

    ``levels`` runs best -> worst, e.g. ``("mesh", "single", "oracle")``.
    Level 0 is healthy; each trip moves one level down. The last level is
    assumed to always work (the oracle is pure numpy)."""

    def __init__(self, levels=("mesh", "single", "oracle"),
                 threshold: int = 3, cooldown_s: float = 30.0,
                 clock: Optional[Clock] = None):
        self.levels = list(levels)
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self.clock = clock or REAL_CLOCK
        self._lock = threading.Lock()
        self._idx = 0
        self._fails = 0
        self._tripped_at: Optional[float] = None
        self._last_fail_at: Optional[float] = None
        self._probing = False
        self.trips = 0
        self.restores = 0
        # why each trip happened: "device" (program raised) vs "parity"
        # (the sentinel proved the program returned a WRONG answer). A
        # miscompile that yields garbage without raising is invisible to
        # fail(); trip_now is the sentinel's entry for it.
        self.trip_reasons: dict[str, int] = {}
        self.last_trip_reason: Optional[str] = None
        DEGRADED_MODE.set(0)

    # ---- state -----------------------------------------------------------

    @property
    def index(self) -> int:
        return self._idx

    @property
    def mode(self) -> str:
        return self.levels[self._idx]

    def reset_levels(self, levels) -> None:
        """Operator action (e.g. an explicit mesh install) resets the
        ladder and forgives history — the substrate changed."""
        with self._lock:
            self.levels = list(levels)
            self._idx = 0
            self._fails = 0
            self._tripped_at = None
            self._probing = False
            DEGRADED_MODE.set(0)

    # ---- per-cycle protocol ---------------------------------------------

    def attempt_level(self) -> str:
        """Level to attempt THIS cycle. Normally the current mode; when
        degraded and the cooldown has elapsed, the next-better level (the
        half-open probe). The probe keeps being offered until a device
        outcome lands — a cycle that happens to run no device program
        (empty pop, parked batch) must not consume the recovery window —
        and a probe FAILURE re-arms the cooldown in fail()."""
        with self._lock:
            if (self._idx > 0 and self._tripped_at is not None
                    and self.clock.now() - self._tripped_at
                    >= self.cooldown_s):
                self._probing = True
                return self.levels[self._idx - 1]
            return self.levels[self._idx]

    def succeed(self, level: str,
                dispatched_at: Optional[float] = None) -> None:
        """``dispatched_at``: when the succeeding work was DISPATCHED.
        A pipelined drain can land after newer dispatches already failed;
        such a stale success says nothing about the device NOW, so it
        must neither reset the consecutive-failure count nor pass a
        half-open probe."""
        with self._lock:
            if (dispatched_at is not None
                    and self._last_fail_at is not None
                    and dispatched_at < self._last_fail_at):
                return
            self._fails = 0
            try:
                li = self.levels.index(level)
            except ValueError:
                return
            if self._probing and li == self._idx - 1:
                # half-open probe passed: restore one level
                self._idx = li
                self.restores += 1
                self._probing = False
                self._tripped_at = (self.clock.now() if self._idx > 0
                                    else None)
                _LOG.warning("device circuit breaker: recovered to %r "
                             "(restores=%d)", self.mode, self.restores)
            DEGRADED_MODE.set(self._idx)

    def fail(self, level: str, reason: str = "device") -> str:
        """Record a device failure at ``level``; returns the (possibly
        newly degraded) mode."""
        with self._lock:
            self._last_fail_at = self.clock.now()
            try:
                li = self.levels.index(level)
            except ValueError:
                return self.mode
            if self._probing and li < self._idx:
                # failed probe: stay degraded, restart the cooldown
                self._probing = False
                self._tripped_at = self.clock.now()
                _LOG.warning("device circuit breaker: probe of %r failed; "
                             "staying %r", level, self.mode)
                return self.mode
            self._fails += 1
            if (self._fails >= self.threshold
                    and self._idx < len(self.levels) - 1):
                self._trip_locked(reason)
                _LOG.warning(
                    "device circuit breaker: %d consecutive device "
                    "failures -> degrading to %r (trips=%d)",
                    self.threshold, self.mode, self.trips)
            DEGRADED_MODE.set(self._idx)
            return self.mode

    def _trip_locked(self, reason: str) -> None:
        self._idx += 1
        self.trips += 1
        self._fails = 0
        self._tripped_at = self.clock.now()
        self.trip_reasons[reason] = self.trip_reasons.get(reason, 0) + 1
        self.last_trip_reason = reason
        BREAKER_TRIPS.inc({"reason": reason})

    def trip_now(self, level: str, reason: str = "parity") -> str:
        """Degrade one level IMMEDIATELY (no consecutive-failure count).
        The parity sentinel's entry: a device program that returned a
        provably WRONG answer is a miscompile, not a transient fault —
        waiting for ``threshold`` more wrong answers would bind pods onto
        overcommitted nodes in the meantime. Stale attributions — work
        dispatched at a level the breaker has since degraded past OR
        restored past (the verdict's level is no longer the active one)
        — are ignored: degrading the CURRENT level over an answer from a
        different one would punish a level nobody refuted. A wrong answer
        from a half-open probe re-arms the cooldown like any failed
        probe. Returns the resulting mode."""
        with self._lock:
            self._last_fail_at = self.clock.now()
            try:
                li = self.levels.index(level)
            except ValueError:
                return self.mode
            if self._probing and li < self._idx:
                self._probing = False
                self._tripped_at = self.clock.now()
                _LOG.warning("device circuit breaker: probe of %r returned "
                             "a wrong answer (%s); staying %r",
                             level, reason, self.mode)
                return self.mode
            if li != self._idx:
                return self.mode  # stale: that level is not active now
            if self._idx < len(self.levels) - 1:
                self._trip_locked(reason)
                _LOG.error(
                    "device circuit breaker: %s divergence at level %r -> "
                    "degrading to %r NOW (trips=%d)",
                    reason, level, self.mode, self.trips)
            DEGRADED_MODE.set(self._idx)
            return self.mode


class _Target:
    def __init__(self, name, is_alive, restart, busy):
        self.name = name
        self.is_alive = is_alive
        self.restart = restart
        self.busy = busy
        self.last_beat: Optional[float] = None
        self.restarting = False


class ThreadWatchdog:
    """Liveness + heartbeat monitor over registered threads."""

    def __init__(self, interval_s: float = 2.0, stall_s: float = 120.0,
                 clock: Optional[Clock] = None):
        self.interval_s = float(interval_s)
        self.stall_s = float(stall_s)
        self.clock = clock or REAL_CLOCK
        self._lock = threading.Lock()
        self._targets: dict[str, _Target] = {}  # guarded by: self._lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.restarts = 0  # guarded by: self._lock

    def register(self, name: str, is_alive: Callable[[], bool],
                 restart: Callable[[], "Optional[bool]"],
                 busy: Callable[[], bool] = lambda: True) -> None:
        """``is_alive``: False = thread is dead and should exist.
        ``busy``: stall detection only applies while True (an idle thread
        parked on a queue has no heartbeat to give). ``restart`` may
        return False to report that it only intervened (signaled a
        stalled thread, skipped a lost-leadership revive) without
        actually restarting — such sweeps are not counted as restarts."""
        with self._lock:
            t = _Target(name, is_alive, restart, busy)
            t.last_beat = self.clock.now()
            self._targets[name] = t

    def beat(self, name: str) -> None:
        t = self._targets.get(name)  # ktpu-lint: disable=KTL001 -- hot-path GIL-atomic read (resolver/loop threads beat per cycle); a raced registration misses at most one beat
        if t is not None:
            t.last_beat = self.clock.now()

    def check_once(self) -> list[str]:
        """One sweep; returns the names restarted (tests drive this
        directly instead of sleeping through intervals)."""
        restarted = []
        with self._lock:
            targets = list(self._targets.values())
        now = self.clock.now()
        for t in targets:
            try:
                dead = not t.is_alive()
                stalled = (not dead and t.busy()
                           and t.last_beat is not None
                           and now - t.last_beat > self.stall_s)
                if not (dead or stalled) or t.restarting:
                    continue
                t.restarting = True
                try:
                    _LOG.warning("watchdog: thread %r %s; intervening",
                                 t.name, "dead" if dead else "stalled")
                    did = t.restart()
                    if did is not False:
                        with self._lock:
                            self.restarts += 1
                        WATCHDOG_RESTARTS.inc({"thread": t.name})
                        restarted.append(t.name)
                    # reset the beat either way so a signaled-but-alive
                    # stall doesn't hot-loop the intervention every sweep
                    t.last_beat = self.clock.now()
                finally:
                    t.restarting = False
            except Exception:
                _LOG.exception("watchdog: restart of %r failed", t.name)
        return restarted

    def start(self) -> "ThreadWatchdog":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                self.check_once()
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="sched-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
