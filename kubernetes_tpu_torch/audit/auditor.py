"""Background invariant auditor — sweep, confirm, report, fail loudly.

One sweep = capture an :class:`AuditSnapshot` (consistent apiserver list +
scheduler cache/ctx views), run every invariant, and feed the candidates
through the confirm engine (a candidate must reappear with the same
fingerprint for ``confirm`` CONSECUTIVE sweeps before it is reported —
live state is legitimately in flux). A confirmed violation:

- increments ``scheduler_invariant_violations_total{invariant}``,
- writes a replayable repro bundle (chaos seed, offending objects, the
  pending pod batch, snapshot rv) to ``audit_dir``,
- and in fail-fast mode raises :class:`InvariantViolationError` — the
  BENCH_r05 ``parsed: null`` lesson applied to the scheduler itself:
  correctness regressions fail the run, they do not sit latent.

The port of ``kubernetes_tpu/audit/auditor.py``: beside each bundle it
writes the incident's replayable trace (``scenario/record.py``), and the
bundle's seed is the installed chaos schedule's (``chaos/hooks.py``), else
``KTPU_CHAOS_SEED``. Each sweep is traced as ``audit/sweep``.
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading
import time
from typing import Callable, Optional

from kubernetes_tpu_torch.audit.invariants import (
    AuditSnapshot,
    Violation,
    run_invariants,
)
from kubernetes_tpu_torch.metrics.registry import (
    AUDIT_SWEEPS,
    INVARIANT_VIOLATIONS,
    LOOP_ERRORS,
)
from kubernetes_tpu_torch.utils.tracing import TRACER

_LOG = logging.getLogger(__name__)

# bundles kept on disk (oldest rotated out); one chaos run can confirm the
# same corruption from several invariants, so keep a healthy window
MAX_BUNDLES = 100


class InvariantViolationError(AssertionError):
    """Raised by fail-fast audits; carries the confirmed violations."""

    def __init__(self, violations: list[Violation]):
        self.violations = violations
        super().__init__("; ".join(
            f"[{v.invariant}] {v.detail}" for v in violations))


def active_chaos_seed() -> Optional[int]:
    """Seed of the chaos schedule currently installed (or the env replay
    seed) — the one number that makes a repro bundle replayable."""
    try:
        from kubernetes_tpu_torch.chaos import hooks
        c = getattr(hooks, "_ACTIVE", None)
        if c is not None:
            return c.schedule.seed
    except Exception:  # ktpu-lint: disable=KTL002 -- the chaos module may legitimately be absent/uninstalled; the env fallback below is the answer either way
        pass
    env = os.environ.get("KTPU_CHAOS_SEED")
    try:
        return int(env) if env else None
    except ValueError:
        return None


def default_audit_dir() -> str:
    return (os.environ.get("KTPU_AUDIT_DIR")
            or os.path.join(tempfile.gettempdir(), "ktpu-audit"))


def write_bundle(audit_dir: str, name: str, payload: dict) -> Optional[str]:
    """Write one repro bundle; rotate the oldest past MAX_BUNDLES. Best
    effort on IO — the bundle is evidence, not a dependency — but the
    failure itself is logged, never swallowed."""
    try:
        os.makedirs(audit_dir, exist_ok=True)
        fname = f"audit-{time.time():.3f}-{name}.json"
        path = os.path.join(audit_dir, fname)
        from kubernetes_tpu_torch.utils.atomicio import atomic_write_json
        # the bundle is evidence of a violation: a torn half-bundle from a
        # crash mid-write would be evidence that lies — commit atomically
        atomic_write_json(path, payload, indent=1, default=str)
        bundles = sorted(f for f in os.listdir(audit_dir)
                         if f.startswith("audit-") and f.endswith(".json"))
        for old in bundles[:-MAX_BUNDLES]:
            try:
                os.remove(os.path.join(audit_dir, old))
            except OSError:
                pass
        return path
    except Exception:
        LOOP_ERRORS.inc({"site": "audit_bundle"})
        _LOG.exception("repro bundle write failed (dir %s)", audit_dir)
        return None


class InvariantAuditor:
    """Continuous auditor over a client + (optionally) the scheduler's
    cache and resident-context views. ``client`` may be None for
    cache-only embedders (API-side invariants are skipped)."""

    def __init__(self, client=None, cache=None, scheduler=None, *,
                 interval_s: float = 30.0, fail_fast: bool = False,
                 audit_dir: Optional[str] = None,
                 pre_sweep: Optional[Callable[[], object]] = None,
                 post_sweep: Optional[Callable[[], object]] = None,
                 relists: Optional[Callable[[], int]] = None):
        self.client = client
        self.cache = cache
        self.scheduler = scheduler
        self.interval_s = float(interval_s)
        self.fail_fast = fail_fast
        self.audit_dir = audit_dir or default_audit_dir()
        # runs at the top of every sweep (the runner hooks its
        # stale-nomination GC here so the sweep judges the POST-GC state)
        self._pre_sweep = pre_sweep
        # runs after every background sweep, violations included (the
        # runner hooks publish_status here — the ConfigMap an operator's
        # ``ktpu audit status`` reads must reflect the LATEST sweep, not
        # the start-time snapshot)
        self._post_sweep = post_sweep
        # informer relist counter: a sweep that observes relists in flight
        # skips cache_parity (an outage-lagged cache is healing, not wrong)
        self._relists = relists
        self._last_relists: Optional[int] = None
        self._lock = threading.Lock()
        # confirm engine: fingerprint -> consecutive sweeps seen
        self._streak: dict[tuple, int] = {}  # guarded by: self._lock
        self._reported: set = set()  # guarded by: self._lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.sweeps = 0  # guarded by: self._lock
        self.last_sweep_ts: Optional[float] = None  # guarded by: self._lock
        self.violations: list[Violation] = []  # guarded by: self._lock
        self.by_invariant: dict[str, int] = {}  # guarded by: self._lock
        self.bundles: list[str] = []  # guarded by: self._lock
        self.traces: list[str] = []  # guarded by: self._lock
        self.failed = False  # guarded by: self._lock

    # ---- one sweep -------------------------------------------------------

    def snapshot(self) -> AuditSnapshot:
        if self.client is not None:
            return AuditSnapshot.capture(self.client, self.cache,
                                         self.scheduler)
        # client-less embedders: API views empty, cache/ctx checks only
        snap = AuditSnapshot(ts=time.time(), rv=None, api_pods=[],
                             api_nodes=[])
        if self.cache is not None:
            snap.cache = self.cache.audit_view()
        return snap

    def run_once(self) -> list[Violation]:
        """One sweep. Returns the NEWLY confirmed violations (and raises
        with them in fail-fast mode)."""
        with TRACER.span("audit/sweep"):
            return self._sweep()

    def _sweep(self) -> list[Violation]:
        if self._pre_sweep is not None:
            try:
                self._pre_sweep()
            except Exception:
                LOOP_ERRORS.inc({"site": "audit_pre_sweep"})
                _LOG.exception("audit pre-sweep hook failed")
        skip = None
        if self._relists is not None:
            try:
                now = self._relists()
            except Exception:  # ktpu-lint: disable=KTL002 -- a broken relist probe only disables the cache_parity skip heuristic; the sweep itself proceeds
                now = None
            if now is not None and now != self._last_relists:
                if self._last_relists is not None:
                    skip = {"cache_parity"}
                self._last_relists = now
        snap = self.snapshot()
        candidates = run_invariants(snap, skip=skip)
        with self._lock:
            streak: dict[tuple, int] = {}
            confirmed: list[Violation] = []
            for v in candidates:
                n = self._streak.get(v.fingerprint, 0) + 1
                streak[v.fingerprint] = n
                if n >= v.confirm:
                    confirmed.append(v)
            self._streak = streak
            fresh = [v for v in confirmed
                     if v.fingerprint not in self._reported]
            # a fingerprint that vanished may be re-reported if it returns
            self._reported = {fp for fp in self._reported if fp in streak}
            self._reported.update(v.fingerprint for v in fresh)
            self.sweeps += 1
            self.last_sweep_ts = snap.ts
        AUDIT_SWEEPS.inc()
        for v in fresh:
            INVARIANT_VIOLATIONS.inc({"invariant": v.invariant})
            with self._lock:
                self.violations.append(v)
                self.by_invariant[v.invariant] = \
                    self.by_invariant.get(v.invariant, 0) + 1
            path = write_bundle(self.audit_dir, v.invariant,
                                self._bundle_payload(v, snap))
            trace_path = None
            if path:
                with self._lock:
                    self.bundles.append(path)
                    del self.bundles[:-MAX_BUNDLES]
                trace_path = self._emit_trace(path)
                if trace_path:
                    with self._lock:
                        self.traces.append(trace_path)
                        del self.traces[:-MAX_BUNDLES]
            _LOG.error("INVARIANT VIOLATION [%s]: %s (repro bundle: %s, "
                       "incident trace: %s)",
                       v.invariant, v.detail, path or "<write failed>",
                       trace_path or "<none>")
        if fresh and self.fail_fast:
            with self._lock:  # embedding benches poll .failed cross-thread
                self.failed = True
            raise InvariantViolationError(fresh)
        return fresh

    def _emit_trace(self, bundle_path: str) -> Optional[str]:
        """Auto-emit the replayable incident trace next to the repro
        bundle — the same conversion ``ktpu scenario record --from-bundle``
        runs, so every tripped invariant ships with a scenario replay of
        its pending batch under the violation-time chaos seed. Best
        effort: the bundle is the evidence, the trace is a convenience."""
        try:
            from kubernetes_tpu_torch.scenario.record import (
                TraceFormatError,
                trace_from_bundle,
            )
            try:
                trace = trace_from_bundle(bundle_path)
            except TraceFormatError:
                return None  # no pending batch: nothing to replay
            fname = os.path.basename(bundle_path)
            path = os.path.join(
                os.path.dirname(bundle_path),
                "incident-" + fname[len("audit-"):-len(".json")]
                + ".trace.jsonl")
            trace.save(path)
            # rotate incident traces alongside their bundles
            traces = sorted(
                f for f in os.listdir(os.path.dirname(bundle_path))
                if f.startswith("incident-") and f.endswith(".trace.jsonl"))
            for old in traces[:-MAX_BUNDLES]:
                try:
                    os.remove(os.path.join(os.path.dirname(bundle_path),
                                           old))
                except OSError:
                    pass
            return path
        except Exception:
            LOOP_ERRORS.inc({"site": "audit_trace"})
            _LOG.exception("incident trace emit failed (%s)", bundle_path)
            return None

    def _bundle_payload(self, v: Violation, snap: AuditSnapshot) -> dict:
        pending_batch = [p for p in snap.api_pods
                         if not (p.get("spec") or {}).get("nodeName")
                         and (p.get("status") or {}).get("phase")
                         not in ("Succeeded", "Failed")]
        return {
            "ts": snap.ts,
            "invariant": v.invariant,
            "detail": v.detail,
            "chaosSeed": active_chaos_seed(),
            "resourceVersion": snap.rv,
            "objects": v.objects,
            # the pending pod batch at violation time: replaying the
            # chaos seed against this batch reproduces the cycle
            "podBatch": sorted(
                f"{(p.get('metadata') or {}).get('namespace', 'default')}"
                f"/{(p.get('metadata') or {}).get('name', '')}"
                for p in pending_batch)[:500],
            "cache": {k: (sorted(vv) if isinstance(vv, set) else vv)
                      for k, vv in (snap.cache or {}).items()
                      if k in ("nodes", "generation")},
            "ctx": ({k: vv for k, vv in snap.ctx.items() if k != "folded"}
                    if snap.ctx else None),
        }

    # ---- lifecycle -------------------------------------------------------

    def start(self) -> "InvariantAuditor":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                stop_loop = False
                try:
                    self.run_once()
                except InvariantViolationError:
                    # fail-fast: the violation is recorded + bundled; stop
                    # the loop LOUDLY (a broken invariant does not heal by
                    # re-checking) — the embedding bench/test reads
                    # ``failed`` and fails the run
                    _LOG.critical("fail-fast audit stopping after a "
                                  "confirmed invariant violation")
                    stop_loop = True
                except Exception:
                    LOOP_ERRORS.inc({"site": "audit_sweep"})
                    _LOG.exception("audit sweep failed; continuing")
                if self._post_sweep is not None:
                    try:
                        self._post_sweep()
                    except Exception:
                        LOOP_ERRORS.inc({"site": "audit_post_sweep"})
                        _LOG.exception("audit post-sweep hook failed")
                if stop_loop:
                    return
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="invariant-auditor")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    # ---- status ----------------------------------------------------------

    @property
    def total_violations(self) -> int:
        with self._lock:
            return len(self.violations)

    def status(self) -> dict:
        from kubernetes_tpu_torch.utils.clock import rfc3339_from_epoch
        with self._lock:
            return {
                "sweeps": self.sweeps,
                "lastSweep": (rfc3339_from_epoch(self.last_sweep_ts)
                              if self.last_sweep_ts else None),
                "intervalSeconds": self.interval_s,
                "failFast": self.fail_fast,
                "failed": self.failed,
                "violations": len(self.violations),
                "byInvariant": dict(self.by_invariant),
                "bundleDir": self.audit_dir,
                "bundles": list(self.bundles[-5:]),
                "incidentTraces": list(self.traces[-5:]),
            }
