"""Fault schedules — the deterministic heart of the chaos harness.

A schedule is a list of :class:`Fault` entries addressed by *site* (a
dotted name like ``api.bind`` or ``device.drain``) and *op index* (the
N-th operation at that site since install). Every injection point keeps a
per-site counter, so a schedule generated from a seed replays exactly:
same seed, same workload -> same faults at the same operations. Any chaos
failure is therefore reproducible from the one logged seed
(``KTPU_CHAOS_SEED``), the lesson upstream encodes with
``--randomize-with-seed`` in its e2e chaos jobs.

The schedule also doubles as the recovery ledger: injection wrappers call
:meth:`FaultSchedule.note_ok` after the first healthy operation at a site,
which stamps per-fault-class recovery spans — the numbers the ChaosChurn
bench records to its JSON.
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

# Fault kinds by seam:
#   api.*     error (arg = HTTP code, default 503), conflict (409),
#             latency (arg = seconds)
#   watch.*   too_old (force a "resourceVersion too old" relist),
#             drop (deliver arg events, then truncate the stream)
#   device.*  compile / runtime (raise a non-fatal device error from the
#             patched program entry, chaos/device.py)
#   thread.*  stall (sleep arg seconds at the hook), die (raise a
#             BaseException that kills the thread), error (raise a
#             catchable chaos error)
API_KINDS = ("error", "conflict", "latency")
WATCH_KINDS = ("too_old", "drop")
DEVICE_KINDS = ("compile", "runtime")
THREAD_KINDS = ("stall", "die", "error")


@dataclass
class Fault:
    site: str            # injection seam, e.g. "api.bind", "watch.pods"
    kind: str            # fault kind (see the tables above)
    at: int              # 0-based op index at the site when it fires
    count: int = 1       # consecutive ops affected from ``at``
    arg: float = 0.0     # kind-specific: HTTP code / seconds / events

    @property
    def klass(self) -> str:
        """Fault class for recovery reporting, e.g. ``api.bind:error``."""
        return f"{self.site}:{self.kind}"


class FaultSchedule:
    """Thread-safe, replayable fault schedule with a recovery ledger.

    ``should_fire(site)`` advances the site's op counter and returns the
    matching :class:`Fault` (or None). ``note_ok(site)`` marks the site
    healthy again — the span from the first un-recovered fire to that call
    is the fault class's recovery span.
    """

    def __init__(self, faults: list[Fault], seed: int = 0):
        self.seed = seed
        self.faults = list(faults)
        self._by_site: dict[str, list[Fault]] = {}
        for f in self.faults:
            self._by_site.setdefault(f.site, []).append(f)
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        # fire log: (klass, site, op, t); _open holds the earliest
        # un-recovered fire time per site
        self._fires: list[tuple[str, str, int, float]] = []
        self._open: dict[str, tuple[str, float]] = {}
        self._recovery: dict[str, list[float]] = {}

    # ---- injection-side API ---------------------------------------------

    def should_fire(self, site: str) -> Optional[Fault]:
        with self._lock:
            n = self._counters.get(site, 0)
            self._counters[site] = n + 1
            for f in self._by_site.get(site, ()):
                if f.at <= n < f.at + f.count:
                    self._fires.append((f.klass, site, n, time.time()))
                    # first fire of an outage window opens the recovery span
                    self._open.setdefault(site, (f.klass, time.time()))
                    return f
        return None

    def note_ok(self, site: str) -> None:
        """First healthy operation after an outage closes its span."""
        with self._lock:
            opened = self._open.pop(site, None)
            if opened is not None:
                klass, t0 = opened
                self._recovery.setdefault(klass, []).append(
                    time.time() - t0)

    def peek(self, site: str) -> int:
        """Current op counter at a site (diagnostics only)."""
        with self._lock:
            return self._counters.get(site, 0)

    # ---- reporting -------------------------------------------------------

    def report(self) -> dict:
        """Per-fault-class injection + recovery summary (bench JSON)."""
        with self._lock:
            fires: dict[str, int] = {}
            for klass, _site, _op, _t in self._fires:
                fires[klass] = fires.get(klass, 0) + 1
            classes = {}
            for klass in sorted(set(fires) | set(self._recovery)):
                spans = self._recovery.get(klass, [])
                classes[klass] = {
                    "fires": fires.get(klass, 0),
                    "recovered": len(spans),
                    "max_recovery_s": round(max(spans), 3) if spans else None,
                    "mean_recovery_s": (round(sum(spans) / len(spans), 3)
                                        if spans else None),
                }
            return {
                "seed": self.seed,
                "total_fires": len(self._fires),
                "unrecovered_sites": sorted(self._open),
                "classes": classes,
            }

    # ---- generation ------------------------------------------------------

    @classmethod
    def generate(cls, seed: int, profile: str = "default",
                 breaker_threshold: int = 3) -> "FaultSchedule":
        """Deterministic default schedule: one seeded draw covers every
        seam — API errors/conflicts/latency on the write verbs, watch
        stream truncation + a forced too-old gap, a device-error burst
        long enough to trip the circuit breaker, and thread stalls on the
        loop and resolver. ``profile`` picks intensity: ``default`` for
        tests, ``churn`` for the ChaosChurn bench (faults spread over a
        longer run)."""
        rng = random.Random(seed)
        churn = profile == "churn"
        # op offsets scale with the run length so bench faults land inside
        # the measured window, not all in the first second
        span = 200 if churn else 8
        faults: list[Fault] = [
            # API transport: unavailability + optimistic-concurrency storms
            Fault("api.create", "error", rng.randrange(1, span), 2, 503),
            Fault("api.bind", "error", rng.randrange(1, span), 2, 503),
            Fault("api.bind", "conflict", rng.randrange(span, 2 * span)),
            Fault("api.update", "latency", rng.randrange(1, span), 1,
                  0.05 if not churn else 0.2),
            Fault("api.update_status", "error", rng.randrange(1, span), 1,
                  500),
            # watch streams: truncation (relist heals the gap) + a forced
            # "resourceVersion too old" on a later re-establish
            Fault("watch.pods", "drop", 1, 1, rng.randrange(2, 12)),
            Fault("watch.pods", "too_old", 2),
            Fault("watch.nodes", "drop", 1, 1, rng.randrange(2, 12)),
            # device: a burst of consecutive failures long enough to trip
            # one breaker level, then heal (half-open restores)
            Fault("device.gang", "runtime",
                  rng.randrange(1, 4), breaker_threshold),
            Fault("device.drain", "runtime",
                  rng.randrange(1, 4), breaker_threshold),
            # threads: a short resolver stall (bounded-wait fallback) and
            # a loop hiccup the self-healing run loop absorbs
            Fault("thread.resolver", "stall", rng.randrange(1, span), 1,
                  0.2 if not churn else 0.5),
            Fault("thread.loop", "error", rng.randrange(2, span)),
        ]
        return cls(faults, seed=seed)


def seed_from_env(default: int = 0) -> int:
    """The chaos seed contract: ``KTPU_CHAOS_SEED`` wins, else ``default``.
    Callers must LOG the seed they ran with — a chaos failure without its
    seed cannot be replayed."""
    try:
        return int(os.environ.get("KTPU_CHAOS_SEED", str(default)))
    except ValueError:
        return default
