"""BackgroundPlanner — three planners, one cluster image.

One cadence drives the autoscaler's scale-up/scale-down simulation, the
descheduler's eviction planning, and gang defrag against the scheduler's
device-resident cluster encoding. The shared ``ResidentPlanner``
(encode/overlay.py) hands each planner a row-permuted overlay VIEW of the
live image — zero cold full encodes while the image is fresh — and every
staleness/taint/in-flight condition declines into the planner's
existing cold-encode path, which produces a bit-identical plan.

What this loop owns beyond calling the planners:

catalog sync
    The planners' cold-fallback encoders are pointed at the cache
    encoder's live DRA/volume catalogs each cycle (identity-compared:
    ``set_dra``/``set_volumes`` bump the encoder's pod epoch, so rewiring
    only happens on an actual catalog swap). A resident overlay and its
    cold baseline then gate claims identically.

compile accounting
    A ``CompileCounter`` window brackets every cycle past warmup: ``nvcc``
    builds and first-seen bucketed shapes of the planner programs
    (encode/overlay.py) landing inside the window count into
    ``scheduler_planner_compiles_total`` and the published status
    (``steadyCompiles``). The smoke's PlannerLoop phase fails if this is
    non-zero in the steady window.

status
    Per-planner overlay hit/decline tallies, cycle spans, and the
    steady-window compile count publish to the
    ``kubernetes-tpu-planner-status`` ConfigMap (``ktpu status`` renders
    the "Planners:" line from it; ``ktpu`` is not ported yet, ROADMAP
    Queue A item 10).

The PyTorch port of ``kubernetes_tpu/sched/bgplanner.py``. Unlike the
reference's, the loop of ``start`` stops for good on a failure that
``sched/faults.is_fatal`` calls fatal (``loop_error`` keeps it), and logs
only other failures.
"""

from __future__ import annotations

import json
import logging
import threading
from typing import Optional

from kubernetes_tpu_torch.encode.overlay import CompileCounter, ResidentPlanner
from kubernetes_tpu_torch.metrics.registry import (
    SCHEDULER_PLANNER_COMPILES,
    SCHEDULER_PLANNER_CYCLE_DURATION,
)
from kubernetes_tpu_torch.sched.faults import is_fatal
from kubernetes_tpu_torch.utils.clock import REAL_CLOCK, rfc3339_from_epoch
from kubernetes_tpu_torch.utils.tracing import TRACER

_LOG = logging.getLogger(__name__)

PLANNER_CONFIGMAP = "kubernetes-tpu-planner-status"
STATUS_NAMESPACE = "default"


class BackgroundPlanner:
    """The background planning cadence over one resident cluster image.

    ``scheduler`` is the live sched/scheduler.Scheduler (its
    ``resident_plan_view`` + cache feed the shared ResidentPlanner);
    ``autoscaler``/``descheduler`` are wired to that planner at
    construction; this cadence is their loop (neither has one of its own
    in the port), and gang defrag rides the descheduler's plan every
    cycle.
    """

    def __init__(self, client, scheduler, autoscaler=None, descheduler=None,
                 clock=None, descheduler_dry_run: bool = False,
                 warmup_cycles: int = 2):
        self.client = client
        self.scheduler = scheduler
        self.autoscaler = autoscaler
        self.descheduler = descheduler
        self.clock = clock or REAL_CLOCK
        self.descheduler_dry_run = descheduler_dry_run
        self.warmup_cycles = warmup_cycles
        self.resident = ResidentPlanner(scheduler.resident_plan_view,
                                        scheduler.cache)
        if autoscaler is not None:
            autoscaler.resident = self.resident
        if descheduler is not None:
            descheduler.resident = self.resident
        self.compiles = CompileCounter()
        self.cycles = 0
        self.steady_compiles = 0
        self.interval: Optional[float] = None
        self._spans: dict[str, float] = {}
        self._last: dict = {"cycle": None}
        self.loop_error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- catalog sync ----------------------------------------------------

    def _sync_catalogs(self) -> None:
        cache = self.scheduler.cache
        dra = cache.dra_catalog
        vols = cache.volume_catalog
        for planner in (self.autoscaler, self.descheduler):
            enc = getattr(planner, "encoder", None)
            if enc is None:
                continue
            if dra is not None and enc.dra is not dra:
                enc.set_dra(dra)
            if vols is not None and enc.volumes is not vols:
                enc.set_volumes(vols)

    # ---- one cycle -------------------------------------------------------

    def run_once(self) -> dict:
        """One planning cycle: autoscaler RunOnce then descheduler RunOnce
        (which includes gang defrag), with the steady-window compile gate
        armed once past warmup. Returns a cycle summary."""
        summary: dict = {"cycle": self.cycles}
        self._sync_catalogs()
        steady = self.cycles >= self.warmup_cycles
        before = self.compiles.take()
        if steady:
            self.compiles.arm()
        try:
            if self.autoscaler is not None:
                t0 = self.clock.now()
                with TRACER.span("planner/autoscaler"), \
                        SCHEDULER_PLANNER_CYCLE_DURATION.time(
                            {"planner": "autoscaler"}):
                    summary["autoscaler"] = self.autoscaler.run_once()
                self._spans["autoscaler"] = self.clock.now() - t0
            if self.descheduler is not None:
                t0 = self.clock.now()
                with TRACER.span("planner/descheduler"), \
                        SCHEDULER_PLANNER_CYCLE_DURATION.time(
                            {"planner": "descheduler"}):
                    summary["descheduler"] = self.descheduler.run_once(
                        dry_run=self.descheduler_dry_run)
                self._spans["descheduler"] = self.clock.now() - t0
        finally:
            if steady:
                self.compiles.disarm()
                fresh = self.compiles.take() - before
                if fresh:
                    SCHEDULER_PLANNER_COMPILES.inc(by=fresh)
                    self.steady_compiles += fresh
                summary["steadyCompiles"] = fresh
        self.cycles += 1
        self._last["cycle"] = {
            "at": rfc3339_from_epoch(self.clock.now()),
            "steady": steady,
            "spans": dict(self._spans),
        }
        self._publish_status(summary)
        return summary

    # ---- status ----------------------------------------------------------

    def status(self) -> dict:
        stats = self.resident.stats()
        planners = {}
        for name in ("autoscaler", "descheduler", "gangDefrag"):
            planners[name] = {
                "hits": stats["hits"].get(name, 0),
                "declines": sum(stats["declines"].get(name, {}).values()),
                "declineReasons": dict(stats["declines"].get(name, {})),
                "lastCycleSeconds": self._spans.get(name),
            }
        return {
            "cycles": self.cycles,
            "warmupCycles": self.warmup_cycles,
            "intervalSeconds": self.interval,
            "steadyCompiles": self.steady_compiles,
            "planners": planners,
            "lastCycle": self._last["cycle"],
        }

    def _publish_status(self, summary: dict) -> None:
        from kubernetes_tpu_torch.utils.configmap import upsert_configmap
        upsert_configmap(
            self.client, STATUS_NAMESPACE, PLANNER_CONFIGMAP,
            {"status": json.dumps(self.status(), indent=1),
             "lastProbeTime": rfc3339_from_epoch(self.clock.now())},
            site="planner_publish")

    # ---- loop ------------------------------------------------------------

    def start(self, interval: float = 2.0) -> "BackgroundPlanner":
        self.interval = interval

        def loop():
            while not self._stop.is_set():
                try:
                    self.run_once()
                except Exception as e:
                    if not is_fatal(e):
                        _LOG.exception("background planner cycle failed")
                    else:
                        # a kernel that fails, a parity refutation, a
                        # feature not ported yet or a CUDA error
                        self.loop_error = e
                        _LOG.critical("background planner stopped for "
                                      "good: %r", e)
                        raise
                self._stop.wait(interval)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="background-planner")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
