"""Scenario driver — the time-warped trace player.

Pushes a trace's events through a real clientset against a connected
apiserver+scheduler stack. Time rides an injected
:class:`~kubernetes_tpu_torch.utils.clock.Clock` (KTL003: a FakeClock test can
replay without sleeping) and a ``speed`` warp factor: 1.0 replays at the
recorded pace, ``N`` compresses it N-fold, and ``0`` dispatches as fast
as the transport accepts. Every event's dispatch skew (how late it ran
vs its warped offset) is stamped into ``scenario_dispatch_skew_seconds``;
every resident pod's create-to-bound latency lands in
``scenario_attempt_latency_seconds`` labeled by trace phase — the
per-phase p99 the scenario SLO gates read.

While running, the driver publishes a ``kubernetes-tpu-scenario-status``
ConfigMap (via the shared ``upsert_configmap``, KTL006) that ``ktpu
status`` renders as the "Scenario:" line.
"""

from __future__ import annotations

import json
import threading

from kubernetes_tpu_torch.metrics.registry import (SCENARIO_ATTEMPT,
                                             SCENARIO_EVENTS,
                                             SCENARIO_SKEW)
from kubernetes_tpu_torch.scenario.trace import Trace, TraceEvent
from kubernetes_tpu_torch.utils.clock import REAL_CLOCK, Clock

SCENARIO_CONFIGMAP = "kubernetes-tpu-scenario-status"

_PLURALS = {"Pod": "pods", "Node": "nodes"}


class ScenarioDriver:
    """One replay of one trace through one clientset."""

    def __init__(self, client, trace: Trace, *,
                 clock: Clock = REAL_CLOCK, speed: float = 1.0,
                 publish: bool = True, status_namespace: str = "default",
                 bind_timeout_s: float = 120.0,
                 poll_interval_s: float = 0.1,
                 publish_every: int = 25,
                 log=lambda *a: None):
        self.client = client
        self.trace = trace
        self.clock = clock
        self.speed = float(speed)
        self.publish = publish
        self.status_namespace = status_namespace
        self.bind_timeout_s = float(bind_timeout_s)
        self.poll_interval_s = float(poll_interval_s)
        self.publish_every = int(publish_every)
        self.log = log
        self._stop = threading.Event()
        self._state = "idle"
        self._phase = ""
        self._dispatched = 0
        self._skew_max = 0.0
        self._bound = 0
        self._resident_total = len(trace.resident_pods())

    # ---- public ----------------------------------------------------------

    def plan(self) -> list[str]:
        """The deterministic dispatch order for this trace — pure data,
        no I/O. Two loads of the same bytes MUST plan identically (the
        bench's determinism gate compares these)."""
        return [f"{e.at_s:.4f} {e.verb} {e.kind} {e.ns}/{e.name}"
                for e in self.trace.events]

    def stop(self) -> None:
        self._stop.set()

    def run(self) -> dict:
        """Dispatch every event at its warped offset, then wait for all
        resident pods to bind. Returns the replay's result block; never
        raises on per-event API errors (they are counted and listed —
        a replayed incident is EXPECTED to hit conflicts)."""
        # process-global registry: this window must not inherit an
        # earlier replay's tail
        SCENARIO_SKEW.reset()
        SCENARIO_ATTEMPT.reset()
        warp = (1.0 / self.speed) if self.speed > 0 else 0.0
        dispatch_order: list[str] = []
        errors: list[str] = []
        dispatch_ts: dict = {}
        pod_phase: dict = {}
        self._state = "dispatching"
        self._publish_status()
        t0 = self.clock.now()
        for i, ev in enumerate(self.trace.events):
            if self._stop.is_set():
                break
            target = t0 + ev.at_s * warp
            delay = target - self.clock.now()
            if delay > 0:
                self._stop.wait(delay)
            ok = self._dispatch(ev)
            now = self.clock.now()
            skew = max(0.0, now - target)
            self._skew_max = max(self._skew_max, skew)
            SCENARIO_SKEW.observe(skew)
            SCENARIO_EVENTS.inc({"verb": ev.verb,
                                 "result": "ok" if ok is True
                                 else "error"})
            if ok is not True:
                errors.append(f"{ev.verb} {ev.key()}: {ok}")
            dispatch_order.append(f"{ev.at_s:.4f} {ev.verb} {ev.kind} "
                                  f"{ev.ns}/{ev.name}")
            if ev.kind == "Pod" and ev.verb == "create":
                dispatch_ts[(ev.ns, ev.name)] = now
                pod_phase[(ev.ns, ev.name)] = ev.phase or "default"
            self._dispatched = i + 1
            phase = ev.phase or "default"
            if phase != self._phase:
                self._phase = phase
                self._publish_status()
            elif (i + 1) % self.publish_every == 0:
                self._publish_status()
        t_dispatched = self.clock.now()
        self._state = "binding"
        self._publish_status()
        bound_at = self._wait_bound(dispatch_ts, pod_phase)
        t_end = self.clock.now()
        resident = self.trace.resident_pods()
        self._bound = len(bound_at)
        completed = (not self._stop.is_set()
                     and len(bound_at) >= len(resident))
        self._state = "done" if completed else "incomplete"
        self._publish_status()

        phases: dict = {}
        for (ns, name), ev in resident.items():
            ph = ev.phase or "default"
            st = phases.setdefault(ph, {"pods": 0, "bound": 0})
            st["pods"] += 1
            if (ns, name) in bound_at:
                st["bound"] += 1
        for ph, st in phases.items():
            n = SCENARIO_ATTEMPT.count({"phase": ph})
            st["p99_attempt_latency_s"] = (
                SCENARIO_ATTEMPT.percentile(0.99, {"phase": ph})
                if n else None)
            st["p50_attempt_latency_s"] = (
                SCENARIO_ATTEMPT.percentile(0.50, {"phase": ph})
                if n else None)
        return {
            "trace": self.trace.manifest.name,
            "seed": self.trace.manifest.seed,
            "events_total": len(self.trace.events),
            "dispatched": self._dispatched,
            "dispatch_order": dispatch_order,
            "errors": errors[:50],
            "error_count": len(errors),
            "speed": self.speed,
            "dispatch_s": round(t_dispatched - t0, 3),
            "wall_s": round(t_end - t0, 3),
            "skew": {"max_s": round(self._skew_max, 4),
                     "p99_s": SCENARIO_SKEW.percentile(0.99),
                     "events": SCENARIO_SKEW.count()},
            "resident": len(resident),
            "bound": len(bound_at),
            "completed": completed,
            "phases": phases,
        }

    # ---- internals -------------------------------------------------------

    def _resource(self, ev: TraceEvent):
        plural = _PLURALS.get(ev.kind)
        if plural is None:
            return None
        if ev.kind == "Node":
            return self.client.nodes()
        return self.client.pods(ev.ns)

    def _dispatch(self, ev: TraceEvent):
        """True on success, else a short error string."""
        res = self._resource(ev)
        if res is None:
            return f"unsupported kind {ev.kind!r}"
        try:
            if ev.verb == "create":
                res.create(self.trace.materialize(ev))
            elif ev.verb == "update":
                res.update(self.trace.materialize(ev))
            elif ev.verb == "delete":
                res.delete(ev.name)
            else:
                return f"unsupported verb {ev.verb!r}"
            return True
        except Exception as e:  # counted + listed, never silent
            return f"{type(e).__name__}: {e}"

    def _wait_bound(self, dispatch_ts: dict, pod_phase: dict) -> dict:
        """Poll the store until every resident pod is bound (or the
        budget runs out); observe create-to-bound latency per pod the
        first poll that sees its binding."""
        resident = self.trace.resident_pods()
        if not resident:
            return {}
        namespaces = sorted({ns for ns, _ in resident})
        deadline = self.clock.now() + self.bind_timeout_s
        bound_at: dict = {}
        while not self._stop.is_set():
            now = self.clock.now()
            for ns in namespaces:
                try:
                    pods = self.client.pods(ns).list()
                except Exception as e:
                    self.log(f"  scenario: list({ns}) failed: {e}")
                    continue
                for p in pods:
                    name = (p.get("metadata") or {}).get("name", "")
                    key = (ns, name)
                    if key not in resident or key in bound_at:
                        continue
                    if (p.get("spec") or {}).get("nodeName"):
                        bound_at[key] = now
                        t_create = dispatch_ts.get(key)
                        if t_create is not None:
                            SCENARIO_ATTEMPT.observe(
                                now - t_create,
                                {"phase": pod_phase.get(key,
                                                        "default")})
            if len(bound_at) != self._bound:
                self._bound = len(bound_at)
                self._publish_status()
            if len(bound_at) >= len(resident) or now >= deadline:
                break
            self._stop.wait(self.poll_interval_s)
        return bound_at

    def _publish_status(self) -> None:
        if not self.publish:
            return
        from kubernetes_tpu_torch.utils.configmap import upsert_configmap
        st = {"trace": self.trace.manifest.name,
              "state": self._state,
              "phase": self._phase,
              "eventsDispatched": self._dispatched,
              "eventsTotal": len(self.trace.events),
              "skewMaxMs": round(self._skew_max * 1000, 1),
              "podsBound": self._bound,
              "podsResident": self._resident_total,
              "speed": self.speed}
        upsert_configmap(self.client, self.status_namespace,
                         SCENARIO_CONFIGMAP,
                         {"scenario": json.dumps(st)},
                         site="scenario_status")
