"""Device-layer chaos — failures at the program entry points.

Wraps the three device entries the connected loop dispatches —
``gang_schedule`` (per-batch path), ``drain_step`` (the resident drain)
and ``preempt_wave`` (preemption storm) — so scheduled cycles raise
compile/runtime errors the way a miscompiled program or a lost device
does. On the card the first two are the entry points of the captured
CUDA-graph rounds (models/graphs.py). The scheduler's circuit breaker is
the consumer: enough consecutive device failures must degrade
(mesh ->) single -> the numpy oracle instead of killing the loop, and a half-open
probe after the cooldown must restore the rounds.

An injected failure is a ``ChaosDeviceError``: a ``RuntimeError`` whose
message starts "UNIMPLEMENTED:" or "INTERNAL:", which
``sched/faults.is_fatal`` does not call fatal (a CUDA error stays fatal
and is never injected here). The wrapper raises BEFORE the wrapped call,
so an injected fault never leaves a half-written resident tensor
(``drain_step`` updates the context in place).

Install/uninstall patch module attributes; the scheduler resolves all
three names at call time, so no product changes are needed for the
injection itself: ``gang_schedule`` through ``sched/scheduler.py``'s own
attribute (imported at its top, patched there), ``drain_step`` through
the imports inside ``Scheduler._schedule_drain`` and ``warm_drain``,
``preempt_wave`` as ``preemption_mod.preempt_wave``. The sidecar engine
imports ``gang_schedule`` inside its handler, so the ``models.gang``
seam covers it. ``testing/resident.py`` binds ``drain_step`` at import
time and needs no seam: it is a test double of the resident cycle, not
a path of the connected loop. The fleet runs the scheduler's drain, and
the explainer and the planners call none of the three.

Under a device mesh (parallel/mesh.py) the breaker walks mesh -> single
-> oracle, as the reference's does: the seams wrap the entry points, which
run every shard, so an injected failure fails the whole sharded dispatch
once, and a burst drops the active mesh to single-device until the
half-open probe reinstalls the configured one.
"""

from __future__ import annotations

from kubernetes_tpu_torch.chaos.hooks import ChaosDeviceError
from kubernetes_tpu_torch.chaos.schedule import FaultSchedule

# (site, module path, attribute) triples patched by install()
_SEAMS = (
    ("device.gang", "kubernetes_tpu_torch.models.gang", "gang_schedule"),
    ("device.gang", "kubernetes_tpu_torch.sched.scheduler", "gang_schedule"),
    ("device.drain", "kubernetes_tpu_torch.models.gang", "drain_step"),
    ("device.preempt", "kubernetes_tpu_torch.sched.preemption",
     "preempt_wave"),
)


class DeviceChaos:
    """Context manager (or explicit install/uninstall) for device faults."""

    def __init__(self, schedule: FaultSchedule):
        self.schedule = schedule
        self._saved: list[tuple] = []

    def _wrap(self, site: str, fn):
        schedule = self.schedule

        def chaotic(*a, **kw):
            f = schedule.should_fire(site)
            if f is not None:
                name = ("UNIMPLEMENTED: chaos compile failure"
                        if f.kind == "compile"
                        else "INTERNAL: chaos device execution failure")
                raise ChaosDeviceError(
                    f"{name} at {site} op {f.at} (seed {schedule.seed})")
            out = fn(*a, **kw)
            schedule.note_ok(site)
            return out
        chaotic.__wrapped__ = fn
        return chaotic

    def install(self) -> "DeviceChaos":
        import importlib
        if self._saved:
            return self
        for site, mod_path, attr in _SEAMS:
            mod = importlib.import_module(mod_path)
            orig = getattr(mod, attr)
            self._saved.append((mod, attr, orig))
            setattr(mod, attr, self._wrap(site, orig))
        return self

    def uninstall(self) -> None:
        for mod, attr, orig in self._saved:
            setattr(mod, attr, orig)
        self._saved = []

    def __enter__(self) -> "DeviceChaos":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()
