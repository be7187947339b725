"""Chaos hook points — the thread/device seams product code exposes.

Product threads call :func:`chaos_point` at their loop boundaries (the
scheduling loop, the drain resolver, the resolve fetch). With no chaos
installed it is one global read and a ``None`` check — cheap enough for
hot paths. A chaos run installs a :class:`ThreadChaos` whose schedule
decides, per site and op index, whether the call stalls, raises a
catchable chaos error, or kills the thread outright (the watchdog's food).
"""

from __future__ import annotations

import time
from typing import Optional

from kubernetes_tpu_torch.chaos.schedule import FaultSchedule


class ChaosError(RuntimeError):
    """Catchable injected failure (product code treats it like any other
    runtime error at the seam it fired from)."""


class ChaosDeviceError(ChaosError):
    """Device failure (compile or runtime) injected at a device program
    entry point. Its message starts "UNIMPLEMENTED:" or "INTERNAL:", so
    ``sched/faults.is_fatal`` does not call it fatal: the breaker degrades
    around it."""


class ChaosThreadDeath(BaseException):
    """Kills the hosting thread: derives from BaseException on purpose so
    the product's ``except Exception`` self-healing does NOT absorb it —
    only the thread watchdog can recover from this one."""


class ThreadChaos:
    """Schedule-driven thread faults, fired from chaos_point sites
    (``thread.loop``, ``thread.resolver``, ...)."""

    def __init__(self, schedule: FaultSchedule):
        self.schedule = schedule

    def fire(self, site: str) -> None:
        f = self.schedule.should_fire(f"thread.{site}")
        if f is None:
            self.schedule.note_ok(f"thread.{site}")
            return
        if f.kind == "stall":
            time.sleep(f.arg or 0.1)
        elif f.kind == "die":
            raise ChaosThreadDeath(f"chaos: thread.{site} killed at op "
                                   f"{f.at} (seed {self.schedule.seed})")
        elif f.kind == "error":
            raise ChaosError(f"chaos: thread.{site} error at op {f.at} "
                             f"(seed {self.schedule.seed})")


_ACTIVE: Optional[ThreadChaos] = None


def install(chaos: ThreadChaos) -> None:
    global _ACTIVE
    _ACTIVE = chaos


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None


def chaos_point(site: str) -> None:
    """Product-side hook: no-op unless a chaos run installed faults."""
    c = _ACTIVE
    if c is not None:
        c.fire(site)
