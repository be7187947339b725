"""Wire-format timestamps + injectable clocks.

Reference shape: metav1.Time serializes as RFC3339 with second precision
(``apimachinery/pkg/apis/meta/v1/time.go``, MarshalJSON). Every condition
``lastTransitionTime``, managedFields ``time``, event timestamp etc. is a
string of this shape on the wire; kubectl-shaped consumers parse it.

``Clock``/``FakeClock`` mirror ``k8s.io/utils/clock``: controllers with
time-window logic (HPA stabilization, autoscaler cooldowns) take a clock so
tests advance time deterministically instead of sleeping through windows.
"""

from __future__ import annotations

import datetime
import time as _time


class Clock:
    """Real wall clock (clock.RealClock analog)."""

    def now(self) -> float:
        return _time.time()


class FakeClock(Clock):
    """Manually-advanced clock for tests (clock.FakeClock analog)."""

    def __init__(self, t: float = 0.0):
        self._t = float(t)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        self._t += float(dt)

    def set(self, t: float) -> None:
        self._t = float(t)


REAL_CLOCK = Clock()


def rfc3339_now() -> str:
    """Current UTC time as an RFC3339 string, e.g. '2026-07-30T12:34:56Z'."""
    return rfc3339(datetime.datetime.now(datetime.timezone.utc))


def rfc3339(dt: datetime.datetime) -> str:
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=datetime.timezone.utc)
    return dt.astimezone(datetime.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")


def rfc3339_from_epoch(ts: float) -> str:
    return rfc3339(datetime.datetime.fromtimestamp(ts, datetime.timezone.utc))


def parse_rfc3339(s: str) -> float:
    """RFC3339 string -> epoch seconds (tolerates fractional seconds)."""
    return datetime.datetime.fromisoformat(
        str(s).replace("Z", "+00:00")).timestamp()
