"""API-transport chaos — a clientset wrapper that injects failures.

Wraps any clientset (DirectClient or HTTPClient) so every component built
on it — informers, the scheduler's binder, leader election, event
recording — sees scheduled ``ApiError`` storms, added latency, optimistic
-concurrency conflicts, truncated watch streams, and forced
"resourceVersion too old" gaps. The wrapper is transparent otherwise:
unknown attributes delegate to the wrapped client/handle, so test helpers
that reach for ``client.store`` keep working.

Sites: ``api.<verb>`` for CRUD/bind verbs (bulk verbs share their scalar
verb's site: one outage takes both down), ``watch.<plural>`` for streams.
A successful pass-through call stamps the site healthy again
(``FaultSchedule.note_ok``), which is what closes recovery spans.
"""

from __future__ import annotations

import time
from typing import Optional

from kubernetes_tpu_torch.chaos.schedule import Fault, FaultSchedule
from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.store.store import TooOld

# verbs intercepted on resource handles; bulk verbs map onto the scalar
# verb's site so one scheduled outage covers both paths
_VERB_SITES = {
    "create": "api.create",
    "create_many": "api.create",
    "update": "api.update",
    "update_status": "api.update_status",
    "update_status_many": "api.update_status",
    "heartbeat_many": "api.update_status",
    "renew_many": "api.update",
    "apply": "api.update",
    "delete": "api.delete",
    "bind": "api.bind",
    "bind_many": "api.bind",
    "evict": "api.delete",
    "get": "api.get",
    "list": "api.list",
    "list_rv": "api.list",
}


def _raise_api_fault(f: Fault, site: str) -> None:
    if f.kind == "conflict":
        raise ApiError(409, f"chaos: injected conflict at {site} "
                            f"op {f.at}", "Conflict")
    code = int(f.arg or 503)
    raise ApiError(code, f"chaos: injected unavailability at {site} "
                         f"op {f.at}", "ServiceUnavailable")


class ChaosResource:
    """One wrapped ResourceClient: verbs consult the schedule first."""

    def __init__(self, inner, schedule: FaultSchedule):
        self._inner = inner
        self._schedule = schedule

    def __getattr__(self, name):
        inner = object.__getattribute__(self, "_inner")
        attr = getattr(inner, name)
        site = _VERB_SITES.get(name)
        if site is None or not callable(attr):
            return attr
        schedule = object.__getattribute__(self, "_schedule")

        def chaotic(*a, **kw):
            f = schedule.should_fire(site)
            if f is not None:
                if f.kind == "latency":
                    time.sleep(f.arg or 0.05)
                else:
                    _raise_api_fault(f, site)
            out = attr(*a, **kw)
            schedule.note_ok(site)
            return out
        return chaotic

    def watch(self, since_rv: int = 0):
        site = f"watch.{getattr(self._inner, 'plural', '?')}"
        f = self._schedule.should_fire(site)
        if f is not None and f.kind == "too_old":
            # the informer's reflector catches TooOld and relists — the
            # exact "resourceVersion too old" path etcd compaction forces
            raise TooOld(f"chaos: forced watch gap at {site} op {f.at}")
        w = self._inner.watch(since_rv=since_rv)
        if f is not None and f.kind == "drop":
            # the span stays OPEN: it closes at the NEXT successful
            # (re-)establish below — time-to-relist is the number the
            # recovery ledger is measuring
            return ChaosWatch(w, deliver=int(f.arg or 0))
        self._schedule.note_ok(site)
        return w


class ChaosWatch:
    """Truncating watch stream: delivers ``deliver`` events, then closes.
    Events the server emits after the truncation are lost to this stream —
    the informer only heals by relisting, which is the behavior under
    test."""

    def __init__(self, inner, deliver: int):
        self._inner = inner
        self._left = max(0, deliver)
        self.closed = False

    def get(self, timeout: float = 0.2):
        if self.closed:
            return None
        if self._left <= 0:
            self.closed = True
            self._inner.stop()
            return None
        ev = self._inner.get(timeout)
        if ev is not None:
            self._left -= 1
        if getattr(self._inner, "closed", False):
            self.closed = True
        return ev

    def __iter__(self):
        return self

    def __next__(self):
        while not self.closed:
            ev = self.get(timeout=1.0)
            if ev is not None:
                return ev
        raise StopIteration

    def stop(self):
        self.closed = True
        self._inner.stop()


class ChaosClient:
    """Clientset wrapper: resource handles come back chaos-wrapped."""

    def __init__(self, inner, schedule: FaultSchedule):
        self._inner = inner
        self.schedule = schedule

    # ---- handle constructors (every path informers/components use) -------

    def resource(self, plural: str, ns: Optional[str] = "default"):
        return ChaosResource(self._inner.resource(plural, ns), self.schedule)

    def pods(self, ns: str = "default"):
        return ChaosResource(self._inner.pods(ns), self.schedule)

    def nodes(self):
        return ChaosResource(self._inner.nodes(), self.schedule)

    def services(self, ns: str = "default"):
        return ChaosResource(self._inner.services(ns), self.schedule)

    def endpoints(self, ns: str = "default"):
        return ChaosResource(self._inner.endpoints(ns), self.schedule)

    def leases(self, ns: str = "kube-system"):
        return ChaosResource(self._inner.leases(ns), self.schedule)

    def __getattr__(self, name):
        # default_user_agent, register_custom, store, pod_logs, ... pass
        # through untouched
        return getattr(object.__getattribute__(self, "_inner"), name)
