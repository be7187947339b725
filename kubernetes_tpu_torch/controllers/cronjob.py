"""CronJob controller — create Jobs on a cron schedule.

Reference: ``pkg/controller/cronjob/cronjob_controllerv2.go`` (``syncCronJob``:
compute the most recent scheduled time since lastScheduleTime, honor
``suspend``/``startingDeadlineSeconds``/``concurrencyPolicy``, create a Job
named ``<cronjob>-<scheduled-unix-minute>``, update
``status.lastScheduleTime``/``active``) with a minimal 5-field cron parser in
place of robfig/cron.
"""

from __future__ import annotations

import time
from functools import lru_cache

from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.controllers.base import (
    Controller,
    is_controlled_by,
    owner_reference,
    split_key,
)
from kubernetes_tpu_torch.controllers.job import job_finished


def _parse_field(spec: str, lo: int, hi: int) -> set[int]:
    out: set[int] = set()
    for part in spec.split(","):
        step = 1
        if "/" in part:
            part, s = part.split("/", 1)
            step = int(s)
        if part == "*":
            a, b = lo, hi
        elif "-" in part:
            a, b = (int(x) for x in part.split("-", 1))
        else:
            a = b = int(part)
        out.update(range(a, b + 1, step))
    return out


@lru_cache(maxsize=256)
def _compile(expr: str):
    """Parse a 5-field cron expression once into membership sets."""
    f = expr.split()
    if len(f) != 5:
        raise ValueError(f"bad cron expression {expr!r}")
    minute, hour, dom, month, dow = f
    # cron dow: 0 and 7 both mean Sunday — parse with hi=7 then fold 7 onto 0
    # (a textual 7→0 substitution would corrupt ranges like "5-7" or "*/7")
    dows = frozenset(d % 7 for d in _parse_field(dow, 0, 7))
    return (_parse_field(minute, 0, 59), _parse_field(hour, 0, 23),
            _parse_field(dom, 1, 31), _parse_field(month, 1, 12),
            dows, dom != "*", dow != "*")


def cron_matches(expr: str, ts: float) -> bool:
    """5-field cron (minute hour dom month dow) against a unix timestamp."""
    minutes, hours, doms, months, dows, dom_restr, dow_restr = _compile(expr)
    t = time.gmtime(ts)
    if (t.tm_min not in minutes or t.tm_hour not in hours
            or t.tm_mon not in months):
        return False
    dom_ok = t.tm_mday in doms
    # struct_time: Monday=0; cron: Sunday=0
    dow_ok = (t.tm_wday + 1) % 7 in dows
    # dom/dow OR-semantics when both are restricted (vixie cron)
    if dom_restr and dow_restr:
        return dom_ok or dow_ok
    return dom_ok and dow_ok


_HORIZON_S = 10 * 24 * 3600  # upstream's 'too many missed start times' guard


def most_recent_schedule(expr: str, earliest: float, now: float):
    """Latest minute in (earliest, now] matching ``expr`` (None if none).
    Scans minute-by-minute backwards, bounded to ~10 days like upstream's
    'too many missed start times' guard."""
    t = int(now) // 60 * 60
    floor = max(int(earliest), t - _HORIZON_S)
    while t > floor:
        if cron_matches(expr, t):
            return float(t)
        t -= 60
    return None


def next_schedule(expr: str, after: float):
    """First minute strictly after ``after`` matching ``expr`` (None if no
    match within the 10-day horizon)."""
    t = (int(after) // 60 + 1) * 60
    ceil = int(after) + _HORIZON_S
    while t <= ceil:
        if cron_matches(expr, t):
            return float(t)
        t += 60
    return None


class CronJobController(Controller):
    name = "cronjob"
    tick_interval = 1.0  # schedule resolution is one minute; 1s tick is cheap

    def __init__(self, client):
        super().__init__(client)
        # key -> (earliest used, next fire ts, most recent sched): between
        # fire times the minute scan's answer can't change for a fixed
        # earliest, so the 1s ticks reuse it and steady-state sync is O(1)
        self._sched_cache: dict[str, tuple[float, float, object]] = {}

    def register(self, factory: InformerFactory) -> None:
        self.cj_informer = factory.informer("cronjobs", None)
        self.cj_informer.add_event_handler(self.handler())
        self.job_informer = factory.informer("jobs", None)
        self.job_informer.add_event_handler(
            self.handler(lambda obj: self.enqueue_owner(obj, "CronJob")))

    def tick(self) -> None:
        for cj in self.cj_informer.store.list():
            self.enqueue(cj)

    def _owned_jobs(self, cj: dict) -> list[dict]:
        ns = (cj.get("metadata") or {}).get("namespace", "")
        return [j for j in self.job_informer.store.list()
                if (j.get("metadata") or {}).get("namespace", "") == ns
                and is_controlled_by(j, cj)]

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        cj = self.cj_informer.store.get(key)
        if cj is None:
            self._sched_cache.pop(key, None)
            return
        spec = cj.get("spec") or {}
        status = cj.get("status") or {}
        owned = self._owned_jobs(cj)
        active = [j for j in owned if not job_finished(j)]
        now = time.time()

        if spec.get("suspend"):
            return
        expr = spec.get("schedule", "")
        if not expr:
            return
        earliest = status.get("lastScheduleTime")
        if earliest is None:
            # A brand-new CronJob is eligible for the minute boundary just
            # passed, so its first Job doesn't wait out the current minute.
            created = (cj.get("metadata") or {}).get("creationTimestamp") or now
            earliest = float(created) - 60.0
        cached = self._sched_cache.get(key)
        if (cached is not None and cached[0] == (earliest, expr)
                and now < cached[1]):
            sched = cached[2]
        else:
            try:
                sched = most_recent_schedule(expr, float(earliest), now)
                nxt = next_schedule(expr, now)
            except ValueError as e:
                # Surface the broken expression on the object instead of
                # spinning through the requeue loop every tick (upstream
                # records an UnparseableSchedule event and skips).
                self._set_invalid_schedule(ns, cj, str(e))
                return
            self._sched_cache[key] = (
                (earliest, expr), nxt if nxt is not None else now + 3600.0,
                sched)
        if sched is None:
            self._update_status(ns, cj, active)
            return
        deadline = spec.get("startingDeadlineSeconds")
        if deadline is not None and now - sched > float(deadline):
            self._update_status(ns, cj, active)  # missed its window
            return
        # A Job for this schedule time already exists (possibly finished, or
        # created a tick ago before lastScheduleTime landed): nothing to
        # start, and crucially Replace must not delete it.
        job_name = f"{name}-{int(sched) // 60}"
        if any((j.get("metadata") or {}).get("name") == job_name
               for j in owned):
            self._update_status(ns, cj, active, sched)
            return
        policy = spec.get("concurrencyPolicy", "Allow")
        if active and policy == "Forbid":
            self._update_status(ns, cj, active)
            return
        if active and policy == "Replace":
            for j in active:
                try:
                    self.client.resource("jobs", ns).delete(
                        (j.get("metadata") or {}).get("name", ""))
                except ApiError as e:
                    if e.code != 404:
                        raise
            active = []

        tpl = (spec.get("jobTemplate") or {})
        job = {"apiVersion": "apps/v1", "kind": "Job",
               "metadata": {**dict(tpl.get("metadata") or {}),
                            "name": job_name, "namespace": ns,
                            "ownerReferences": [owner_reference(cj, "CronJob")]},
               "spec": dict(tpl.get("spec") or {})}
        try:
            self.client.resource("jobs", ns).create(job)
        except ApiError as e:
            if e.code != 409:  # AlreadyExists: another worker won the race
                raise
        self._update_status(ns, cj, active + [job], sched)

    def _set_invalid_schedule(self, ns, cj, msg: str) -> None:
        status = dict(cj.get("status") or {})
        cond = {"type": "InvalidSchedule", "status": "True", "message": msg}
        if status.get("conditions") == [cond]:
            return
        status["conditions"] = [cond]
        desired = dict(cj)
        desired["status"] = status
        try:
            self.client.resource("cronjobs", ns).update_status(desired)
        except ApiError as e:
            if e.code not in (404, 409):
                raise

    def _update_status(self, ns, cj, active, sched=None):
        status = dict(cj.get("status") or {})
        status.pop("conditions", None)  # clear a stale InvalidSchedule
        if sched is not None:
            status["lastScheduleTime"] = sched
        status["active"] = [
            {"kind": "Job", "name": (j.get("metadata") or {}).get("name", ""),
             "namespace": ns} for j in active]
        if status == (cj.get("status") or {}):
            return
        desired = dict(cj)
        desired["status"] = status
        try:
            self.client.resource("cronjobs", ns).update_status(desired)
        except ApiError as e:
            if e.code not in (404, 409):
                raise
