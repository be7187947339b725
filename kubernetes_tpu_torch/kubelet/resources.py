"""Node resource managers — QoS classes, allocatable admission, CPU pinning.

Reference:
- QoS: ``pkg/apis/core/v1/helper/qos/qos.go`` (``GetPodQOS``): Guaranteed =
  every container has equal non-zero requests and limits for cpu+memory;
  BestEffort = no requests/limits at all; else Burstable.
- Admission: ``pkg/kubelet/lifecycle/predicate.go`` — the kubelet re-checks
  fit against node allocatable when a pod arrives; over-committed pods are
  rejected with ``OutOf<resource>`` (the scheduler normally prevents this,
  but races and static pods make the node-side check load-bearing).
- CPU manager: ``pkg/kubelet/cm/cpumanager/policy_static.go`` — Guaranteed
  pods with integer cpu requests get EXCLUSIVE cpus carved from the shared
  pool; everything else shares the remainder.
"""

from __future__ import annotations

import threading
from typing import Optional

from kubernetes_tpu_torch.api.resource import canonical
from kubernetes_tpu_torch.encode.scaling import scale_allocatable, scale_request

GUARANTEED, BURSTABLE, BEST_EFFORT = "Guaranteed", "Burstable", "BestEffort"


def pod_qos(pod: dict) -> str:
    """GetPodQOS over the dict shape."""
    requests: dict[str, int] = {}
    limits: dict[str, int] = {}
    all_equal = True
    any_req = any_lim = False
    for c in (pod.get("spec") or {}).get("containers") or []:
        res = c.get("resources") or {}
        req = {r: canonical(r, str(q)) for r, q in (res.get("requests") or {}).items()
               if r in ("cpu", "memory")}
        lim = {r: canonical(r, str(q)) for r, q in (res.get("limits") or {}).items()
               if r in ("cpu", "memory")}
        any_req |= bool(req)
        any_lim |= bool(lim)
        for r in ("cpu", "memory"):
            if req.get(r) != lim.get(r) or lim.get(r) is None:
                all_equal = False
        for r, q in req.items():
            requests[r] = requests.get(r, 0) + q
        for r, q in lim.items():
            limits[r] = limits.get(r, 0) + q
    if not any_req and not any_lim:
        return BEST_EFFORT
    if all_equal and set(requests) == {"cpu", "memory"}:
        return GUARANTEED
    return BURSTABLE


class AllocatableAdmitter:
    """Node-side fit re-check (lifecycle.PredicateAdmitHandler analog).

    Tracks scaled usage of admitted pods; ``admit`` returns (ok, reason)
    where reason is ``OutOf<Resource>`` on rejection — the kubelet marks
    such pods Failed instead of running them.
    """

    def __init__(self, allocatable: dict):
        # allocatable rounds DOWN, requests round UP (encode/scaling.py's
        # conservative-direction invariant)
        self._alloc = {r: scale_allocatable(r, canonical(r, str(q)))
                       for r, q in (allocatable or {}).items()}
        self._used: dict[str, int] = {}
        self._pods: dict[str, dict] = {}  # uid -> scaled requests
        self._lock = threading.Lock()

    @staticmethod
    def _requests(pod: dict) -> dict:
        out: dict[str, int] = {}
        for c in (pod.get("spec") or {}).get("containers") or []:
            for r, q in ((c.get("resources") or {}).get("requests") or {}).items():
                out[r] = out.get(r, 0) + scale_request(r, canonical(r, str(q)))
        out["pods"] = 1
        return out

    def admit(self, pod: dict) -> tuple[bool, str]:
        uid = (pod.get("metadata") or {}).get("uid", "")
        reqs = self._requests(pod)
        with self._lock:
            if uid in self._pods:
                return True, ""
            for r, need in reqs.items():
                if r not in self._alloc:
                    continue
                if self._used.get(r, 0) + need > self._alloc[r]:
                    return False, f"OutOf{r.rstrip('s').capitalize()}"
            self._pods[uid] = reqs
            for r, need in reqs.items():
                self._used[r] = self._used.get(r, 0) + need
            return True, ""

    def release(self, pod_uid: str) -> None:
        with self._lock:
            reqs = self._pods.pop(pod_uid, None)
            if reqs:
                for r, need in reqs.items():
                    self._used[r] = self._used.get(r, 0) - need


class CPUManager:
    """Static-policy analog: exclusive cpu ids for Guaranteed pods whose cpu
    request is a whole number of cores; shared pool for everyone else."""

    def __init__(self, num_cpus: int):
        self._all = set(range(int(num_cpus)))
        self._assigned: dict[str, set] = {}  # uid -> exclusive cpus
        self._lock = threading.Lock()

    def allocate(self, pod: dict) -> Optional[set]:
        """-> exclusive cpu set, or None (shared pool). Raises RuntimeError
        when exclusivity is requested but the free pool is short."""
        uid = (pod.get("metadata") or {}).get("uid", "")
        if pod_qos(pod) != GUARANTEED:
            return None
        millis = 0
        for c in (pod.get("spec") or {}).get("containers") or []:
            q = ((c.get("resources") or {}).get("requests") or {}).get("cpu")
            if q is not None:
                millis += canonical("cpu", str(q))
        if millis <= 0 or millis % 1000 != 0:
            return None  # fractional cpu: shared pool (static policy rule)
        want = millis // 1000
        with self._lock:
            if uid in self._assigned:
                return set(self._assigned[uid])
            taken = (set().union(*self._assigned.values())
                     if self._assigned else set())
            free = self._all - taken
            if len(free) < want:
                raise RuntimeError("not enough free exclusive cpus")
            got = set(sorted(free)[:want])
            self._assigned[uid] = got
            return set(got)

    def release(self, pod_uid: str) -> None:
        with self._lock:
            self._assigned.pop(pod_uid, None)

    def exclusive_cpus(self, pod_uid: str) -> set:
        with self._lock:
            return set(self._assigned.get(pod_uid, ()))
