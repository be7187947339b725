"""Node resource managers: device plugins, NUMA memory, topology alignment.

Reference: ``pkg/kubelet/cm/`` —
  devicemanager/   device-plugin registry + per-container device allocation
  memorymanager/   Static policy: NUMA-pinned memory for Guaranteed pods
  topologymanager/ merge TopologyHints from the providers, admit by policy
                   (none / best-effort / restricted / single-numa-node)

The hint model is the reference's: each provider answers "which NUMA-node
sets could satisfy this pod" with a preferred flag; the topology manager
intersects bitmasks across providers, prefers the narrowest preferred
merge, and the policy decides whether a non-preferred merge admits.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional

from kubernetes_tpu_torch.api.resource import canonical
from kubernetes_tpu_torch.kubelet.resources import GUARANTEED, pod_qos

POLICY_NONE = "none"
POLICY_BEST_EFFORT = "best-effort"
POLICY_RESTRICTED = "restricted"
POLICY_SINGLE_NUMA = "single-numa-node"


@dataclass(frozen=True)
class TopologyHint:
    """numa_affinity: frozenset of NUMA node ids this placement could use;
    preferred: True when the set is minimal for the request."""
    numa_affinity: frozenset
    preferred: bool = True


@dataclass
class Device:
    id: str
    numa_node: int = 0
    healthy: bool = True


class DeviceManager:
    """Device-plugin registry + allocator (cm/devicemanager/manager.go):
    plugins register devices under an extended-resource name; pods
    requesting it get concrete device ids, freed on pod removal."""

    def __init__(self):
        self._lock = threading.Lock()
        self._devices: dict[str, dict[str, Device]] = {}  # resource -> id->
        self._allocated: dict[str, dict[str, list[str]]] = {}  # uid -> res->

    def register_plugin(self, resource: str, devices: list[Device]) -> None:
        with self._lock:
            self._devices[resource] = {d.id: d for d in devices}

    def capacity(self) -> dict[str, int]:
        with self._lock:
            return {r: sum(1 for d in devs.values() if d.healthy)
                    for r, devs in self._devices.items()}

    def _demand(self, pod: dict) -> dict[str, int]:
        want: dict[str, int] = {}
        for c in (pod.get("spec") or {}).get("containers") or []:
            req = ((c.get("resources") or {}).get("requests")) or {}
            for r, q in req.items():
                if r in self._devices:
                    want[r] = want.get(r, 0) + int(canonical(r, q))
        return want

    def hints(self, pod: dict) -> Optional[TopologyHint]:
        """Narrowest NUMA set that could satisfy the pod's device demand
        (GetTopologyHints); None = no device demand (no opinion)."""
        with self._lock:
            want = self._demand(pod)
            if not want:
                return None
            nodes: set[int] = set()
            for r, n in want.items():
                free = self._free_locked(r)
                if len(free) < n:
                    return TopologyHint(frozenset(), preferred=False)
                by_numa: dict[int, int] = {}
                for d in free:
                    by_numa[d.numa_node] = by_numa.get(d.numa_node, 0) + 1
                # single NUMA node that fits the whole demand -> preferred
                single = [numa for numa, cnt in by_numa.items() if cnt >= n]
                if single:
                    nodes.add(min(single))
                else:
                    nodes.update(by_numa)
            return TopologyHint(frozenset(nodes), preferred=len(nodes) == 1)

    def _free_locked(self, resource: str) -> list[Device]:
        taken = {d for allocs in self._allocated.values()
                 for d in allocs.get(resource, [])}
        return [d for d in self._devices.get(resource, {}).values()
                if d.healthy and d.id not in taken]

    def allocate(self, pod: dict,
                 affinity: Optional[frozenset] = None) -> dict[str, list[str]]:
        """-> resource -> device ids. Raises RuntimeError when short.
        ``affinity``: the topology manager's merged NUMA set — devices on
        those nodes are taken first."""
        uid = (pod.get("metadata") or {}).get("uid", "")
        with self._lock:
            if uid in self._allocated:
                return dict(self._allocated[uid])
            want = self._demand(pod)
            if not want:
                return {}
            out: dict[str, list[str]] = {}
            for r, n in want.items():
                free = self._free_locked(r)
                if affinity:
                    free.sort(key=lambda d: d.numa_node not in affinity)
                if len(free) < n:
                    raise RuntimeError(
                        f"insufficient {r}: want {n}, free {len(free)}")
                out[r] = [d.id for d in free[:n]]
            self._allocated[uid] = out
            return dict(out)

    def release(self, uid: str) -> None:
        with self._lock:
            self._allocated.pop(uid, None)


class MemoryManager:
    """Static-policy analog (cm/memorymanager): Guaranteed pods get their
    memory reserved against NUMA nodes; others ride the shared pool."""

    def __init__(self, numa_mib: list[int]):
        self._lock = threading.Lock()
        self._capacity = list(numa_mib)  # Mi per NUMA node
        self._reserved: dict[str, dict[int, int]] = {}  # uid -> numa -> Mi

    def _demand_mib(self, pod: dict) -> int:
        total = 0
        for c in (pod.get("spec") or {}).get("containers") or []:
            q = ((c.get("resources") or {}).get("requests") or {}) \
                .get("memory")
            if q is not None:
                total += canonical("memory", str(q)) // (1 << 20)
        return total

    def _free_locked(self) -> list[int]:
        free = list(self._capacity)
        for res in self._reserved.values():
            for numa, mib in res.items():
                free[numa] -= mib
        return free

    def hints(self, pod: dict) -> Optional[TopologyHint]:
        if pod_qos(pod) != GUARANTEED:
            return None
        want = self._demand_mib(pod)
        if want <= 0:
            return None
        with self._lock:
            free = self._free_locked()
            fits = [i for i, f in enumerate(free) if f >= want]
            if fits:
                return TopologyHint(frozenset({min(fits)}), preferred=True)
            if sum(free) >= want:
                return TopologyHint(
                    frozenset(range(len(free))), preferred=False)
            return TopologyHint(frozenset(), preferred=False)

    def allocate(self, pod: dict,
                 affinity: Optional[frozenset] = None) -> Optional[dict]:
        """-> numa -> Mi reservation for Guaranteed pods (None = shared)."""
        if pod_qos(pod) != GUARANTEED:
            return None
        want = self._demand_mib(pod)
        if want <= 0:
            return None
        uid = (pod.get("metadata") or {}).get("uid", "")
        with self._lock:
            if uid in self._reserved:
                return dict(self._reserved[uid])
            free = self._free_locked()
            order = sorted(range(len(free)), key=lambda i: (
                affinity is not None and i not in affinity, i))
            plan: dict[int, int] = {}
            left = want
            for i in order:
                if left <= 0:
                    break
                take = min(free[i], left)
                if take > 0:
                    plan[i] = take
                    left -= take
            if left > 0:
                raise RuntimeError(
                    f"insufficient NUMA memory: want {want}Mi")
            self._reserved[uid] = plan
            return dict(plan)

    def release(self, uid: str) -> None:
        with self._lock:
            self._reserved.pop(uid, None)


class TopologyManager:
    """Merge provider hints, admit by policy (cm/topologymanager).

    Providers: objects with ``hints(pod) -> TopologyHint | None``. The
    merged affinity is the intersection of provider sets; empty
    intersection or non-preferred merges admit or reject per policy."""

    def __init__(self, policy: str = POLICY_BEST_EFFORT, num_numa: int = 1):
        self.policy = policy
        self.num_numa = num_numa
        self.providers: list = []

    def add_provider(self, p) -> None:
        self.providers.append(p)

    def merge(self, pod: dict) -> tuple[frozenset, bool, bool]:
        """-> (merged affinity, preferred, any_hints). A pod no provider
        has an opinion about carries no topology constraint at all."""
        merged = frozenset(range(self.num_numa))
        preferred = True
        any_hints = False
        for p in self.providers:
            h = p.hints(pod)
            if h is None:
                continue
            any_hints = True
            merged &= h.numa_affinity
            preferred = preferred and h.preferred
        preferred = preferred and len(merged) == 1
        return merged, preferred, any_hints

    def admit(self, pod: dict) -> tuple[bool, str, frozenset]:
        """-> (admit, reason, affinity) — the kubelet's TopologyAffinityError
        gate (admission happens BEFORE allocation, like upstream)."""
        everything = frozenset(range(self.num_numa))
        if self.policy == POLICY_NONE:
            return True, "", everything
        merged, preferred, any_hints = self.merge(pod)
        if not any_hints:
            return True, "", everything  # no constraints: always admitted
        if not merged:
            if self.policy == POLICY_BEST_EFFORT:
                return True, "", everything
            return False, "TopologyAffinityError: no NUMA placement " \
                          "satisfies every provider", merged
        if self.policy in (POLICY_SINGLE_NUMA, POLICY_RESTRICTED) \
                and not preferred:
            # restricted: only PREFERRED merges admit (upstream's policy);
            # single-numa-node additionally requires exactly one node
            return False, "TopologyAffinityError: no preferred NUMA " \
                          "placement", merged
        return True, "", merged
