"""Leader election over Lease objects — active-passive HA.

Reference: ``client-go/tools/leaderelection/leaderelection.go``
(``LeaderElector.Run``: acquire -> renew loop -> OnStartedLeading /
OnStoppedLeading) with ``resourcelock/leaselock.go`` semantics (holderIdentity
+ renewTime, optimistic-concurrency updates).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.metrics.registry import LOOP_ERRORS
from kubernetes_tpu_torch.store.store import AlreadyExists, Conflict, NotFound

_LOG = logging.getLogger("kubernetes_tpu_torch.client.leaderelection")


@dataclass
class LeaderElectionConfig:
    lock_name: str
    identity: str
    lease_duration: float = 15.0
    renew_deadline: float = 10.0
    retry_period: float = 2.0
    on_started_leading: Optional[Callable] = None
    on_stopped_leading: Optional[Callable] = None


class LeaderElector:
    def __init__(self, leases, cfg: LeaderElectionConfig):
        self.leases = leases  # ResourceClient for leases
        self.cfg = cfg
        self.is_leader = False
        self._stop = threading.Event()

    def _lease_body(self) -> dict:
        return {
            "kind": "Lease", "apiVersion": "coordination.k8s.io/v1",
            "metadata": {"name": self.cfg.lock_name},
            "spec": {"holderIdentity": self.cfg.identity,
                     "leaseDurationSeconds": int(self.cfg.lease_duration),
                     "renewTime": time.time()},
        }

    def try_acquire_or_renew(self) -> bool:
        now = time.time()
        try:
            lease = self.leases.get(self.cfg.lock_name)
        except (NotFound, ApiError):
            try:
                self.leases.create(self._lease_body())
                return True
            except (AlreadyExists, ApiError, Conflict):
                return False
        spec = lease.get("spec", {})
        holder = spec.get("holderIdentity", "")
        renew = float(spec.get("renewTime", 0) or 0)
        expired = now - renew > self.cfg.lease_duration
        if holder != self.cfg.identity and not expired:
            return False
        lease["spec"] = self._lease_body()["spec"]
        try:
            self.leases.update(lease)
            return True
        except (Conflict, ApiError):
            return False

    def _try(self) -> bool:
        """try_acquire_or_renew, treating ANY transport failure as a missed
        renewal. Only HTTPError becomes ApiError in the client; URLError /
        socket timeouts would otherwise kill the run() thread and leave a
        zombie leader (is_leader stuck True, renewals silently stopped)."""
        try:
            return self.try_acquire_or_renew()
        except Exception:  # ktpu-lint: disable=KTL002 -- failed acquire/renew = not leader this round; the elector loop logs leadership transitions
            return False

    def run(self, stop: Optional[threading.Event] = None):
        """Block: acquire, then renew until lost or stopped.

        Hardened against the silent-exit gap: ``_try`` already absorbs
        transport failures (an ApiError storm is just a missed renewal),
        and a CALLBACK that raises — on_started_leading failing to spin up
        the loop, on_stopped_leading tripping over partially-torn-down
        state — is logged + counted and drops leadership for this term
        instead of killing the elector thread. The next iteration backs
        off one retry_period and re-contends, so the loop resumes
        leadership as soon as the API (or the callback's precondition)
        heals."""
        stop = stop or self._stop
        while not stop.is_set():
            try:
                self._run_term(stop)
            except Exception:
                LOOP_ERRORS.inc({"site": "leader_elector"})
                _LOG.exception("leader-election term failed; dropping "
                               "leadership and re-contending")
                self.is_leader = False
                stop.wait(self.cfg.retry_period)

    def _run_term(self, stop: threading.Event) -> None:
        """One acquire -> renew -> release cycle (or a failed acquire)."""
        if not self._try():
            stop.wait(self.cfg.retry_period)
            return
        if not self.is_leader:
            self.is_leader = True
            if self.cfg.on_started_leading:
                try:
                    self.cfg.on_started_leading()
                except Exception:
                    # failed to take up the work: we hold the lease but
                    # lead nothing — release and re-contend rather than
                    # sitting as a zombie leader
                    self.is_leader = False
                    raise
        deadline = time.time() + self.cfg.renew_deadline
        while not stop.is_set():
            stop.wait(self.cfg.retry_period)
            if self._try():
                deadline = time.time() + self.cfg.renew_deadline
            elif time.time() > deadline:
                break
        if self.is_leader:
            self.is_leader = False
            if self.cfg.on_stopped_leading:
                self.cfg.on_stopped_leading()

    def stop(self):
        self._stop.set()
