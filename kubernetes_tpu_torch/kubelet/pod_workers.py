"""Pod workers — per-pod serialized sync state machines.

Reference: ``pkg/kubelet/pod_workers.go`` (``podWorkers.UpdatePod``: one
goroutine per pod draining a 1-deep "latest update wins" slot, so syncs for
one pod never run concurrently while distinct pods sync in parallel).
Sync failures are recorded — logged, counted per pod, and retried with
per-pod exponential backoff (the reference's workqueue-backed requeue) —
never silently swallowed: a persistently failing pod sync used to be
invisible until the next external update arrived.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from kubernetes_tpu_torch.metrics.registry import KUBELET_SYNC_ERRORS

_LOG = logging.getLogger(__name__)


class PodWorkers:
    def __init__(self, sync_fn: Callable[[str, Optional[dict]], None],
                 backoff_initial: float = 0.5, backoff_max: float = 10.0):
        self._sync = sync_fn  # sync_fn(uid, pod_or_None_for_terminate)
        self._lock = threading.Lock()
        self._pending: dict[str, Optional[dict]] = {}  # latest update wins
        self._busy: set[str] = set()
        self._stopped = False
        self._stop_evt = threading.Event()
        self.backoff_initial = backoff_initial
        self.backoff_max = backoff_max
        # consecutive sync failures per pod; cleared by the first success
        self._errors: dict[str, int] = {}

    def update_pod(self, uid: str, pod: Optional[dict]) -> None:
        with self._lock:
            if self._stopped:
                return
            self._pending[uid] = pod
            if uid in self._busy:
                return  # running worker picks the new update up when done
            self._busy.add(uid)
        threading.Thread(target=self._drain, args=(uid,), daemon=True).start()

    def sync_errors(self, uid: str) -> int:
        """Consecutive sync failures recorded for ``uid`` (0 = healthy)."""
        with self._lock:
            return self._errors.get(uid, 0)

    def _drain(self, uid: str) -> None:
        while True:
            with self._lock:
                if uid not in self._pending or self._stopped:
                    self._busy.discard(uid)
                    return
                pod = self._pending.pop(uid)
            try:
                self._sync(uid, pod)
            except Exception as e:
                with self._lock:
                    if self._stopped:
                        self._busy.discard(uid)
                        return
                    n = self._errors[uid] = self._errors.get(uid, 0) + 1
                    # retry the FAILED update unless a newer one superseded
                    # it while the sync ran (latest update still wins)
                    self._pending.setdefault(uid, pod)
                if n == 1:  # full traceback once; retries log one line
                    _LOG.exception("sync of pod %s failed", uid)
                else:
                    _LOG.warning("sync of pod %s failed (attempt %d): %s",
                                 uid, n, e)
                # aggregate counter only: a per-uid label would mint an
                # unbounded label set per failing pod for the process's
                # lifetime; per-pod counts live in sync_errors(uid)
                KUBELET_SYNC_ERRORS.inc()
                delay = min(self.backoff_initial * (2 ** (n - 1)),
                            self.backoff_max)
                # backoff belongs to the FAILED update only: a newer update
                # arriving meanwhile (including the None terminate) must
                # sync promptly, not wait out the old failure's delay
                deadline = time.monotonic() + delay
                while True:
                    with self._lock:
                        superseded = (self._stopped
                                      or self._pending.get(uid, pod)
                                      is not pod)
                    remaining = deadline - time.monotonic()
                    if superseded or remaining <= 0:
                        break
                    if self._stop_evt.wait(min(remaining, 0.05)):
                        with self._lock:
                            self._busy.discard(uid)
                        return
            else:
                with self._lock:
                    self._errors.pop(uid, None)

    def stop(self):
        with self._lock:
            self._stopped = True
            self._pending.clear()
        self._stop_evt.set()
