"""Controller base — the informer + workqueue + sync(key) reconcile pattern.

Reference shape: every controller in ``pkg/controller/<name>/`` is informer
event handlers enqueueing keys into a rate-limited workqueue, N workers
popping keys and running ``syncX(key)``; errors requeue with backoff,
successes forget.

The PyTorch port's copy of ``kubernetes_tpu/controllers/base.py`` (host code
only), cut to what the ResourceClaim controller uses: the owner-reference
helpers (``controller_of``, ``is_controlled_by``, ``owner_reference``,
``Controller.enqueue_owner``) and ``active_pods`` come back with the
controllers that call them (ROADMAP Queue A item 14).
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from kubernetes_tpu_torch.client.informer import InformerFactory, meta_namespace_key
from kubernetes_tpu_torch.client.workqueue import RateLimitingQueue

_LOG = logging.getLogger(__name__)

MAX_REQUEUES = 15  # maxRetries in most upstream controllers


class Controller:
    """Workqueue-driven reconcile loop.

    Subclasses set ``name``, register informers in ``register(factory)`` and
    implement ``sync(key)``. ``enqueue(obj)`` is the standard
    event-handler body.
    """

    name = "controller"
    workers = 2
    # time-driven controllers (here the ResourceClaim controller's release
    # sweep) set tick_interval and implement tick(); the base runs it on a
    # timer alongside the workers (the upstream analog is the informer
    # resync period re-delivering every object)
    tick_interval: Optional[float] = None

    def __init__(self, client):
        self.client = client
        self.queue = RateLimitingQueue()
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()

    # ---- wiring ----------------------------------------------------------

    def register(self, factory: InformerFactory) -> None:
        raise NotImplementedError

    def sync(self, key: str) -> None:
        raise NotImplementedError

    def enqueue(self, obj: dict) -> None:
        self.queue.add(meta_namespace_key(obj))

    def handler(self):
        def on_event(type_, obj, old):
            self.enqueue(obj)
        return on_event

    # ---- worker loop -----------------------------------------------------

    def start(self):
        for i in range(self.workers):
            t = threading.Thread(target=self._worker, daemon=True,
                                 name=f"{self.name}-{i}")
            t.start()
            self._threads.append(t)
        if self.tick_interval:
            t = threading.Thread(target=self._tick_loop, daemon=True,
                                 name=f"{self.name}-tick")
            t.start()
            self._threads.append(t)
        return self

    def tick(self) -> None:
        """Periodic work for time-driven controllers (see tick_interval)."""

    def _tick_loop(self):
        while not self._stop.wait(self.tick_interval):
            try:
                self.tick()
            except Exception:
                # the loop survives, but a failing tick is a stalled
                # controller — it must be visible in the logs
                _LOG.exception("%s tick failed; retrying next interval",
                               type(self).__name__)

    def stop(self):
        self._stop.set()
        self.queue.close()
        for t in self._threads:
            t.join(timeout=2.0)

    def _worker(self):
        while not self._stop.is_set():
            key = self.queue.get(timeout=0.2)
            if key is None:
                continue
            try:
                self.sync(key)
            except Exception:
                _LOG.exception("%s sync of %r failed",
                               type(self).__name__, key)
                if self.queue.num_requeues(key) < MAX_REQUEUES:
                    self.queue.add_rate_limited(key)
                else:
                    self.queue.forget(key)
            else:
                self.queue.forget(key)
            finally:
                self.queue.done(key)


def split_key(key: str) -> tuple[str, str]:
    ns, _, name = key.rpartition("/")
    return ns, name

