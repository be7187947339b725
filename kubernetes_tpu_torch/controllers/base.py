"""Controller base — the informer + workqueue + sync(key) reconcile pattern.

Reference shape: every controller in ``pkg/controller/<name>/`` is informer
event handlers enqueueing keys into a rate-limited workqueue, N workers
popping keys and running ``syncX(key)``; errors requeue with backoff,
successes forget. Wiring mirrors ``pkg/controller/controller_utils.go``
(owner-reference helpers: ``GetControllerOf``, adoption semantics).

The PyTorch port's copy of ``kubernetes_tpu/controllers/base.py`` (host
code only), with the informer indexes its pod-selecting controllers read
(``LABEL_INDEX``, ``CONTROLLER_INDEX``).
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Optional

from kubernetes_tpu_torch.client.informer import InformerFactory, meta_namespace_key
from kubernetes_tpu_torch.client.workqueue import RateLimitingQueue

_LOG = logging.getLogger(__name__)

MAX_REQUEUES = 15  # maxRetries in most upstream controllers


def controller_of(obj: dict) -> Optional[dict]:
    """The ownerReference with controller=true (metav1.GetControllerOf)."""
    for ref in (obj.get("metadata") or {}).get("ownerReferences") or []:
        if ref.get("controller"):
            return ref
    return None


def is_controlled_by(obj: dict, owner: dict) -> bool:
    ref = controller_of(obj)
    return ref is not None and ref.get("uid") == (owner.get("metadata") or {}).get("uid")


def owner_reference(owner: dict, kind: str) -> dict:
    md = owner.get("metadata") or {}
    return {
        "apiVersion": owner.get("apiVersion", "apps/v1"),
        "kind": kind,
        "name": md.get("name", ""),
        "uid": md.get("uid", ""),
        "controller": True,
        "blockOwnerDeletion": True,
    }


class Controller:
    """Workqueue-driven reconcile loop.

    Subclasses set ``name``, register informers in ``register(factory)`` and
    implement ``sync(key)``. ``enqueue(obj)`` / ``enqueue_owner(obj, kind)``
    are the standard event-handler bodies.
    """

    name = "controller"
    workers = 2
    # time-driven controllers (cronjob schedule ticks, TTL expiry, HPA
    # evaluation) set tick_interval and implement tick(); the base runs it
    # on a timer alongside the workers (the upstream analog is the informer
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

    def enqueue_owner(self, obj: dict, kind: str) -> None:
        """Enqueue the controlling owner of ``obj`` if it has the given kind
        (resolveControllerRef pattern: pod events wake the ReplicaSet, etc.)."""
        ref = controller_of(obj)
        if ref is not None and ref.get("kind") == kind:
            ns = (obj.get("metadata") or {}).get("namespace", "")
            self.queue.add(f"{ns}/{ref['name']}" if ns else ref["name"])

    def handler(self, enqueue_fn: Optional[Callable] = None):
        fn = enqueue_fn or self.enqueue

        def on_event(type_, obj, old):
            fn(obj)
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


# an informer index of objects by ``<namespace>/<label key>=<value>``: a
# controller whose sync selects pods by a label map reads the candidates
# from it instead of walking every pod in the cache (the port's addition;
# the reference walks)
LABEL_INDEX = "namespace-label"
# an informer index of objects by their controller's uid
CONTROLLER_INDEX = "controller-uid"


def namespace_labels(obj: dict) -> list[str]:
    md = obj.get("metadata") or {}
    ns = md.get("namespace", "")
    return [f"{ns}/{k}={v}" for k, v in (md.get("labels") or {}).items()]


def controller_uid(obj: dict) -> list[str]:
    ref = controller_of(obj)
    return [ref.get("uid", "")] if ref is not None else []


def selected(store, ns: str, selector: dict) -> list[dict]:
    """The objects of an informer's ``store`` (indexed by LABEL_INDEX) that
    may match the label map ``selector`` in namespace ``ns``: every one
    that does, in the store's order; the caller tests each as before."""
    return store.by_index(
        LABEL_INDEX, *(f"{ns}/{k}={v}" for k, v in selector.items()))


def split_key(key: str) -> tuple[str, str]:
    ns, _, name = key.rpartition("/")
    return ns, name


def active_pods(pods: list[dict]) -> list[dict]:
    """Pods not terminal and not being deleted (controller_utils FilterActivePods)."""
    return [p for p in pods
            if (p.get("status") or {}).get("phase") not in ("Succeeded", "Failed")
            and not (p.get("metadata") or {}).get("deletionTimestamp")]
