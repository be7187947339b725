"""Informers — list+watch replication into an indexed local cache.

Reference: ``client-go/tools/cache/reflector.go`` (``Reflector.ListAndWatch``
with relist on 410/expiry), ``shared_informer.go`` (``sharedIndexInformer``
with event handlers), ``store.go`` (``ThreadSafeStore`` + indexers). This is
the state-replication backbone every component sits on: the scheduler's cache
and every controller feed from these.

The port's copy of ``kubernetes_tpu/client/informer.py``, with
``add_indexers`` (indexers added to a shared informer by the controller
that needs them) and ``by_index`` answering for several values at once, in
the store's order.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from kubernetes_tpu_torch.api.selectors import compile_list_selector
from kubernetes_tpu_torch.client.clientset import ResourceClient
from kubernetes_tpu_torch.metrics.registry import LOOP_ERRORS, WATCH_RELISTS
from kubernetes_tpu_torch.store.store import ADDED, DELETED, MODIFIED, TooOld

_LOG = logging.getLogger("kubernetes_tpu_torch.client.informer")


def meta_namespace_key(obj: dict) -> str:
    md = obj.get("metadata") or {}
    ns = md.get("namespace", "")
    return f"{ns}/{md['name']}" if ns else md["name"]


class ThreadSafeStore:
    """Keyed object cache with named indexers (cache.ThreadSafeStore)."""

    def __init__(self, indexers: Optional[dict[str, Callable[[dict], list[str]]]] = None):
        self._lock = threading.RLock()
        self._items: dict[str, dict] = {}
        self._indexers = dict(indexers or {})
        self._indices: dict[str, dict[str, set[str]]] = {n: {} for n in self._indexers}
        # key -> when it entered (the order ``list`` walks), kept only while
        # the store has an indexer: an index answers in the same order as a
        # walk of the whole store
        self._order: dict[str, int] = {}
        self._added = 0
        self._reorder_locked()

    def _reorder_locked(self):
        # ``_items`` keeps its keys in the order they entered
        self._order = {k: i for i, k in enumerate(self._items)} \
            if self._indexers else {}
        self._added = len(self._order)

    def add_indexers(self, indexers: dict[str, Callable[[dict], list[str]]]):
        """Add named indexers (cache.Indexer AddIndexers), indexing what
        the store holds already; a name it has keeps its function."""
        with self._lock:
            for name, fn in indexers.items():
                if name in self._indexers:
                    continue
                first = not self._indexers
                self._indexers[name] = fn
                if first:
                    self._reorder_locked()
                self._indices[name] = {}
                for key, obj in self._items.items():
                    self._update_index_locked(key, None, obj)

    def _update_index_locked(self, key: str, old: Optional[dict], new: Optional[dict]):
        for name, fn in self._indexers.items():
            idx = self._indices[name]
            if old is not None:
                for v in fn(old):
                    idx.get(v, set()).discard(key)
            if new is not None:
                for v in fn(new):
                    idx.setdefault(v, set()).add(key)

    def add(self, key: str, obj: dict):
        with self._lock:
            old = self._items.get(key)
            if old is None and self._indexers:
                self._order[key] = self._added
                self._added += 1
            self._items[key] = obj
            self._update_index_locked(key, old, obj)

    def delete(self, key: str):
        with self._lock:
            old = self._items.pop(key, None)
            if old is not None:
                self._order.pop(key, None)
                self._update_index_locked(key, old, None)

    def get(self, key: str) -> Optional[dict]:
        with self._lock:
            return self._items.get(key)

    def list(self) -> list[dict]:
        with self._lock:
            return list(self._items.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def keys(self) -> list[str]:
        with self._lock:
            return list(self._items.keys())

    def by_index(self, index_name: str, *values: str) -> list[dict]:
        """The items whose ``index_name`` values hold every one of
        ``values``, in the order ``list`` gives them."""
        with self._lock:
            index = self._indices.get(index_name, {})
            sets = sorted((index.get(v, set()) for v in values), key=len)
            if not sets:
                return []
            keys = sets[0].intersection(*sets[1:])
            return [self._items[k] for k in sorted(keys, key=self._order.get)
                    if k in self._items]

    def replace(self, objs: dict[str, dict]):
        with self._lock:
            for k in list(self._items):
                if k not in objs:
                    self.delete(k)
            for k, o in objs.items():
                self.add(k, o)


class SharedInformer:
    """Reflector + ThreadSafeStore + fan-out event handlers.

    Handlers: fn(event_type, obj, old_obj_or_None). Sync handlers run on the
    watch thread (keep them fast — they feed queues)."""

    def __init__(self, resource: ResourceClient,
                 indexers: Optional[dict] = None,
                 label_selector: Optional[str] = None,
                 field_selector: Optional[str] = None):
        self.resource = resource
        self.store = ThreadSafeStore(indexers)
        self.label_selector = label_selector
        self.field_selector = field_selector
        # Same predicate the apiserver/DirectClient use at list time — watch
        # events must be re-matched with identical semantics (watch streams
        # are unfiltered by selectors; see APIServer._watch).
        self._selector = compile_list_selector(label_selector, field_selector)
        self._handlers: list[Callable] = []
        self._stop = threading.Event()
        self._synced = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # relist-and-resync bookkeeping: every relist AFTER the initial
        # sync means a watch gap healed (dropped/truncated stream, or a
        # "resourceVersion too old" 410) — counted so chaos runs can
        # assert the healing actually ran, surfaced in ktpu status
        self.relists = 0
        self.last_relist: Optional[float] = None
        # set while a watch gap is OPEN (stream died / list failing /
        # TooOld), cleared by the successful relist: consumers whose
        # decisions hinge on data freshness (node-lifecycle staleness
        # judgments) check this before trusting the cache's age.
        # last_gap_end/_duration record the most recently HEALED gap so
        # those consumers can distinguish a multi-second outage (grant a
        # fresh grace window) from a routine sub-second TooOld relist
        # under churn (which must not suppress anything).
        self.gap_since: Optional[float] = None
        self.last_gap_end: Optional[float] = None
        self.last_gap_duration = 0.0

    def add_event_handler(self, fn: Callable):
        self._handlers.append(fn)

    def add_indexers(self, indexers: dict):
        self.store.add_indexers(indexers)

    def has_synced(self) -> bool:
        return self._synced.is_set()

    def wait_for_cache_sync(self, timeout: float = 10.0) -> bool:
        return self._synced.wait(timeout)

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    # ---- Reflector.ListAndWatch -----------------------------------------

    def _run(self):
        backoff = 0.1
        while not self._stop.is_set():
            try:
                rv = self._list_and_notify()
                if self._synced.is_set():
                    # any list AFTER the first sync is a relist healing a
                    # watch gap: the rebuilt store + the delta dispatch in
                    # _list_and_notify are the resync
                    self.relists += 1
                    self.last_relist = time.time()
                    WATCH_RELISTS.inc(
                        {"resource": getattr(self.resource, "plural", "?")})
                self._synced.set()
                gs = self.gap_since
                if gs is not None:  # list succeeded: the gap healed
                    self.last_gap_duration = time.time() - gs
                    self.last_gap_end = time.time()
                    self.gap_since = None
                self._watch_loop(rv)
                if not self._stop.is_set():
                    # stream died (server restart / truncation): the cache
                    # ages untracked until the relist above heals it
                    self.gap_since = self.gap_since or time.time()
                backoff = 0.1
            except TooOld:
                self.gap_since = self.gap_since or time.time()
                continue  # immediate relist
            except Exception:
                self.gap_since = self.gap_since or time.time()
                LOOP_ERRORS.inc({"site": "informer_listwatch"})
                _LOG.debug("list/watch failed; backing off %.1fs",
                           backoff, exc_info=True)
                time.sleep(backoff)
                backoff = min(backoff * 2, 5.0)

    def _list_and_notify(self) -> int:
        items, rv = self.resource.list_rv(label_selector=self.label_selector,
                                          field_selector=self.field_selector)
        objs = {meta_namespace_key(o): o for o in items}
        old = {k: self.store.get(k) for k in self.store.keys()}
        self.store.replace(objs)
        for k, o in objs.items():
            self._dispatch(ADDED if k not in old else MODIFIED, o, old.get(k))
        for k, o in old.items():
            if k not in objs and o is not None:
                self._dispatch(DELETED, o, o)  # real last-known object
        return rv

    def _watch_loop(self, rv: int):
        w = self.resource.watch(since_rv=rv)
        try:
            while not self._stop.is_set():
                ev = w.get(timeout=0.2)
                if ev is None:
                    if getattr(w, "closed", False):
                        return
                    continue
                key = meta_namespace_key(ev.object)
                old = self.store.get(key)
                if not self._matches(ev.object):
                    if old is not None and ev.type != DELETED:
                        # matched -> unmatched transition IS a delete for us
                        self.store.delete(key)
                        self._dispatch(DELETED, old, old)
                    continue
                if ev.type == DELETED:
                    self.store.delete(key)
                else:
                    self.store.add(key, ev.object)
                self._dispatch(ev.type, ev.object, old)
        finally:
            w.stop()

    def _matches(self, obj: dict) -> bool:
        return self._selector(obj) if self._selector is not None else True

    def _dispatch(self, type_: str, obj: dict, old: Optional[dict]):
        for fn in self._handlers:
            try:
                fn(type_, obj, old)
            except Exception:
                # a handler that throws has dropped an event its component
                # will never see again until a relist: count + log, never
                # silently swallow (and never let one handler starve the
                # rest)
                LOOP_ERRORS.inc({"site": "informer_handler"})
                _LOG.warning("informer handler failed on %s %s", type_,
                             ((obj or {}).get("metadata") or {})
                             .get("name", "?"), exc_info=True)


class InformerFactory:
    """SharedInformerFactory analog: one informer per resource, shared."""

    def __init__(self, client):
        self.client = client
        self._informers: dict[tuple, SharedInformer] = {}

    def informer(self, plural: str, namespace: Optional[str] = None,
                 **kw) -> SharedInformer:
        key = (plural, namespace)
        if key not in self._informers:
            res = self.client.resource(plural, namespace)
            self._informers[key] = SharedInformer(res, **kw)
        return self._informers[key]

    def start_all(self):
        for inf in self._informers.values():
            if inf._thread is None:
                inf.start()

    def wait_for_cache_sync(self, timeout: float = 10.0) -> bool:
        return all(inf.wait_for_cache_sync(timeout)
                   for inf in self._informers.values())

    def stop_all(self):
        for inf in self._informers.values():
            inf.stop()
