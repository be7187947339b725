"""Versioned object store with watch — the etcd + watch-cache analog.

Reference: ``staging/src/k8s.io/apiserver/pkg/storage/etcd3/store.go`` (CRUD +
watch translation) fronted by ``storage/cacher/cacher.go`` (in-memory watch
fan-out). One process-local store stands in for both: a monotone
resourceVersion counter, per-(kind) keyspaces, optimistic-concurrency updates,
and buffered watch channels with bounded replay ("too old" -> relist, like
etcd compaction).

Checkpoint/resume: the cluster state IS the checkpoint (SURVEY §5) —
``save``/``load`` serialize the whole keyspace; components rebuild everything
else from watches.

Durability (etcd's WAL + snapshot analog): pass ``data_dir`` and every
mutation is journaled to ``wal.jsonl`` inside the store lock before the call
returns; the journal is folded into ``snapshot.json`` (atomic tmp+rename)
every ``wal_compact_every`` entries. A store opened on an existing data_dir
restores snapshot + replays the journal tail — an apiserver restart keeps
all pods/bindings, and watchers relist exactly as clients of a compacted
etcd would (TooOld on pre-restart resourceVersions).

Crash tolerance: a record commits when its trailing newline reaches the
file. A SIGKILL mid-append leaves a torn final line; restore drops it
(counting ``store_wal_torn_tail_total``) AND truncates the file back to
the last committed record — the WAL reopens in append mode, and a fresh
entry concatenated onto a torn line would corrupt a COMMITTED record at
the next restore. ``defer_restore=True`` constructs the store without
replaying (the apiserver's async-startup mode: serve /readyz 503 while
``finish_restore()`` runs on a background thread).
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from kubernetes_tpu_torch.metrics.registry import WATCH_CLIENTS, WATCH_DROPS

_LOG = logging.getLogger("kubernetes_tpu_torch.store")

ADDED, MODIFIED, DELETED, ERROR = "ADDED", "MODIFIED", "DELETED", "ERROR"

# Events kept per kind for watch replay before "too old" (etcd compaction
# analog). Sized so a reconnecting watcher survives a full binding storm
# (create+bind = 2 events/pod) at the 10k-pod benchmark scale.
REPLAY_WINDOW = 32768

# Watcher fan-out shards per kind: registration, removal and slow-consumer
# handling contend on a shard's own lock, never the store lock — watcher
# churn at 10k-client scale stays off the write path. Emission nests shard
# locks inside the store lock (store -> shard, never the reverse).
WATCH_SHARDS = 8

# Bounded per-watcher queue (reference analog: cacher.go's per-watcher
# channel budget). A consumer that falls this many events behind is
# disconnected with an ERROR event and a counted drop — it relists, exactly
# as it would after etcd compaction — instead of growing an unbounded queue
# and stalling shard siblings. A watch() whose replay backlog already
# exceeds this budget gets TooOld up front (a relist hands it the same
# state cheaper).
WATCH_QUEUE_MAX = 4096


class Conflict(Exception):
    """resourceVersion mismatch (optimistic concurrency failure)."""


class NotFound(Exception):
    pass


class AlreadyExists(Exception):
    pass


class TooOld(Exception):
    """Requested watch resourceVersion compacted away; caller must relist."""


def fastcopy(o):
    """Structural copy of an already wire-shaped object (dict/list/scalars).
    ~2x faster than a json round-trip; used for copies of objects the store
    has already normalized (create/update inputs still json-round-trip so
    tuples/np scalars are coerced to the wire shape exactly once)."""
    if isinstance(o, dict):
        return {k: fastcopy(v) for k, v in o.items()}
    if isinstance(o, list):
        return [fastcopy(v) for v in o]
    return o


@dataclass
class Event:
    type: str
    object: dict
    resource_version: int
    _wire: Optional[bytes] = None     # cached JSON watch line (lazy, shared)
    _wire_mp: Optional[bytes] = None  # cached msgpack frame (lazy, shared)

    def wire(self) -> bytes:
        """Serialized ``{"type":...,"object":...}\\n`` watch line. Computed
        once and shared by every HTTP watch stream fanning this event out —
        per-watcher re-serialization was the apiserver's top cost under
        binding storms. Benign race: two threads may both compute it."""
        w = self._wire
        if w is None:
            w = json.dumps({"type": self.type, "object": self.object}
                           ).encode() + b"\n"
            self._wire = w
        return w

    def wire_msgpack(self) -> bytes:
        """msgpack frame of the same payload — the binary watch stream
        (reference analog: protobuf watch negotiation,
        ``apimachinery/pkg/runtime/serializer``). ~4x cheaper to encode and
        ~2x to decode than the JSON line; cached and shared identically."""
        w = self._wire_mp
        if w is None:
            import msgpack
            w = msgpack.packb({"type": self.type, "object": self.object})
            self._wire_mp = w
        return w


def obj_key(obj: dict) -> tuple[str, str]:
    md = obj.get("metadata") or {}
    return (md.get("namespace") or "", md["name"])


class _WatchShard:
    """One independently-locked slice of a kind's watcher registry.

    The fan-out path (holding the store lock) takes each shard lock in
    turn; everything else — register, drop, slow-consumer eviction, stats
    — touches only this shard's lock. Lock order is store -> shard; no
    shard method ever takes the store lock, so a storm of watchers
    connecting/disconnecting serializes against 1/K of the registry and
    never against writers."""

    def __init__(self):
        self.lock = threading.Lock()
        # guarded by: self.lock
        self.queues: list[queue.Queue] = []
        self.drops = 0  # guarded by: self.lock

    def add(self, q: "queue.Queue[Event]") -> None:
        with self.lock:
            self.queues.append(q)

    def discard(self, q: "queue.Queue[Event]") -> bool:
        with self.lock:
            if q in self.queues:
                self.queues.remove(q)
                return True
            return False

    def stats(self) -> tuple[int, int]:
        """-> (live watcher queues, cumulative slow-consumer drops)."""
        with self.lock:
            return len(self.queues), self.drops

    @staticmethod
    def _overflow(q: "queue.Queue[Event]", rv: int) -> None:
        """Slow consumer: drain its queue and leave a single ERROR event —
        the stream closes and the client relists, identical to compaction.
        Draining here is safe: the producer side is this shard pass (we
        hold the shard lock) and the consumer only ever removes."""
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        try:
            q.put_nowait(Event(ERROR, {}, rv))
        except queue.Full:
            pass  # consumer raced the drain; it still sees the severed stream

    def emit(self, evs) -> int:
        """Fan events to every queue in this shard; overflowing watchers
        are evicted with a counted drop. Returns drops this pass."""
        rv = evs[-1].resource_version
        dropped = []
        with self.lock:
            for q in self.queues:
                try:
                    for ev in evs:
                        q.put_nowait(ev)
                except queue.Full:
                    self._overflow(q, rv)
                    dropped.append(q)
            for q in dropped:
                self.queues.remove(q)
            self.drops += len(dropped)
        return len(dropped)

    def invalidate(self, rv: int) -> None:
        """Checkpoint restore / snapshot install: every stream on this
        shard is severed with ERROR (consumers must relist)."""
        with self.lock:
            for q in self.queues:
                try:
                    q.put_nowait(Event(ERROR, {}, rv))
                except queue.Full:
                    self._overflow(q, rv)
            self.queues.clear()


class Watcher:
    def __init__(self, store: "ObjectStore", kind: str, q: "queue.Queue[Event]"):
        self._store = store
        self._kind = kind
        self._q = q
        self.closed = False

    def __iter__(self):
        return self

    def __next__(self) -> Event:
        while not self.closed:
            ev = self.get(timeout=0.2)
            if ev is not None:
                return ev
        raise StopIteration

    def get(self, timeout: float = 0.2) -> Optional[Event]:
        if self.closed:
            return None
        try:
            ev = self._q.get(timeout=timeout)
        except queue.Empty:
            return None
        if ev.type == ERROR:
            # Stream invalidated (checkpoint restore); consumer must relist.
            self.closed = True
            return None
        return ev

    def stop(self):
        self.closed = True
        self._store._drop_watcher(self._kind, self._q)


class ObjectStore:
    """Thread-safe multi-kind object store. Objects are plain dicts in the k8s
    wire shape; metadata.resourceVersion is stamped on every write."""

    def __init__(self, data_dir: Optional[str] = None,
                 wal_compact_every: int = 4096, fsync: bool = False,
                 defer_restore: bool = False):
        self._lock = threading.Lock()
        self._rv = 0
        self._data: dict[str, dict[tuple[str, str], dict]] = {}
        self._history: dict[str, list[Event]] = {}
        # Highest rv trimmed out of each kind's replay history ("compaction
        # point"). TooOld is per kind: a quiet kind's full history stays
        # replayable no matter how fast the global rv advances. _floor_rv is
        # the all-kinds compaction point set by a checkpoint restore, which
        # discards every kind's history (including kinds absent from the
        # checkpoint blob).
        self._compacted: dict[str, int] = {}
        self._floor_rv = 0
        # Watcher registry: per kind, WATCH_SHARDS independently-locked
        # fan-out shards. Writes (creating a kind's shard list) happen under
        # the store lock; a shard list, once created, is never replaced —
        # invalidation clears queues in place — so _drop_watcher may read
        # the dict without the store lock (watcher churn must never contend
        # with the write path).
        self._shards: dict[str, list[_WatchShard]] = {}
        self._watch_seq = 0      # guarded by: self._lock
        self._fanout_ns = 0      # guarded by: self._lock
        self._fanout_events = 0  # guarded by: self._lock
        self._data_dir = data_dir
        self._journal_subs: list = []  # replication taps (under the lock)
        self._wal_compact_every = wal_compact_every
        self._fsync = fsync
        self._wal = None
        self._wal_count = 0
        self._closed = False
        # durability observability (ktpu status Durability line / readyz)
        self._last_snapshot_ts: Optional[float] = None
        self._restore_stats: dict = {}
        self._torn_tails = 0
        if data_dir:
            os.makedirs(data_dir, exist_ok=True)
            if not defer_restore:
                self.finish_restore()

    def finish_restore(self) -> None:
        """Replay snapshot + WAL and open the journal for appends. Called
        from __init__ unless ``defer_restore``; the deferred form lets the
        apiserver begin serving 503s while a long replay runs on a
        background thread (readyz flips when this returns). Idempotent."""
        if self._data_dir is None:
            return  # nothing to replay, nothing to journal
        with self._lock:
            if self._wal is not None or self._closed:
                # _closed: a deferred restore racing close() (server
                # stopped before the replay thread ran) must NOT reopen
                # the WAL — a successor process may already own the file,
                # and this instance's appends would interleave stale-rv
                # records into its journal
                return
            self._restore_locked()
            self._wal = open(self._wal_path, "a", buffering=1)

    @property
    def _snap_path(self):
        return os.path.join(self._data_dir, "snapshot.json")

    @property
    def _wal_path(self):
        return os.path.join(self._data_dir, "wal.jsonl")

    # ---- internals -------------------------------------------------------

    def _bump_locked(self) -> int:
        self._rv += 1
        return self._rv

    def _emit_many_locked(self, kind: str, evs: list[Event]):
        """Batched watch fan-out: one history append + trim and ONE pass
        per fan-out shard for a whole bulk verb's events, instead of
        per-event bookkeeping. Semantically identical to N _emit_locked
        calls — every surviving watcher still receives every event in
        order; a watcher whose bounded queue overflows is evicted with an
        ERROR event and a counted drop (it relists, compaction-style)."""
        if not evs:
            return
        hist = self._history.setdefault(kind, [])
        hist.extend(evs)
        if len(hist) > REPLAY_WINDOW:
            cut = len(hist) - REPLAY_WINDOW
            self._compacted[kind] = hist[cut - 1].resource_version
            del hist[:cut]
        shards = self._shards.get(kind)
        if not shards:
            return
        t0 = time.perf_counter_ns()
        dropped = 0
        for shard in shards:
            dropped += shard.emit(evs)
        self._fanout_ns += time.perf_counter_ns() - t0
        self._fanout_events += len(evs)
        if dropped:
            WATCH_DROPS.inc({"kind": kind}, by=dropped)

    def _emit_locked(self, kind: str, ev: Event):
        # Event payloads SHARE the authoritative object: the store never
        # mutates a stored dict in place (every write REPLACES space[k] with
        # a fresh object), so sharing is safe as long as consumers treat
        # event objects as read-only — the reference's informer-cache
        # convention ("you must deep-copy before mutating"), which get()/
        # list() honor by returning copies. A binding storm emits tens of
        # thousands of events; the per-event detach copy was measurable
        # against the whole connected path.
        self._emit_many_locked(kind, [ev])

    def _drop_watcher(self, kind: str, q):
        # shard-lock only: 10k clients connecting/disconnecting must not
        # contend with writers holding the store lock
        shards = self._shards.get(kind, ())
        for shard in shards:
            if shard.discard(q):
                break
        self._set_watch_gauge(kind, shards)

    @staticmethod
    def _set_watch_gauge(kind: str, shards) -> None:
        WATCH_CLIENTS.set(sum(s.stats()[0] for s in shards), {"kind": kind})

    # ---- durability ------------------------------------------------------

    def _journal_locked(self, entry: dict):
        for fn in self._journal_subs:
            fn(entry)  # replication taps the journal (store/replication.py)
        if self._wal is None:
            return
        self._wal.write(json.dumps(entry) + "\n")
        if self._fsync:
            self._wal.flush()
            os.fsync(self._wal.fileno())
        self._wal_count += 1
        if self._wal_count >= self._wal_compact_every:
            self._compact_wal_locked()

    def _compact_wal_locked(self):
        """Fold the journal into the snapshot: write snapshot.tmp, fsync,
        rename (atomic on POSIX), truncate the WAL."""
        blob = {kind: list(space.values())
                for kind, space in self._data.items()}
        from kubernetes_tpu_torch.utils.atomicio import atomic_write_json
        atomic_write_json(self._snap_path, {"rv": self._rv, "data": blob})
        if self._wal is not None:
            self._wal.close()
        self._wal = open(self._wal_path, "w", buffering=1)
        self._wal_count = 0
        import time as _time
        self._last_snapshot_ts = _time.time()

    def _restore_locked(self):
        """Snapshot + WAL tail -> memory. Called once (no watchers exist
        yet). A record is committed iff its trailing newline reached the
        file: a SIGKILL mid-append leaves a torn final line, which is
        dropped (counted in ``store_wal_torn_tail_total``) AND truncated
        off the file — the WAL reopens for append, so surviving torn bytes
        would merge with the next record and corrupt a COMMITTED write at
        a later restore."""
        import time as _time
        t0 = _time.perf_counter()
        stats: dict = {"snapshotLoaded": False, "walEntriesReplayed": 0,
                       "tornTailDropped": 0}
        if os.path.exists(self._snap_path):
            with open(self._snap_path) as f:
                data = json.load(f)
            self._rv = data["rv"]
            self._data = {kind: {tuple(obj_key(o)): o for o in objs}
                          for kind, objs in data["data"].items()}
            stats["snapshotLoaded"] = True
            try:
                self._last_snapshot_ts = os.path.getmtime(self._snap_path)
            except OSError:
                pass
        if os.path.exists(self._wal_path):
            good_end = 0  # byte offset just past the last committed record
            torn = False
            with open(self._wal_path, "rb") as f:
                while True:
                    line = f.readline()
                    if not line:
                        break
                    if not line.endswith(b"\n"):
                        torn = True  # mid-append kill: newline never landed
                        break
                    try:
                        e = json.loads(line)
                        rv = int(e["rv"])
                        op, kind = e["op"], e["kind"]
                        key = (e["ns"], e["name"])
                        obj = e.get("obj")
                    except (ValueError, KeyError, TypeError):
                        # torn or corrupt record: everything before it is
                        # committed, nothing after it is trusted
                        torn = True
                        break
                    good_end = f.tell()
                    if rv <= self._rv:
                        # already folded into the snapshot (crash between
                        # snapshot rename and WAL truncate)
                        continue
                    space = self._data.setdefault(kind, {})
                    if op == "set":
                        space[key] = obj
                    elif op == "del":
                        space.pop(key, None)
                    self._rv = max(self._rv, rv)
                    stats["walEntriesReplayed"] += 1
            if torn:
                from kubernetes_tpu_torch.metrics.registry import WAL_TORN_TAIL
                WAL_TORN_TAIL.inc()
                self._torn_tails += 1
                stats["tornTailDropped"] = 1
                _LOG.warning(
                    "WAL %s has a torn tail (crash mid-append): dropping "
                    "uncommitted bytes past offset %d", self._wal_path,
                    good_end)
                try:
                    os.truncate(self._wal_path, good_end)
                except OSError:
                    _LOG.exception("could not truncate torn WAL tail; the "
                                   "next append may corrupt a record")
        # compaction cadence counts entries since the last snapshot, and
        # survives restarts: a WAL that restores long must fold soon
        self._wal_count = stats["walEntriesReplayed"]
        stats["replayMs"] = round((_time.perf_counter() - t0) * 1000.0, 2)
        self._restore_stats = stats
        self._floor_rv = self._rv
        self._reseed_service_ips_locked()

    def _reseed_service_ips_locked(self):
        """Advance the ClusterIP allocator past every Service present —
        restores, snapshot installs, and replicated applies must never
        re-issue a VIP an existing Service holds (a promoted follower
        would otherwise hand out duplicates)."""
        seq = getattr(self, "_svc_ip_seq", 0)
        for (_ns, _n), svc in self._data.get("Service", {}).items():
            ip = (svc.get("spec") or {}).get("clusterIP") or ""
            parts = ip.split(".")
            if len(parts) == 4 and ip.startswith("10.96."):
                seq = max(seq, int(parts[2]) * 250 + int(parts[3]) - 1)
        if seq:
            self._svc_ip_seq = seq

    # ---- durability observability ----------------------------------------

    def durability_stats(self) -> dict:
        """The Durability block of ``ktpu status`` (published by the
        apiserver's status ConfigMap in data_dir mode): WAL growth since
        the last snapshot fold, snapshot age, what the last restore cost
        and whether it dropped a torn tail."""
        with self._lock:
            return {
                "durable": self._data_dir is not None,
                "walEntriesSinceSnapshot": self._wal_count,
                "lastSnapshotTime": self._last_snapshot_ts,
                "replayMs": self._restore_stats.get("replayMs"),
                "walEntriesReplayed":
                    self._restore_stats.get("walEntriesReplayed", 0),
                "snapshotLoaded":
                    self._restore_stats.get("snapshotLoaded", False),
                "tornTailsDropped": self._torn_tails,
                "rv": self._rv,
            }

    # ---- replication hooks (store/replication.py) ------------------------

    def snapshot_rv(self) -> int:
        """Current rv (method form for replication call sites)."""
        with self._lock:
            return self._rv

    def subscribe_journal(self, fn) -> None:
        """``fn(entry)`` fires under the store lock for every journaled
        mutation — keep it O(1) (append to a buffer; never do I/O)."""
        with self._lock:
            self._journal_subs.append(fn)

    def apply_replicated(self, entry: dict) -> None:
        """Apply a replicated journal entry at ITS rv (follower side): the
        twin of the WAL replay in _restore_locked, but live — watchers see
        the event, so informers on a follower stay current."""
        kind = entry["kind"]
        rv = int(entry["rv"])
        with self._lock:
            if rv <= self._rv:
                return  # duplicate delivery
            space = self._data.setdefault(kind, {})
            key = (entry["ns"], entry["name"])
            if entry["op"] == "set":
                existed = key in space
                space[key] = entry["obj"]
                self._rv = rv
                if kind == "Service":
                    self._reseed_service_ips_locked()
                # journal like a local write: quorum-acked entries must be
                # WAL-durable on FOLLOWERS too, and the journal tap is how
                # a follower's raft log stays populated (a promoted leader
                # with an empty log would force a snapshot storm)
                self._journal_locked(entry)
                self._emit_locked(kind, Event(
                    MODIFIED if existed else ADDED, entry["obj"], rv))
            else:
                old = space.pop(key, None)
                self._rv = rv
                self._journal_locked(entry)
                if old is not None:
                    self._emit_locked(kind, Event(DELETED, old, rv))

    def snapshot_blob(self) -> dict:
        with self._lock:
            return {"rv": self._rv,
                    "data": {kind: list(space.values())
                             for kind, space in self._data.items()}}

    def load_snapshot_blob(self, blob: dict) -> None:
        """Full-state resync (a follower too far behind the leader's
        replication window, or a rejoining ex-leader with a divergent
        uncommitted suffix) — the load() contract: live watch streams are
        invalidated (ERROR event -> informers relist), since a stream that
        silently missed the snapshot delta would retain phantoms forever."""
        with self._lock:
            self._install_state_locked(
                int(blob["rv"]),
                {kind: {tuple(obj_key(o)): o for o in objs}
                 for kind, objs in blob["data"].items()})

    # ---- CRUD ------------------------------------------------------------

    def _prepare_create_locked(self, kind: str, obj: dict) -> dict:
        """Registry PrepareForCreate hooks shared by create/create_many:
        Service ClusterIP allocation (pkg/registry/core/service/ipallocator)
        from 10.96.0.0/12."""
        if kind == "Service":
            spec = obj.get("spec") or {}
            if not spec.get("clusterIP") and spec.get("type") != "ExternalName":
                self._svc_ip_seq = getattr(self, "_svc_ip_seq", 0) + 1
                n = self._svc_ip_seq
                obj = dict(obj)
                obj["spec"] = {**spec,
                               "clusterIP": f"10.96.{n // 250}.{n % 250 + 1}"}
        return obj

    def create(self, kind: str, obj: dict, owned: bool = False) -> dict:
        """``owned=True``: the caller transfers ownership of ``obj`` (it is a
        freshly-parsed, wire-shaped dict nothing else aliases — e.g. an HTTP
        request body) so the defensive copy/normalization round-trip is
        skipped."""
        with self._lock:
            md = obj.get("metadata") or {}
            if not md.get("name") and md.get("generateName"):
                # names.SimpleNameGenerator analog: generateName + unique
                # suffix. The rv counter is the suffix source — monotone AND
                # checkpoint-persisted, so restored stores can never re-issue
                # a name that an existing object carries.
                obj = dict(obj)
                obj["metadata"] = {**md, "name": f"{md['generateName']}{self._rv + 1:05x}"}
            k = obj_key(obj)
            space = self._data.setdefault(kind, {})
            if k in space:
                raise AlreadyExists(f"{kind} {k}")
            obj = self._prepare_create_locked(kind, obj)
            rv = self._bump_locked()
            if not owned:
                obj = json.loads(json.dumps(obj))  # defensive copy, wire-shaped
            md = obj.setdefault("metadata", {})
            md["resourceVersion"] = str(rv)
            # registry.Store.Create stamps identity server-side
            md.setdefault("uid", f"uid-s{rv}")
            if "creationTimestamp" not in md:
                import time as _time
                md["creationTimestamp"] = _time.time()
            space[k] = obj
            self._journal_locked({"op": "set", "kind": kind, "ns": k[0],
                                  "name": k[1], "rv": rv, "obj": obj})
            self._emit_locked(kind, Event(ADDED, obj, rv))
            return fastcopy(obj)

    def create_many(self, kind: str, objs: list[dict]) -> list[dict]:
        """Create a batch of objects in one lock pass (seeding / apply of a
        manifest List). Per-item AlreadyExists surfaces as an exception AFTER
        the siblings commit — callers wanting all-or-nothing pre-check names.
        Semantically identical to N create() calls, minus N-1 lock
        round-trips and defensive-copy passes."""
        from kubernetes_tpu_torch.metrics.registry import BULK_REQUESTS
        BULK_REQUESTS.inc({"endpoint": "bulk-create"})
        out = []
        errors = []
        with self._lock:
            space = self._data.setdefault(kind, {})
            for obj in objs:
                md = obj.get("metadata") or {}
                if not md.get("name") and md.get("generateName"):
                    obj = dict(obj)
                    obj["metadata"] = {**md,
                                       "name": f"{md['generateName']}{self._rv + 1:05x}"}
                k = obj_key(obj)
                if k in space:
                    errors.append(f"{kind} {k}")
                    continue
                obj = self._prepare_create_locked(kind, obj)
                rv = self._bump_locked()
                obj = json.loads(json.dumps(obj))
                md = obj.setdefault("metadata", {})
                md["resourceVersion"] = str(rv)
                md.setdefault("uid", f"uid-s{rv}")
                if "creationTimestamp" not in md:
                    import time as _time
                    md["creationTimestamp"] = _time.time()
                space[k] = obj
                self._journal_locked({"op": "set", "kind": kind, "ns": k[0],
                                      "name": k[1], "rv": rv, "obj": obj})
                self._emit_locked(kind, Event(ADDED, obj, rv))
                out.append(fastcopy(obj))
        if errors:
            raise AlreadyExists("; ".join(errors))
        return out

    def get(self, kind: str, namespace: str, name: str) -> dict:
        with self._lock:
            try:
                return fastcopy(self._data[kind][(namespace or "", name)])
            except KeyError:
                raise NotFound(f"{kind} {namespace}/{name}") from None

    def list(self, kind: str, namespace: Optional[str] = None,
             selector: Optional[Callable[[dict], bool]] = None
             ) -> tuple[list[dict], int]:
        """-> (items, listResourceVersion)."""
        with self._lock:
            items = []
            for (ns, _), obj in sorted(self._data.get(kind, {}).items()):
                if namespace is not None and ns != namespace:
                    continue
                if selector is not None and not selector(obj):
                    continue
                items.append(fastcopy(obj))
            return items, self._rv

    def update(self, kind: str, obj: dict, expect_rv: Optional[str] = None,
               owned: bool = False) -> dict:
        with self._lock:
            k = obj_key(obj)
            space = self._data.setdefault(kind, {})
            if k not in space:
                raise NotFound(f"{kind} {k}")
            current = space[k]
            if expect_rv is not None and current["metadata"]["resourceVersion"] != expect_rv:
                raise Conflict(f"{kind} {k}: rv {expect_rv} != "
                               f"{current['metadata']['resourceVersion']}")
            rv = self._bump_locked()
            if not owned:
                obj = json.loads(json.dumps(obj))
            md = obj.setdefault("metadata", {})
            md["resourceVersion"] = str(rv)
            # deletionTimestamp is SERVER-owned and sticky (apimachinery:
            # immutable once set): carry the stored value — a payload can
            # neither resurrect a terminating object by dropping it nor
            # destroy a live one by injecting it (which would bypass the
            # delete reactors and admission)
            cur_dt = (current.get("metadata") or {}).get("deletionTimestamp")
            if cur_dt is not None:
                md["deletionTimestamp"] = cur_dt
            else:
                md.pop("deletionTimestamp", None)
            if md.get("deletionTimestamp") and not md.get("finalizers"):
                # the last finalizer just came off a terminating object:
                # the update COMPLETES the graceful delete
                space.pop(k, None)
                self._journal_locked({"op": "del", "kind": kind,
                                      "ns": k[0], "name": k[1], "rv": rv})
                self._emit_locked(kind, Event(DELETED, obj, rv))
                return fastcopy(obj)
            space[k] = obj
            self._journal_locked({"op": "set", "kind": kind, "ns": k[0],
                                  "name": k[1], "rv": rv, "obj": obj})
            self._emit_locked(kind, Event(MODIFIED, obj, rv))
            return fastcopy(obj)

    def bind_many(self, bindings: list[tuple[str, str, str]]
                  ) -> list[Optional[str]]:
        """Apply many pod bindings in ONE lock pass: for each
        ``(namespace, name, node_name)`` set spec.nodeName if unset.
        Returns a per-item error string (or None on success) — successes
        commit even when siblings fail, exactly like N independent binding
        POSTs, minus N-1 round trips and lock acquisitions.

        This is the storage half of the bulk-binding fast path (reference:
        ``pkg/registry/core/pod/storage/storage.go`` BindingREST.Create,
        generalized to a batch — the reference has no bulk variant; its
        scheduler binds one pod per POST, which is exactly the per-pod
        round-trip cost this path removes)."""
        from kubernetes_tpu_torch.metrics.registry import BULK_REQUESTS
        BULK_REQUESTS.inc({"endpoint": "pods/-/binding"})
        out: list[Optional[str]] = []
        with self._lock:
            space = self._data.setdefault("Pod", {})
            for ns, name, node_name in bindings:
                k = (ns or "", name)
                pod = space.get(k)
                if pod is None:
                    out.append(f"Pod {ns}/{name} not found")
                    continue
                if (pod.get("spec") or {}).get("nodeName"):
                    out.append("pod already bound")
                    continue
                # no expect_rv needed: the whole check-then-set runs under
                # the store lock, so no other writer can interleave
                rv = self._bump_locked()
                pod = fastcopy(pod)
                pod.setdefault("spec", {})["nodeName"] = node_name
                pod.setdefault("status", {}).setdefault("phase", "Pending")
                pod["metadata"]["resourceVersion"] = str(rv)
                space[k] = pod
                self._journal_locked({"op": "set", "kind": "Pod", "ns": k[0],
                                      "name": k[1], "rv": rv, "obj": pod})
                self._emit_locked("Pod", Event(MODIFIED, pod, rv))
                out.append(None)
        return out

    def update_status_many(self, kind: str, items: list[tuple[str, str, dict]]
                           ) -> list[Optional[str]]:
        """Apply many STATUS updates in ONE lock pass: for each
        ``(namespace, name, status)`` replace the object's status subtree.
        Returns a per-item error string (or None on success); successes
        commit even when siblings fail, exactly like N independent status
        PUTs minus N-1 round trips and lock acquisitions.

        No rv precondition: the kubelet owns its pods' status and already
        serializes per-pod writes (PodWorkers), so last-write-wins within
        one owner is the reference's status-manager semantics. This is the
        storage half of the kubemark status batcher — 500 hollow kubelets
        each PUTting Pending->Running transitions one at a time were the
        kubemark bottleneck."""
        from kubernetes_tpu_torch.metrics.registry import BULK_REQUESTS
        BULK_REQUESTS.inc({"endpoint": "pods/-/status"})
        out: list[Optional[str]] = []
        with self._lock:
            space = self._data.setdefault(kind, {})
            for ns, name, status in items:
                k = (ns or "", name)
                cur = space.get(k)
                if cur is None:
                    out.append(f"{kind} {ns}/{name} not found")
                    continue
                rv = self._bump_locked()
                obj = fastcopy(cur)
                # detach from the caller's dict: DirectClient callers may
                # reuse/mutate their status template after the call, and the
                # stored object + emitted event must not change under them
                obj["status"] = fastcopy(status)
                obj["metadata"]["resourceVersion"] = str(rv)
                space[k] = obj
                self._journal_locked({"op": "set", "kind": kind, "ns": k[0],
                                      "name": k[1], "rv": rv, "obj": obj})
                self._emit_locked(kind, Event(MODIFIED, obj, rv))
                out.append(None)
        return out

    def heartbeat_many(self, items: list[tuple[str, dict]]
                       ) -> list[Optional[str]]:
        """Apply many NODE heartbeat status refreshes in ONE lock pass: for
        each ``(name, status_patch)`` merge the patch into the node's
        status — ``conditions`` merge BY TYPE (a Ready refresh replaces the
        Ready condition and leaves NetworkUnavailable & co alone; exactly
        what the per-node heartbeat's read-modify-write produced), every
        other key (addresses, daemonEndpoints, ...) replaces wholesale.
        Returns a per-item error string (or None); successes commit even
        when siblings fail, and each item gets its own resourceVersion +
        MODIFIED event — bulk and singleton heartbeats are
        indistinguishable to a watcher. Watch fan-out happens in one batch
        pass at the end (the hot cost at 10k-node fleet scale).

        No rv precondition: the kubelet owns its node's status and the
        fleet batcher serializes per-node writes, so last-write-wins
        within one owner — the update_status_many discipline."""
        from kubernetes_tpu_torch.metrics.registry import BULK_REQUESTS
        BULK_REQUESTS.inc({"endpoint": "nodes/-/status"})
        out: list[Optional[str]] = []
        evs: list[Event] = []
        with self._lock:
            space = self._data.setdefault("Node", {})
            for name, patch in items:
                k = ("", name)
                cur = space.get(k)
                if cur is None:
                    out.append(f"Node {name} not found")
                    continue
                rv = self._bump_locked()
                obj = fastcopy(cur)
                st = obj.setdefault("status", {})
                patch = fastcopy(patch)
                for key, val in patch.items():
                    if key == "conditions":
                        by_type = {c.get("type"): c for c in val}
                        merged = [by_type.pop(c.get("type"), c)
                                  for c in st.get("conditions") or []]
                        st["conditions"] = merged + list(by_type.values())
                    else:
                        st[key] = val
                obj["metadata"]["resourceVersion"] = str(rv)
                space[k] = obj
                self._journal_locked({"op": "set", "kind": "Node", "ns": "",
                                      "name": name, "rv": rv, "obj": obj})
                evs.append(Event(MODIFIED, obj, rv))
                out.append(None)
            self._emit_many_locked("Node", evs)
        return out

    def renew_leases(self, namespace: str, items: list[tuple[str, float]]
                     ) -> list[Optional[str]]:
        """Bump ``spec.renewTime`` on many Leases in ONE lock pass: for
        each ``(name, renew_time)`` in ``namespace``. Returns per-item
        error string (or None); a missing Lease reports "not found"
        without failing its siblings (the fleet batcher bulk-creates the
        missing ones and renews them next period). Same per-item
        resourceVersion + MODIFIED-event discipline as N singleton
        updates, minus N-1 round trips; watch fan-out is one batch pass."""
        from kubernetes_tpu_torch.metrics.registry import BULK_REQUESTS
        BULK_REQUESTS.inc({"endpoint": "leases/-/renew"})
        out: list[Optional[str]] = []
        evs: list[Event] = []
        with self._lock:
            space = self._data.setdefault("Lease", {})
            for name, renew_time in items:
                k = (namespace or "", name)
                cur = space.get(k)
                if cur is None:
                    out.append(f"Lease {namespace}/{name} not found")
                    continue
                rv = self._bump_locked()
                obj = fastcopy(cur)
                obj.setdefault("spec", {})["renewTime"] = float(renew_time)
                obj["metadata"]["resourceVersion"] = str(rv)
                space[k] = obj
                self._journal_locked({"op": "set", "kind": "Lease",
                                      "ns": k[0], "name": name, "rv": rv,
                                      "obj": obj})
                evs.append(Event(MODIFIED, obj, rv))
                out.append(None)
            self._emit_many_locked("Lease", evs)
        return out

    def delete(self, kind: str, namespace: str, name: str) -> dict:
        """Finalizer-aware deletion (apimachinery's graceful-deletion
        contract, ``registry.Store.Delete``): an object carrying
        ``metadata.finalizers`` is not removed — it gets a
        ``deletionTimestamp`` and persists (MODIFIED event) until the last
        finalizer is removed by whoever owns it (an update() dropping the
        final finalizer of a terminating object completes the delete).
        Objects without finalizers are removed immediately, as before."""
        import time as _time
        with self._lock:
            k = (namespace or "", name)
            space = self._data.setdefault(kind, {})
            if k not in space:
                raise NotFound(f"{kind} {namespace}/{name}")
            cur = space[k]
            md = cur.get("metadata") or {}
            if md.get("finalizers"):
                if md.get("deletionTimestamp"):
                    return fastcopy(cur)  # already terminating
                obj = fastcopy(cur)
                rv = self._bump_locked()
                obj["metadata"]["deletionTimestamp"] = _time.time()
                obj["metadata"]["resourceVersion"] = str(rv)
                space[k] = obj
                self._journal_locked({"op": "set", "kind": kind,
                                      "ns": k[0], "name": k[1], "rv": rv,
                                      "obj": obj})
                self._emit_locked(kind, Event(MODIFIED, obj, rv))
                return fastcopy(obj)
            obj = fastcopy(space.pop(k))
            rv = self._bump_locked()
            obj["metadata"]["resourceVersion"] = str(rv)
            self._journal_locked({"op": "del", "kind": kind, "ns": k[0],
                                  "name": k[1], "rv": rv})
            self._emit_locked(kind, Event(DELETED, obj, rv))
            return obj

    # ---- watch -----------------------------------------------------------

    def watch(self, kind: str, since_rv: int = 0) -> Watcher:
        """Watch events with rv > since_rv. Raises TooOld if the replay window
        no longer covers since_rv (caller must relist, Reflector-style) — or
        if the replay backlog alone would overflow the watcher's bounded
        queue (a relist hands the caller the same state cheaper than a
        replay that immediately evicts it)."""
        with self._lock:
            hist = self._history.get(kind, [])
            if since_rv < max(self._floor_rv, self._compacted.get(kind, 0)):
                raise TooOld(f"{kind} rv {since_rv} compacted")
            pending = [ev for ev in hist if ev.resource_version > since_rv]
            if len(pending) >= WATCH_QUEUE_MAX:
                raise TooOld(f"{kind} rv {since_rv}: replay backlog "
                             f"{len(pending)} exceeds watcher queue budget")
            q: queue.Queue = queue.Queue(maxsize=WATCH_QUEUE_MAX)
            for ev in pending:
                q.put_nowait(ev)
            shards = self._shards.setdefault(
                kind, [_WatchShard() for _ in range(WATCH_SHARDS)])
            self._watch_seq += 1
            shards[self._watch_seq % WATCH_SHARDS].add(q)
            self._set_watch_gauge(kind, shards)
            return Watcher(self, kind, q)

    def watch_stats(self) -> dict:
        """Front-door observability: live watcher counts, shard fan-out,
        cumulative slow-consumer drops, and the fan-out span (ns spent
        pushing events into watcher queues + events fanned) — the
        WatchStorm bench gates leader fan-out growth on ns/event."""
        with self._lock:
            shard_map = {k: list(v) for k, v in self._shards.items()}
            fanout_ns, fanout_events = self._fanout_ns, self._fanout_events
        watchers: dict[str, int] = {}
        drops: dict[str, int] = {}
        for kind, shards in shard_map.items():
            n = d = 0
            for s in shards:
                sn, sd = s.stats()
                n, d = n + sn, d + sd
            if n:
                watchers[kind] = n
            if d:
                drops[kind] = d
        return {"watchers": watchers,
                "watchersTotal": sum(watchers.values()),
                "shardsPerKind": WATCH_SHARDS,
                "queueMax": WATCH_QUEUE_MAX,
                "drops": drops, "dropsTotal": sum(drops.values()),
                "fanoutNs": fanout_ns, "fanoutEvents": fanout_events}

    # ---- checkpoint ------------------------------------------------------

    def save(self, path: str):
        with self._lock:
            blob = {kind: list(space.values()) for kind, space in self._data.items()}
            data = {"rv": self._rv, "data": blob}
        with open(path, "w") as f:
            json.dump(data, f)

    def load(self, path: str):
        with open(path) as f:
            data = json.load(f)
        with self._lock:
            self._install_state_locked(
                data["rv"], {kind: {obj_key(o): o for o in objs}
                             for kind, objs in data["data"].items()})

    def _install_state_locked(self, rv: int, data: dict) -> None:
        """Replace the whole store state (checkpoint restore / replication
        snapshot install). No replay history survives: every kind —
        including kinds absent from the blob — is compacted up to the
        installed rv, so stale watchers get TooOld and relist instead of
        silently missing pre-install events. Live watch streams are
        invalidated too (an object absent from the blob never emits
        DELETED; a connected informer would retain it as a phantom
        forever), the ClusterIP allocator re-seeds past installed
        Services, and durable stores fold the new state into the
        snapshot file."""
        self._rv = rv
        self._data = data
        self._history.clear()
        self._compacted = {}
        self._floor_rv = self._rv
        for shards in self._shards.values():
            for shard in shards:
                shard.invalidate(self._rv)
        self._reseed_service_ips_locked()
        if self._wal is not None:
            self._compact_wal_locked()

    def close(self):
        with self._lock:
            self._closed = True  # a deferred restore must not reopen
            if self._wal is not None:
                self._wal.close()
                self._wal = None

    @property
    def resource_version(self) -> int:
        with self._lock:
            return self._rv
