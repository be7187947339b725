"""Kubemark — thousands of hollow kubelets in one process.

Reference: ``pkg/kubemark/hollow_kubelet.go`` + ``cmd/kubemark``: real
kubelet code over a mocked CRI so a handful of machines can drive
thousand-node control-plane tests. The packing trick here is SHARED
PLUMBING: one pod watch stream fans events out to every hollow kubelet by
``spec.nodeName`` (500 per-node watch connections would melt a single-core
box before the control plane breaks a sweat), node registration is chunked
bulk creates, and EVERY per-node control-plane hot path rides a sharded
fleet batcher over a bulk endpoint:

  heartbeats   _HeartbeatBatcher -> POST nodes/-/status
  node leases  _LeaseBatcher     -> POST leases/-/renew
  pod status   _StatusBatcher    -> POST pods/-/status

Each batcher runs K worker shards over N nodes with jittered phase, so a
10k-node fleet's period costs O(K x ceil(N/K/max_batch)) requests instead
of O(N) GET+PUT round trips — the control plane's cost grows with batch
count, not node count. Each node still runs the REAL Kubelet sync
machinery — admission (allocatable/cpu/device/topology), FakeRuntime
sandbox + container lifecycle, status writes — via its own PodWorkers.

Membership is dynamic (the cluster-autoscaler's node groups scale it):
``add_nodes``/``remove_node`` fold nodes into the FIXED batcher shards —
no thread per scale-up batch — and a removed kubelet is marked dead so an
in-flight heartbeat cannot resurrect its just-deleted Node object.
"""

from __future__ import annotations

import threading
import time
import zlib

import random

from kubernetes_tpu_torch.client.informer import SharedInformer
from kubernetes_tpu_torch.kubelet.kubelet import HollowNode
from kubernetes_tpu_torch.metrics.registry import (
    BATCHER_DROPS,
    BATCHER_QUEUE_DEPTH,
    HEARTBEAT_BATCH,
    LEASE_BATCH,
    STATUS_BATCH,
)
from kubernetes_tpu_torch.utils.events import NullRecorder

# nodes per bulk registration POST: spin-up is O(ceil(N / this)) requests
REGISTER_CHUNK = 1024

# sentinel a batcher's _member_payload returns to skip a member this sweep
# (heartbeat thinning: leases carry liveness between status refreshes)
_SKIP = object()

# ``ktpu status`` reads the fleet's shape/rates from this ConfigMap (the
# hollow fleet's analog of the scheduler's status ConfigMap)
FLEET_CONFIGMAP = "kubernetes-tpu-fleet-status"


class _ShardedBatcher:
    """K worker shards over the fleet's members, jittered phase.

    Each shard owns a slice of the membership (name -> Kubelet, assigned
    by stable hash) plus a queue of sink pushes, under its OWN lock — one
    global flush lock would re-serialize 10k nodes' traffic through a
    single critical section. Shard i's sweep fires at phase
    ``(i + phase) / K`` of the period, so the apiserver sees K spread-out
    bulk requests per period instead of one thundering batch.

    Subclasses define ``_items(members, queued)`` (what one sweep sends)
    and ``_flush(chunk) -> bool`` (the bulk transport + heal handling).

    Outage discipline (the apiserver dies and comes back): a shard whose
    flush fails BACKS OFF with full jitter (period doubling per
    consecutive failure, capped) instead of hot-looping refused
    connections through the client's own retry budget; push-mode entries
    (``requeue_failed`` — pod statuses) re-coalesce into the shard queue
    by key, newest payload winning, bounded by ``max_queued`` with drops
    counted; member-driven payloads (heartbeats, leases) are NOT
    requeued — the next sweep regenerates them, so a failed flush can
    neither duplicate members into the next flush nor resurrect a
    member removed mid-outage. The first successful flush after an
    outage fires ``_on_reconnect`` (the heartbeat batcher drops its
    fingerprints there so every member's status re-asserts promptly)."""

    batcher = "?"  # queue-depth gauge label
    requeue_failed = False  # push-mode batchers re-coalesce failed chunks
    max_queued = 4096       # bound on re-coalesced entries per shard
    backoff_cap_s = 10.0    # outage backoff ceiling per shard

    def __init__(self, client, period_s: float, shards: int = 4,
                 max_batch: int = 512, phase: float = 0.0):
        self.client = client
        self.period_s = max(0.05, float(period_s))
        self.n_shards = max(1, int(shards))
        self.max_batch = max(1, int(max_batch))
        self._phase = phase
        self._locks = [threading.Lock() for _ in range(self.n_shards)]
        self._members: list[dict] = [{} for _ in range(self.n_shards)]  # guarded by: self._locks[i]
        self._queued: list[dict] = [{} for _ in range(self.n_shards)]  # guarded by: self._locks[i]
        self._errs = [0] * self.n_shards  # consecutive flush failures; shard-thread-private (each slot touched only by its own shard loop)
        self._stop = threading.Event()
        self._t0 = time.monotonic()
        # counters are shared across the K shard threads (and flush_all
        # callers): '+=' is not atomic in CPython, and an undercounted
        # items total would silently deflate the Fleet rates the bench
        # JSON records — so updates go through _count()
        self._stats_lock = threading.Lock()
        self.flushes = 0    # guarded by: self._stats_lock
        self.items = 0      # guarded by: self._stats_lock
        self.last_batch = 0  # guarded by: self._stats_lock
        self.errors = 0     # guarded by: self._stats_lock
        self.drops = 0      # guarded by: self._stats_lock
        self.requeued = 0   # guarded by: self._stats_lock
        self.reconnects = 0  # guarded by: self._stats_lock
        self._threads = [
            threading.Thread(target=self._shard_loop, args=(i,), daemon=True)
            for i in range(self.n_shards)]
        for t in self._threads:
            t.start()

    # ---- membership / sink -----------------------------------------------

    def _shard_of(self, name: str) -> int:
        # stable across processes (hash() is salted): membership placement
        # must not reshuffle between an operator's runs of the same fleet
        return zlib.crc32(name.encode()) % self.n_shards

    def add(self, kubelet) -> None:
        i = self._shard_of(kubelet.node_name)
        with self._locks[i]:
            self._members[i][kubelet.node_name] = kubelet

    def remove(self, name: str) -> None:
        i = self._shard_of(name)
        with self._locks[i]:
            self._members[i].pop(name, None)
            self._queued[i].pop(name, None)

    def push(self, name: str, payload=None) -> None:
        """Sink interface for kubelets driving their own loops: enqueue one
        entry; the owning shard folds it into its next bulk flush (newest
        payload wins, the status-manager dedup semantics)."""
        i = self._shard_of(name)
        with self._locks[i]:
            self._queued[i][name] = payload

    def member(self, name: str):
        with self._locks[self._shard_of(name)]:
            return self._members[self._shard_of(name)].get(name)

    def _alive(self, name: str) -> bool:
        k = self.member(name)
        return k is not None and not getattr(k, "dead", False)

    # ---- sweep machinery -------------------------------------------------

    def _phase_delay(self, i: int) -> float:
        """Initial wait for shard ``i``: spread the K shards (and sibling
        batchers, via ``phase``) across the period so renewals trickle
        instead of thundering every period boundary."""
        return (self.period_s * ((i + self._phase) % self.n_shards)
                / self.n_shards)

    def _shard_loop(self, i: int) -> None:
        self._stop.wait(self._phase_delay(i))
        while not self._stop.wait(self._next_wait(i)):
            self._sweep(i)

    def _next_wait(self, i: int) -> float:
        """Healthy shards sweep on the period; a shard mid-outage doubles
        its wait per consecutive failure (capped) with half-range jitter,
        so a restarted apiserver sees a spread reconnect trickle instead
        of K shards x N batchers thundering the first second it binds."""
        errs = self._errs[i]
        if not errs:
            return self.period_s
        backoff = min(self.backoff_cap_s,
                      self.period_s * (2 ** min(errs, 8)))
        return backoff * (0.5 + random.random() * 0.5)

    def _sweep(self, i: int) -> None:
        # entry building stays under the shard lock: _member_payload
        # mutates per-member state (heartbeat beats/fingerprints), and
        # flush_all() sweeps from a foreign thread while the shard thread
        # is live — the network flush below runs unlocked
        with self._locks[i]:
            members = list(self._members[i].values())
            queued = self._queued[i]
            self._queued[i] = {}
            entries: dict = dict(queued)
            for k in members:
                if not getattr(k, "dead", False):
                    p = self._member_payload(k)
                    if p is not _SKIP:
                        entries[k.node_name] = p
        # per-shard series: one unlabeled gauge would hold only the
        # last-swept shard's slice of the fleet
        BATCHER_QUEUE_DEPTH.set(len(entries), {"batcher": self.batcher,
                                               "shard": str(i)})
        batch = list(entries.items())
        ok_all = True
        for j in range(0, len(batch), self.max_batch):
            chunk = batch[j:j + self.max_batch]
            if not self._flush(chunk):
                ok_all = False
                self._requeue(i, chunk)
        if not batch:
            return
        if ok_all:
            if self._errs[i]:
                self._errs[i] = 0
                with self._stats_lock:
                    self.reconnects += 1
                self._on_reconnect(i)
        else:
            self._errs[i] += 1

    def _requeue(self, i: int, chunk: list) -> None:
        """Re-coalesce a failed chunk for the next sweep (push-mode
        batchers only). Newest-wins: an entry whose key gained a fresher
        queued payload during the flush keeps the fresh one; members are
        never requeued (the sweep regenerates their payloads — requeueing
        would duplicate them, and a member removed mid-outage would
        resurrect); the queue is bounded, drops counted."""
        if not self.requeue_failed:
            return
        dropped = requeued = 0
        with self._locks[i]:
            q = self._queued[i]
            for name, payload in chunk:
                if name in q or name in self._members[i]:
                    continue
                if len(q) >= self.max_queued:
                    dropped += 1
                    continue
                q[name] = payload
                requeued += 1
        if dropped:
            BATCHER_DROPS.inc({"batcher": self.batcher}, by=dropped)
        if dropped or requeued:
            with self._stats_lock:
                self.drops += dropped
                self.requeued += requeued

    def _on_reconnect(self, i: int) -> None:
        """First successful flush after >= 1 failed sweep on shard ``i``."""

    def flush_all(self) -> None:
        """Synchronous sweep of every shard (shutdown + tests)."""
        for i in range(self.n_shards):
            self._sweep(i)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)

    def stats(self) -> dict:
        elapsed = max(time.monotonic() - self._t0, 1e-9)
        with self._stats_lock:  # consistent snapshot vs in-flight _count()
            return {"shards": self.n_shards, "flushes": self.flushes,
                    "items": self.items, "lastBatch": self.last_batch,
                    "errors": self.errors, "drops": self.drops,
                    "requeued": self.requeued,
                    "reconnects": self.reconnects,
                    "backingOff": sum(1 for e in self._errs if e),
                    "itemsPerS": round(self.items / elapsed, 2)}

    def _count(self, n_items: int) -> None:
        with self._stats_lock:
            self.flushes += 1
            self.items += n_items
            self.last_batch = n_items

    def _count_error(self) -> None:
        with self._stats_lock:
            self.errors += 1

    # ---- subclass hooks --------------------------------------------------

    def _member_payload(self, kubelet):
        return None

    def _flush(self, chunk: list) -> bool:
        """Send one chunk; -> False on a transport-level failure (the
        shard backs off and, for push-mode batchers, requeues)."""
        raise NotImplementedError


class _HeartbeatBatcher(_ShardedBatcher):
    """Fleet heartbeat fan-in: ``nodes/-/status`` POSTs refresh members'
    Ready conditions + kubelet endpoints. Per-item 404s (Node deleted out
    from under the fleet) heal by bulk re-registration — the singleton
    heartbeat's 404 path, batched.

    THINNED, the way upstream scale clusters thin node status: the LEASE
    is the per-period liveness signal (upstream kubelets renew every 10s
    but report unchanged status only 5-minutely —
    ``nodeStatusReportFrequency``). A member's condition refresh is sent
    when its payload CHANGES (Ready flip, endpoint re-bind — detected by
    timestamp-free fingerprint) or on its every-``refresh_every``-th
    sweep backstop (default 30: upstream's 10s-lease-to-5min-status
    ratio), staggered by name hash so 1/refresh_every of the fleet
    refreshes each period. Status traffic per period is O(N /
    refresh_every); the watch fan-out and every informer's decode load
    thin by the same factor."""

    batcher = "heartbeat"
    # liveness signals must re-assert FAST after an outage: nodelifecycle
    # measures staleness against its grace period, so the reconnect
    # backoff ceiling has to sit well under any sane grace
    backoff_cap_s = 5.0

    def __init__(self, client, period_s: float, shards: int = 4,
                 max_batch: int = 512, phase: float = 0.0,
                 refresh_every: int = 30):
        self.refresh_every = max(1, int(refresh_every))
        self._beats: dict[str, int] = {}  # guarded by: self._locks[i]
        self._fps: dict[str, tuple] = {}  # guarded by: self._locks[i]
        super().__init__(client, period_s, shards, max_batch, phase)

    @staticmethod
    def _fingerprint(payload: dict) -> tuple:
        """Timestamp-free view of a heartbeat payload: what must force an
        immediate send when it changes."""
        return (
            tuple(sorted((c.get("type"), c.get("status"), c.get("reason"))
                         for c in payload.get("conditions") or [])),
            tuple(sorted((a.get("type"), a.get("address"))
                         for a in payload.get("addresses") or [])),
            str(payload.get("daemonEndpoints")),
        )

    def _member_payload(self, kubelet):
        name = kubelet.node_name
        payload = kubelet.heartbeat_payload()
        fp = self._fingerprint(payload)
        # runs under the owning shard's lock (_sweep holds it while
        # building entries), so _beats/_fps updates never race flush_all;
        # _flush's fp invalidations happen outside the lock but are
        # GIL-atomic dict pops — worst case one redundant refresh
        beat = self._beats.get(name, 0)  # ktpu-lint: disable=KTL001 -- _sweep holds the owning shard's lock around every _member_payload call
        self._beats[name] = beat + 1  # ktpu-lint: disable=KTL001 -- _sweep holds the owning shard's lock around every _member_payload call
        due = ((beat + zlib.crc32(name.encode()) // self.n_shards)
               % self.refresh_every == 0)
        if not due and self._fps.get(name) == fp:  # ktpu-lint: disable=KTL001 -- _sweep holds the owning shard's lock around every _member_payload call
            return _SKIP
        self._fps[name] = fp  # ktpu-lint: disable=KTL001 -- _sweep holds the owning shard's lock around every _member_payload call
        return payload

    def remove(self, name: str) -> None:
        super().remove(name)
        self._beats.pop(name, None)  # ktpu-lint: disable=KTL001 -- GIL-atomic pop after membership removal; a racing sweep re-inserts at most one stale beat for a dead member
        self._fps.pop(name, None)  # ktpu-lint: disable=KTL001 -- GIL-atomic pop after membership removal; a racing sweep re-inserts at most one stale fp for a dead member

    def _on_reconnect(self, i: int) -> None:
        # outage heal: drop shard i's members' fingerprints so every
        # member's full status re-asserts over the next sweeps — an
        # apiserver restored from its WAL holds pre-outage conditions, and
        # a changed-but-fp-suppressed payload would otherwise wait out the
        # 30-sweep refresh backstop (pops are GIL-atomic, like _flush's)
        with self._locks[i]:
            names = list(self._members[i])
        for name in names:
            self._fps.pop(name, None)  # ktpu-lint: disable=KTL001 -- GIL-atomic pop outside the shard lock (documented above): worst case one redundant refresh, never a lost one

    def _flush(self, chunk: list) -> bool:
        from kubernetes_tpu_torch.utils.tracing import TRACER
        try:
            with TRACER.span("kubelet/heartbeat", nodes=len(chunk)):
                errs = self.client.nodes().heartbeat_many(chunk)
        except Exception:
            # best-effort transport — but the fingerprints recorded when
            # these payloads were BUILT must not survive the lost send: a
            # changed condition/endpoint suppressed by its own fp would
            # otherwise wait out the full refresh backstop before being
            # re-asserted
            for name, _ in chunk:
                self._fps.pop(name, None)  # ktpu-lint: disable=KTL001 -- GIL-atomic pop outside the shard lock (see _member_payload's contract): worst case one redundant refresh
            self._count_error()
            return False
        HEARTBEAT_BATCH.observe(len(chunk))
        self._count(len(chunk))
        missing = [name for (name, _), e in zip(chunk, errs)
                   if e and "not found" in e]
        if missing:
            # a 404'd member's fp must not suppress its next heartbeat: if
            # the re-register below fails transiently, the per-period
            # heartbeat (and its 404) is what retries the heal — without
            # this the node would stay missing until the refresh backstop
            for name in missing:
                self._fps.pop(name, None)  # ktpu-lint: disable=KTL001 -- GIL-atomic pop outside the shard lock (see _member_payload's contract): worst case one redundant refresh
            self._reregister(missing)
        return True

    def _reregister(self, names: list[str]) -> None:
        # only LIVE members re-register: a scale-down's delete racing an
        # in-flight flush must not resurrect the node as a Ready zombie
        objs = []
        for name in names:
            k = self.member(name)
            if k is not None and not getattr(k, "dead", False):
                objs.append(k._node_object())
        if not objs:
            return
        try:
            self.client.nodes().create_many(objs)
        except Exception:  # ktpu-lint: disable=KTL002 -- 409 = adopted/raced; transport errors retry via next period's heartbeat 404 path
            pass


class _LeaseBatcher(_ShardedBatcher):
    """Fleet lease fan-in: one ``leases/-/renew`` POST per shard per period
    bumps every member's kube-node-lease renewTime (the kubelet's cheap
    liveness signal — node-lifecycle treats a fresh renewTime as alive
    even when status heartbeats lag). Missing leases (first renewal, or a
    GC'd lease) are created in bulk and renew next period."""

    batcher = "lease"
    # THE liveness signal: reconnect backoff capped low (see heartbeat)
    backoff_cap_s = 5.0

    def _member_payload(self, kubelet):
        return time.time()

    def _flush(self, chunk: list) -> bool:
        from kubernetes_tpu_torch.utils.tracing import TRACER
        now = time.time()
        items = [(name, rt if rt is not None else now) for name, rt in chunk]
        leases = self.client.leases("kube-node-lease")
        try:
            with TRACER.span("kubelet/lease_renew", leases=len(items)):
                errs = leases.renew_many(items)
        except Exception:
            self._count_error()
            return False
        LEASE_BATCH.observe(len(items))
        self._count(len(items))
        # only LIVE members get their missing lease created: a scale-down
        # racing an in-flight flush must not resurrect a removed node's
        # lease (a one-shot zombie renewTime would keep node-lifecycle
        # treating the deleted node as alive for a whole grace period)
        missing = [(name, rt) for (name, rt), e in zip(items, errs)
                   if e and "not found" in e and self._alive(name)]
        if missing:
            try:
                leases.create_many([
                    {"kind": "Lease",
                     "metadata": {"name": name,
                                  "namespace": "kube-node-lease"},
                     "spec": {"holderIdentity": name,
                              "leaseDurationSeconds": 40,
                              "renewTime": rt}}
                    for name, rt in missing])
            except Exception:  # ktpu-lint: disable=KTL002 -- AlreadyExists raced another creator; the next period's renew wins either way
                pass
        return True


class _StatusBatcher(_ShardedBatcher):
    """Coalesce the fleet's pod status writes into bulk POSTs, sharded.

    Every hollow kubelet's Pending->Running transition used to be its own
    status PUT — at 1,000 pods over 500 nodes that is thousands of
    request/response cycles fighting the scheduler for the apiserver and
    the GIL (kubemark's 15.9s mystery). Kubelets push ``(ns, name,
    status)`` here (kubelet.status_sink); the shard flushers send
    everything accumulated as ``pods/-/status`` POSTs per interval,
    newest status per pod winning (the status manager's dedup semantics).
    Pure push-mode use of the sharded base (no members): one global flush
    lock used to convoy 10k nodes' sync threads through a single critical
    section before the apiserver broke a sweat."""

    batcher = "status"
    # a status is pushed ONCE per transition: a flush lost to an apiserver
    # outage must re-coalesce (newest-wins per pod, bounded, drops
    # counted) or Running pods would stay Pending until the kubelet's
    # next full sync long after the server came back
    requeue_failed = True

    def __init__(self, client, flush_s: float = 0.05, max_batch: int = 512,
                 shards: int = 4):
        super().__init__(client, flush_s, shards, max_batch)

    def push(self, ns: str, name: str, status: dict) -> None:
        # "/" is illegal in both namespace and pod names, so the joined
        # key round-trips losslessly through the base's name-keyed queue
        super().push(f"{ns}/{name}", status)

    def flush(self) -> None:
        self.flush_all()

    def _flush(self, chunk: list) -> bool:
        from kubernetes_tpu_torch.utils.tracing import TRACER
        items = [(key.split("/", 1)[0], key.split("/", 1)[1], st)
                 for key, st in chunk]
        try:
            with TRACER.span("kubemark/status_flush", pods=len(items)):
                self.client.pods("default").update_status_many(items)
        except Exception:
            self._count_error()
            return False
        STATUS_BATCH.observe(len(items))
        self._count(len(items))
        return True


class HollowCluster:
    def __init__(self, client, n: int, prefix: str = "hollow",
                 heartbeat_period: float = 10.0, drivers: int = 4,
                 allocatable: dict | None = None,
                 exit_after: float | None = None,
                 publish_status: bool = True):
        self.client = client
        if hasattr(client, "default_user_agent"):
            client.default_user_agent("kubelet/hollow")
        self.heartbeat_period = heartbeat_period
        # ``drivers`` now sizes the batcher shard pools (it used to size a
        # per-node-sweep thread pool; same knob, same meaning: how many
        # workers carry the fleet's liveness traffic)
        self.drivers = max(1, drivers)
        self._publish = publish_status
        self.nodes: list[HollowNode] = []
        for i in range(n):
            hn = HollowNode(client, f"{prefix}-{i}", exit_after=exit_after,
                            allocatable=dict(allocatable or {
                                "cpu": "8", "memory": "16Gi",
                                "pods": "110"}),
                            heartbeat_period=heartbeat_period,
                            register_node=False)
            # at fleet scale the per-pod event POSTs are pure hot-path load
            # on the apiserver; kubemark silences them the same way
            hn.kubelet.recorder = NullRecorder()
            self.nodes.append(hn)
        self._by_name = {hn.kubelet.node_name: hn.kubelet
                         for hn in self.nodes}
        self._informer: SharedInformer | None = None
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        # batchers armed by start()
        self._status: _StatusBatcher | None = None
        self._heartbeats: _HeartbeatBatcher | None = None
        self._leases: _LeaseBatcher | None = None

    # ---- lifecycle -------------------------------------------------------

    def start(self, wait_sync: float = 30.0) -> "HollowCluster":
        # fleet-shared batchers: bulk pod status, bulk heartbeats, bulk
        # lease renewals — every per-node hot path becomes a batched one
        self._status = _StatusBatcher(self.client, shards=self.drivers)
        self._heartbeats = _HeartbeatBatcher(
            self.client, self.heartbeat_period, shards=self.drivers)
        # leases renew on upstream's fixed ~10s cadence, decoupled from
        # the (thinned) status heartbeat period — they are the per-period
        # liveness signal, and their per-item cost is the one O(N) term
        # that cannot be deduped away, so its period must not shrink just
        # because an operator tightened heartbeat_period for test speed
        self._leases = _LeaseBatcher(
            self.client, min(10.0, self.heartbeat_period * 5),
            shards=self.drivers,
            phase=0.5)  # interleave with the heartbeat shards
        for hn in self.nodes:
            self._wire(hn)
        # chunked bulk registration (adopting nodes that already exist)
        self._register_fleet(self.nodes)
        # one shared watch stream; dispatch by spec.nodeName
        self._informer = SharedInformer(self.client.resource("pods", None))
        self._informer.add_event_handler(self._on_pod_event)
        self._informer.start()
        self._informer.wait_for_cache_sync(wait_sync)
        for hn in self.nodes:
            self._join_batchers(hn)
        if self._publish:
            t = threading.Thread(target=self._publish_loop, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def _wire(self, hn: HollowNode) -> None:
        hn.kubelet.status_sink = self._status.push
        hn.kubelet.heartbeat_sink = self._heartbeats.push
        hn.kubelet.lease_sink = self._leases.push

    def _join_batchers(self, hn: HollowNode) -> None:
        self._heartbeats.add(hn.kubelet)
        self._leases.add(hn.kubelet)

    def _register_fleet(self, hollow_nodes: list[HollowNode]) -> None:
        """Bulk node create/adopt in REGISTER_CHUNK batches: spin-up is
        O(batches), not O(nodes). A chunk whose members already exist
        (409) is ADOPTED — siblings committed server-side, and the first
        heartbeat flush refreshes every adopted node's condition — the
        singleton register path's exists-is-fine semantics."""
        from kubernetes_tpu_torch.client.clientset import ApiError
        from kubernetes_tpu_torch.utils.tracing import TRACER
        for i in range(0, len(hollow_nodes), REGISTER_CHUNK):
            chunk = hollow_nodes[i:i + REGISTER_CHUNK]
            with TRACER.span("kubemark/register", nodes=len(chunk)):
                try:
                    self.client.nodes().create_many(
                        [hn.kubelet._node_object() for hn in chunk])
                except ApiError as e:
                    if e.code != 409:
                        raise

    # ---- dynamic membership (cluster-autoscaler node groups) -------------

    def add_nodes(self, names: list[str], allocatable: dict | None = None,
                  labels: dict | None = None,
                  taints: list | None = None) -> list[HollowNode]:
        """Provision hollow kubelets mid-flight (the autoscaler's scale-up
        path): bulk-register the node objects, join the shared pod watch
        by name, and fold the batch into the existing batcher shards. Each
        node gets a ``kubernetes.io/hostname`` label on top of ``labels``;
        ``taints`` register with the node (template fidelity)."""
        added = []
        for name in names:
            hn = HollowNode(self.client, name,
                            allocatable=dict(allocatable or {
                                "cpu": "8", "memory": "16Gi", "pods": "110"}),
                            labels={**(labels or {}),
                                    "kubernetes.io/hostname": name},
                            taints=list(taints or []),
                            heartbeat_period=self.heartbeat_period,
                            register_node=False)
            hn.kubelet.recorder = NullRecorder()
            if self._status is not None:
                self._wire(hn)
            added.append(hn)
        # join the watch fan-out BEFORE the nodes become visible: a pod
        # bound in the gap between create and fan-out registration would
        # have its event dropped with no relist to heal it
        self.nodes.extend(added)
        for hn in added:
            self._by_name[hn.kubelet.node_name] = hn.kubelet
        try:
            self._register_fleet(added)
        except Exception:
            for hn in added:
                self._by_name.pop(hn.kubelet.node_name, None)
            self.nodes = [hn for hn in self.nodes if hn not in added]
            raise
        if self._heartbeats is not None:
            for hn in added:
                self._join_batchers(hn)
        return added

    def remove_node(self, name: str):
        """Deprovision one hollow kubelet (scale-down): mark it dead (so an
        in-flight heartbeat cannot re-register the Node it is about to
        lose), stop its sync machinery, drop it from the watch fan-out and
        its batcher shards, delete the node object."""
        kubelet = self._by_name.pop(name, None)
        if kubelet is None:
            return
        kubelet.dead = True
        self.nodes = [hn for hn in self.nodes
                      if hn.kubelet.node_name != name]
        if self._heartbeats is not None:
            self._heartbeats.remove(name)
        if self._leases is not None:
            self._leases.remove(name)
        kubelet.workers.stop()
        try:
            self.client.nodes().delete(name)
        except Exception:  # ktpu-lint: disable=KTL002 -- already gone (raced with another deleter); the kubelet is marked dead either way
            pass

    def stop(self):
        self._stop.set()
        if self._informer is not None:
            self._informer.stop()
        for hn in self.nodes:
            hn.kubelet.workers.stop()
        for b in (self._heartbeats, self._leases, self._status):
            if b is not None:
                b.stop()
        if self._status is not None:
            self._status.flush()  # final drain so shutdown loses nothing
        for t in self._threads:
            t.join(timeout=5.0)

    # ---- shared event fan-out -------------------------------------------

    def _on_pod_event(self, type_, obj, old):
        node = (obj.get("spec") or {}).get("nodeName", "")
        kubelet = self._by_name.get(node)
        if kubelet is not None:
            kubelet._on_pod_event(type_, obj, old)
        elif old is not None:
            # MODIFIED that moved the pod off one of our nodes
            prev = self._by_name.get((old.get("spec") or {})
                                     .get("nodeName", ""))
            if prev is not None:
                prev._on_pod_event("DELETED", old, None)

    # ---- observability ---------------------------------------------------

    def fleet_stats(self) -> dict:
        """Live fleet shape + batcher rates (the Fleet block of
        ``ktpu status``; also recorded per leg by the ScaleFleet bench)."""
        return {
            "nodes": len(self.nodes),
            "shards": self.drivers,
            "heartbeatPeriodSeconds": self.heartbeat_period,
            "heartbeat": (self._heartbeats.stats()
                          if self._heartbeats is not None else None),
            "lease": (self._leases.stats()
                      if self._leases is not None else None),
            "status": (self._status.stats()
                       if self._status is not None else None),
        }

    def publish_fleet_status(self) -> None:
        """Best-effort: write the fleet stats ConfigMap ``ktpu status``
        reads. Publishing must never take the fleet down."""
        import json

        from kubernetes_tpu_torch.utils.configmap import upsert_configmap
        upsert_configmap(self.client, "default", FLEET_CONFIGMAP,
                         {"fleet": json.dumps(self.fleet_stats())},
                         site="fleet_publish")

    def _publish_loop(self) -> None:
        while not self._stop.wait(5.0):
            self.publish_fleet_status()

    def running_pods(self) -> int:
        return sum(len(hn.kubelet.runtime.list_sandboxes())
                   for hn in self.nodes)
