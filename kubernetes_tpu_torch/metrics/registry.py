"""Metrics registry — Prometheus-style counters/gauges/histograms.

Reference: ``staging/src/k8s.io/component-base/metrics/`` (registry with
stability classes) and ``pkg/scheduler/metrics/metrics.go`` (the scheduler
SLIs). Text exposition follows the Prometheus format so existing dashboards
scrape unchanged.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_right
from typing import Optional

DEFAULT_BUCKETS = (0.001, 0.002, 0.005, 0.01, 0.02, 0.05, 0.1, 0.15, 0.2,
                   0.25, 0.3, 0.4, 0.5, 0.6, 0.7, 0.75, 0.8, 0.85, 0.9,
                   0.95, 1.0, 1.25, 1.5, 2.0, 3.0, 5.0, 7.5, 10.0, 15.0,
                   20.0, 30.0, 45.0, 60.0, 120.0)


def _label_key(labels: Optional[dict]) -> tuple:
    return tuple(sorted((labels or {}).items()))


def _fmt_labels(key: tuple) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class _Metric:
    def __init__(self, name: str, help_: str):
        self.name = name
        self.help = help_
        self._lock = threading.Lock()


class Counter(_Metric):
    def __init__(self, name, help_=""):
        super().__init__(name, help_)
        self._values: dict[tuple, float] = {}

    def inc(self, labels: Optional[dict] = None, by: float = 1.0):
        k = _label_key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + by

    def get(self, labels: Optional[dict] = None) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def items(self) -> dict:
        """Label-key tuple -> value snapshot (benchmarks diff two of these
        to attribute counts to one measured window of a shared process)."""
        with self._lock:
            return dict(self._values)

    def expose(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:
            for k, v in sorted(self._values.items()):
                out.append(f"{self.name}{_fmt_labels(k)} {v}")
        return out


class Gauge(_Metric):
    def __init__(self, name, help_=""):
        super().__init__(name, help_)
        self._values: dict[tuple, float] = {}

    def set(self, value: float, labels: Optional[dict] = None):
        with self._lock:
            self._values[_label_key(labels)] = value

    def get(self, labels: Optional[dict] = None) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def expose(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        with self._lock:
            for k, v in sorted(self._values.items()):
                out.append(f"{self.name}{_fmt_labels(k)} {v}")
        return out


class Histogram(_Metric):
    def __init__(self, name, help_="", buckets=DEFAULT_BUCKETS):
        super().__init__(name, help_)
        self.buckets = tuple(buckets)
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}
        self._totals: dict[tuple, int] = {}

    def observe(self, value: float, labels: Optional[dict] = None, n: int = 1):
        """Record ``value`` ``n`` times (n>1: one batched lock acquisition —
        the scheduler observes one identical attempt duration per pod in a
        gang batch)."""
        k = _label_key(labels)
        with self._lock:
            counts = self._counts.setdefault(k, [0] * len(self.buckets))
            i = bisect_right(self.buckets, value)
            for j in range(i, len(self.buckets)):
                counts[j] += n
            self._sums[k] = self._sums.get(k, 0.0) + value * n
            self._totals[k] = self._totals.get(k, 0) + n

    def time(self, labels: Optional[dict] = None):
        return _Timer(self, labels)

    def percentile(self, q: float, labels: Optional[dict] = None) -> float:
        """Approximate quantile from bucket boundaries (upper bound). A
        quantile landing in the +Inf bucket clamps to the largest finite
        boundary (Prometheus histogram_quantile does the same) — inf is
        not valid JSON and tells a reader nothing a max bucket doesn't."""
        k = _label_key(labels)
        with self._lock:
            total = self._totals.get(k, 0)
            if not total:
                return 0.0
            target = q * total
            for b, c in zip(self.buckets, self._counts.get(k, [])):
                if c >= target:
                    return b
            return self.buckets[-1] if self.buckets else 0.0

    def count(self, labels: Optional[dict] = None) -> int:
        """Total observations for one label set (the _count series)."""
        with self._lock:
            return self._totals.get(_label_key(labels), 0)

    def bucket_counts(self, labels: Optional[dict] = None):
        """[(upper_bound, cumulative_count)] snapshot for diagnostics."""
        k = _label_key(labels)
        with self._lock:
            return list(zip(self.buckets, self._counts.get(k, [])))

    def reset(self, labels: Optional[dict] = None) -> None:
        """Drop observations (all label sets when ``labels`` is None) — a
        benchmark measuring a fresh window must not inherit a previous
        phase's tail (the registry is process-global)."""
        with self._lock:
            if labels is None:
                self._counts.clear()
                self._totals.clear()
                self._sums.clear()
                return
            k = _label_key(labels)
            self._counts.pop(k, None)
            self._totals.pop(k, None)
            self._sums.pop(k, None)

    def expose(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        with self._lock:
            for k in sorted(self._totals):
                for b, c in zip(self.buckets, self._counts[k]):
                    lk = k + (("le", str(b)),)
                    out.append(f"{self.name}_bucket{_fmt_labels(lk)} {c}")
                lk = k + (("le", "+Inf"),)
                out.append(f"{self.name}_bucket{_fmt_labels(lk)} {self._totals[k]}")
                out.append(f"{self.name}_sum{_fmt_labels(k)} {self._sums[k]}")
                out.append(f"{self.name}_count{_fmt_labels(k)} {self._totals[k]}")
        return out


class _Timer:
    def __init__(self, hist: Histogram, labels):
        self.hist, self.labels = hist, labels

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.hist.observe(time.time() - self.t0, self.labels)


class Registry:
    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _register(self, m):
        with self._lock:
            if m.name in self._metrics:
                return self._metrics[m.name]
            self._metrics[m.name] = m
            return m

    def counter(self, name, help_="") -> Counter:
        return self._register(Counter(name, help_))

    def gauge(self, name, help_="") -> Gauge:
        return self._register(Gauge(name, help_))

    def histogram(self, name, help_="", buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram(name, help_, buckets))

    def expose_text(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        lines = []
        for m in metrics:
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"


REGISTRY = Registry()

# Scheduler SLIs (pkg/scheduler/metrics/metrics.go analogs).
SCHEDULE_ATTEMPTS = REGISTRY.counter(
    "scheduler_schedule_attempts_total",
    "Scheduling attempts by result (scheduled|unschedulable|error)")
ATTEMPT_DURATION = REGISTRY.histogram(
    "scheduler_scheduling_attempt_duration_seconds",
    "End-to-end scheduling attempt latency by result")
BATCH_DURATION = REGISTRY.histogram(
    "scheduler_gang_batch_duration_seconds",
    "Device-side gang batch latency")
E2E_DURATION = REGISTRY.histogram(
    "scheduler_pod_scheduling_sli_duration_seconds",
    "Pod queue-add to bound latency")
# Derived by the flight recorder (utils/tracing.py) at bind time: first
# recorded lifecycle stage (informer event) to binding success — the
# whole-pipeline figure an operator's "where did this pod's 10s go"
# question is about, where the attempt histogram covers one cycle only.
E2E_SCHEDULING = REGISTRY.histogram(
    "scheduler_e2e_scheduling_duration_seconds",
    "Pod end-to-end scheduling latency (informer event to bound), from "
    "the per-pod flight recorder")
# Decision provenance (sched/explainer.py): per-filter verdicts recovered
# off the hot path for unschedulable pods. Labeled by the filter that
# rejected the MOST nodes for that pod (its dominant reason).
UNSCHEDULABLE_REASONS = REGISTRY.counter(
    "scheduler_unschedulable_reasons_total",
    "Unschedulable-pod explanations by dominant rejecting filter "
    "(the filter that rejected the most nodes for that pod)")
EXPLAIN_SAMPLES = REGISTRY.counter(
    "scheduler_explainer_pods_total",
    "Pods explained by the decision-provenance explainer, by mode "
    "(tensor = batched per-filter-output program, oracle = numpy fallback)")
QUEUE_DEPTH = REGISTRY.gauge(
    "scheduler_pending_pods", "Pending pods by queue (active|backoff|unschedulable)")
BIND_RESULTS = REGISTRY.counter(
    "scheduler_bind_failures_total",
    "Bind RPC failures by class (conflict|error|connection)")
GANG_ROUNDS = REGISTRY.histogram(
    "scheduler_gang_rounds", "Conflict-resolution rounds per gang batch",
    buckets=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64))

# Connected-path dispatch pipeline (scheduler.py multi-deep drain queue):
# depth/occupancy make the overlap attributable — a healthy run shows
# inflight hovering at the configured depth while resolve_wait shrinks.
PIPELINE_INFLIGHT = REGISTRY.gauge(
    "scheduler_pipeline_inflight_drains",
    "Dispatched drains awaiting device resolution (pipeline occupancy)")
PIPELINE_DEPTH = REGISTRY.histogram(
    "scheduler_pipeline_depth",
    "In-flight drains observed at each dispatch (including the new one)",
    buckets=(0, 1, 2, 3, 4, 6, 8, 12, 16))

# Incremental pod encoding (encode/snapshot.py precompile cache): hits mean
# the drain hot path paid array-fill cost only, not selector compilation.
ENCODE_POD_CACHE_HITS = REGISTRY.gauge(
    "scheduler_encode_pod_cache_hits",
    "Pod rows served from the informer-event-time compile cache")
ENCODE_POD_CACHE_MISSES = REGISTRY.gauge(
    "scheduler_encode_pod_cache_misses",
    "Pod rows compiled on the batch-encode hot path")
# Row-pack vectorized batch assembly (encode/snapshot.py encode_pods):
# stacked rows arrived prebuilt (informer-time) and were bulk np.stack'ed;
# filled rows paid the per-pod Python array-fill loop on the hot path. A
# healthy connected run shows stacked >> filled (fill-only cycles do no
# per-pod fill work at all).
ENCODE_POD_ROWS_STACKED = REGISTRY.gauge(
    "scheduler_encode_pod_rows_stacked",
    "Pod rows bulk-assembled from prebuilt row packs (no per-pod fill)")
ENCODE_POD_ROWS_FILLED = REGISTRY.gauge(
    "scheduler_encode_pod_rows_filled",
    "Pod rows built by the per-pod array-fill loop on the encode hot path")

# Multi-chip scheduling (parallel/mesh.py wired into the live drain path).
MESH_DEVICES = REGISTRY.gauge(
    "scheduler_mesh_devices",
    "Devices in the active scheduling mesh (1 = single-device, mesh off)")
DRAIN_SHARD_MS = REGISTRY.gauge(
    "scheduler_drain_shard_ms",
    "Wall ms of the last resolved drain across the mesh (every shard's "
    "thread runs it lock-step, meeting at the collectives, so one number "
    "covers all shards; a straggler's wait is included in it)")
RESOLVE_BYTES = REGISTRY.gauge(
    "scheduler_resolve_bytes",
    "Bytes device_get moved host-side for the last drain's compact "
    "winners view (assignments + rounds; O(P), never sharded intermediates)")

# Zero-copy steady state (sched/staging.py): the batch staging arena
# uploads pod stacks pre-sharded on a background thread; dispatch redeems
# a buffer swap. Bytes count the h2d traffic the swap path moved off the
# dispatch span; reuse counts swaps served from pre-staged buffers (a
# healthy steady state shows reuse tracking dispatches 1:1, fallbacks ~0).
STAGE_BYTES = REGISTRY.counter(
    "scheduler_stage_bytes_total",
    "Host-to-device bytes uploaded by the pre-sharded batch staging "
    "arena (off the dispatch path; inline fallback uploads count too, "
    "labeled path=inline)")
STAGE_BUFFER_REUSE = REGISTRY.gauge(
    "scheduler_stage_buffer_reuse_total",
    "Dispatches whose batch stack was served by an arena buffer swap "
    "(pre-staged on the background thread) instead of an inline "
    "device_put")

# Resilience / self-healing (the chaos harness asserts against these).
# LOOP_ERRORS replaces the old bare `except: pass` swallows: every control
# -loop failure is logged AND counted by site, so a chaos run can assert
# "no silent swallow" by diffing this counter against its fault log.
LOOP_ERRORS = REGISTRY.counter(
    "scheduler_loop_errors_total",
    "Control-loop failures absorbed (not swallowed) by site — e.g. "
    "pod_decode, informer_handler, run_once, device_gang, device_drain, "
    "device_preempt, resolver, resolver_wait, drain_resolve, "
    "bind_worker, publish_status, leader_elector (open set: grep "
    "LOOP_ERRORS.inc for the current sites)")
WATCH_RELISTS = REGISTRY.counter(
    "watch_relists_total",
    "Reflector relist-and-resync passes after a watch gap (dropped or "
    "truncated stream, resourceVersion too old) by resource")
DEGRADED_MODE = REGISTRY.gauge(
    "scheduler_degraded_mode",
    "Device circuit-breaker degradation level: 0 = healthy (full tensor "
    "path, mesh if configured), each +1 = one degrade step toward the "
    "pure-numpy oracle")
BREAKER_TRIPS = REGISTRY.counter(
    "scheduler_breaker_trips_total",
    "Circuit-breaker trips (one degrade step each) by reason: 'device' = "
    "consecutive program failures, 'parity' = the sentinel proved a "
    "program returned a wrong answer")
WATCHDOG_RESTARTS = REGISTRY.counter(
    "scheduler_watchdog_restarts_total",
    "Dead/stalled threads the watchdog restarted, by thread")
EVENTS_DROPPED = REGISTRY.counter(
    "events_dropped_total",
    "Events dropped by the recorder (full queue or failed API write) — "
    "events are best-effort, but silently so no longer")
BIND_RETRIES = REGISTRY.counter(
    "scheduler_bind_retries_total",
    "Jittered retries of bind/status API writes that would previously "
    "have failed straight through to a requeue")

# Continuous correctness auditing (kubernetes_tpu/audit/): the auditor
# sweeps a consistent apiserver+scheduler snapshot for invariant breaks;
# the parity sentinel cross-checks sampled device dispatches against the
# numpy oracle. Violations here mean WRONG state, not slow state — every
# one also writes a replayable repro bundle to disk.
INVARIANT_VIOLATIONS = REGISTRY.counter(
    "scheduler_invariant_violations_total",
    "Confirmed correctness-invariant violations by invariant "
    "(node_overcommit|double_bind|gang_atomicity|nomination_consistency|"
    "cache_parity|ctx_parity)")
AUDIT_SWEEPS = REGISTRY.counter(
    "scheduler_audit_sweeps_total",
    "Completed invariant-auditor sweeps")
PARITY_SAMPLES = REGISTRY.counter(
    "scheduler_parity_samples_total",
    "Device dispatches sampled by the parity sentinel, by site "
    "(drain|wave)")
PARITY_DIVERGENCES = REGISTRY.counter(
    "scheduler_parity_divergence_total",
    "Sampled device dispatches whose winners the numpy oracle REFUTED "
    "(each one trips the circuit breaker with reason 'parity'), by site")

# Bulk control-plane fan-in (the sublinear-control-plane paths): every
# store-level bulk verb counts here regardless of transport (HTTP endpoint
# or DirectClient), so a bench JSON can attribute how much of the fleet's
# API traffic rode batched requests vs per-object round trips.
BULK_REQUESTS = REGISTRY.counter(
    "apiserver_bulk_requests_total",
    "Bulk API requests by endpoint (pods/-/binding | pods/-/status | "
    "nodes/-/status | leases/-/renew | bulk-create)")
HEARTBEAT_BATCH = REGISTRY.histogram(
    "kubelet_heartbeat_batch_size",
    "Nodes per bulk heartbeat flush (kubemark _HeartbeatBatcher shards)",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096))
LEASE_BATCH = REGISTRY.histogram(
    "kubelet_lease_batch_size",
    "Leases per bulk renew flush (kubemark _LeaseBatcher shards)",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096))
STATUS_BATCH = REGISTRY.histogram(
    "kubemark_status_batch_size",
    "Pod statuses per bulk flush (kubemark _StatusBatcher shards)",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096))
BATCHER_QUEUE_DEPTH = REGISTRY.gauge(
    "kubemark_batcher_queue_depth",
    "Entries queued in a fleet batcher at its last flush, by batcher "
    "(heartbeat | lease | status)")
BATCHER_DROPS = REGISTRY.counter(
    "kubemark_batcher_drops_total",
    "Entries a fleet batcher dropped because its bounded re-coalesce "
    "queue was full during an apiserver outage, by batcher — dropped "
    "payloads heal via the next sync/sweep re-assert, but silently so "
    "no longer")

# Disaster recovery (the apiserver-crash-restart campaign): the durable
# store's crash-tolerance evidence and the node-lifecycle mass-unready
# protection that keeps an outage from cascading into eviction storms.
WAL_TORN_TAIL = REGISTRY.counter(
    "store_wal_torn_tail_total",
    "Torn trailing WAL records dropped (and truncated off disk) during "
    "restore — each one is a write that never committed before a crash "
    "(SIGKILL mid-append)")
DISRUPTION_MODE = REGISTRY.gauge(
    "nodelifecycle_disruption_mode",
    "Node-lifecycle disruption mode: 0 = Normal, 1 = PartialDisruption "
    "(unready fraction >= unhealthyZoneThreshold: evictions at the "
    "reduced secondary rate, or halted in small clusters), 2 = "
    "FullDisruption (every node unready: taint/evict halted entirely — "
    "the signal, not the fleet, is presumed broken)")
NODELIFE_EVICTIONS = REGISTRY.counter(
    "nodelifecycle_evictions_total",
    "Pods evicted by the node-lifecycle NoExecute taint path")
NODELIFE_DEFERRED = REGISTRY.counter(
    "nodelifecycle_evictions_deferred_total",
    "Evictions deferred by disruption-mode rate limiting (halted mode "
    "or the secondary-rate token bucket) — retried by the next monitor "
    "sweep if the node is still unhealthy")

# Warm start (sched/aotcache.py): the durable cache of the nvcc-built
# kernel libraries a restarted scheduler loads instead of building.
# Errors/invalidations are COUNTED degrades — a corrupt or stale entry is
# rebuilt, never loaded.
AOT_CACHE_ERRORS = REGISTRY.counter(
    "scheduler_aot_cache_errors_total",
    "Durable kernel-cache entries rejected at boot or load (checksum "
    "mismatch, truncation, unreadable file), by reason — each one "
    "degraded to a counted rebuild")
AOT_CACHE_INVALIDATIONS = REGISTRY.counter(
    "scheduler_aot_cache_invalidations_total",
    "Kernel-cache entries invalidated wholesale (toolchain/config "
    "fingerprint mismatch) or rotated out by the size bound, by reason")
AOT_CACHE_ENTRIES = REGISTRY.gauge(
    "scheduler_aot_cache_entries",
    "Live entries in the durable kernel cache after the last boot scan / "
    "seal")
AOT_CACHE_BYTES = REGISTRY.gauge(
    "scheduler_aot_cache_bytes",
    "Bytes held by the durable kernel cache after the last boot scan / "
    "seal")
AOT_CACHE_BOOT_MS = REGISTRY.gauge(
    "scheduler_aot_cache_boot_load_ms",
    "Milliseconds the last activation spent fingerprinting, integrity-"
    "scanning and arming the durable kernel cache")
# the counterpart of jax.jit's cache misses on the round loop
# (models/graphs.py): each capture of a chunk of gang rounds
GRAPH_CAPTURES = REGISTRY.counter(
    "scheduler_graph_captures_total",
    "CUDA graph captures of a chunk of gang rounds (a new shape, static "
    "argument or context address); 0 in a warm steady window")

# Scheduler informer hygiene at fleet scale: node MODIFIEDs whose only
# news is liveness (heartbeat condition timestamps / lease-driven
# refreshes) are skipped BEFORE decode — they must not wake the
# scheduling loop or append resident-ctx deltas (the PR-8 bound-pod
# status-MODIFIED discipline applied to nodes).
NODE_LIVENESS_SKIPS = REGISTRY.gauge(
    "scheduler_node_liveness_event_skips",
    "Node MODIFIED events skipped by the scheduler's informer handler "
    "because only liveness fields (heartbeat/lease refresh) changed")

# Fleet scheduling fairness (sched/fleet.py): per-tenant batch-slot share
# and pending depth — a noisy neighbor starving siblings shows up as one
# tenant's share climbing while another's pending grows unbounded.
FLEET_BATCH_SHARE = REGISTRY.gauge(
    "scheduler_fleet_batch_share",
    "Pods handed to the shared drain pipeline per tenant (monotone; "
    "labelled by tenant)")
FLEET_PENDING = REGISTRY.gauge(
    "scheduler_fleet_pending",
    "Pods queued (active+backoff+unschedulable) per tenant")

# Fleet scheduling fairness (sched/fleet.py): per-tenant batch-slot share
# and pending depth — a noisy neighbor starving siblings shows up as one
# tenant's share climbing while another's pending grows unbounded.
FLEET_BATCH_SHARE = REGISTRY.gauge(
    "scheduler_fleet_batch_share",
    "Pods handed to the shared drain pipeline per tenant (monotone; "
    "labelled by tenant)")
FLEET_PENDING = REGISTRY.gauge(
    "scheduler_fleet_pending",
    "Pods queued (active+backoff+unschedulable) per tenant")

# Kubelet pod-sync health (pod_workers.go error bookkeeping analog).
# Aggregate only — per-pod counts are PodWorkers.sync_errors(uid); a
# per-uid label would grow one label set per failing pod forever.
KUBELET_SYNC_ERRORS = REGISTRY.counter(
    "kubelet_pod_sync_errors_total",
    "Pod sync failures (retried with per-pod backoff)")

# Snapshot-freshness observability (the autoscaler's overlay rides the
# cache's encoded snapshot; staleness shows up here first).
CACHE_GENERATION = REGISTRY.gauge(
    "scheduler_cache_generation",
    "SchedulerCache generation counter (any encode-relevant mutation)")
CACHE_FULL_ENCODES = REGISTRY.gauge(
    "scheduler_cache_snapshot_full_encodes",
    "Full cluster re-encodes performed by snapshot() (vs patch/clean paths)")

# Cluster-autoscaler SLIs (cluster-autoscaler/metrics/metrics.go analogs).
AUTOSCALER_LOOP_DURATION = REGISTRY.histogram(
    "cluster_autoscaler_loop_duration_seconds",
    "One autoscaler reconcile (observe + simulate + act) by phase")
AUTOSCALER_DECISIONS = REGISTRY.counter(
    "cluster_autoscaler_decisions_total",
    "Autoscaler decisions by action (scaleUp|scaleDown|noop|backoff)")
AUTOSCALER_SCALED = REGISTRY.counter(
    "cluster_autoscaler_scaled_nodes_total",
    "Nodes added/removed by direction and node group")
AUTOSCALER_UNSCHEDULABLE = REGISTRY.gauge(
    "cluster_autoscaler_unschedulable_pods",
    "Pending pods the last loop saw as unschedulable")
AUTOSCALER_GROUP_SIZE = REGISTRY.gauge(
    "cluster_autoscaler_node_group_size", "Current size by node group")

# Descheduler SLIs (kubernetes-sigs/descheduler pkg/descheduler/metrics
# analogs, plus the batching figure unique to the tensor path).
DESCHEDULER_EVICTIONS = REGISTRY.counter(
    "descheduler_evictions_total",
    "Evictions by strategy and result (evicted|refused|gone)")
DESCHEDULER_PLAN_BATCH = REGISTRY.gauge(
    "descheduler_plan_batch_size",
    "Victim rows validated by the last single batched re-placement "
    "simulation, by phase (strategies|gangDefrag)")
DESCHEDULER_LOOP_DURATION = REGISTRY.histogram(
    "descheduler_loop_duration_seconds",
    "One descheduler cycle by phase (plan|evict)")

# The resident background-planner loop (sched/bgplanner.py + encode/
# overlay.py): the three planners' what-if questions answered as warm
# dispatches on the device-resident cluster image, with decline-to-cold
# fallbacks and a compile gate over the steady window.
SCHEDULER_PLANNER_OVERLAY = REGISTRY.counter(
    "scheduler_planner_overlay_total",
    "Resident-overlay planning attempts by planner (autoscaler|"
    "descheduler|gangDefrag) and outcome (hit|decline) — a decline falls "
    "back to the cold-encode path with a bit-identical plan")
SCHEDULER_PLANNER_CYCLE_DURATION = REGISTRY.histogram(
    "scheduler_planner_cycle_duration_seconds",
    "One BackgroundPlanner sub-cycle by planner (autoscaler|descheduler|"
    "gangDefrag) — the per-planner span accounting the PlannerLoop bench "
    "reads")
SCHEDULER_PLANNER_COMPILES = REGISTRY.counter(
    "scheduler_planner_compiles_total",
    "XLA backend_compile events observed inside armed BackgroundPlanner "
    "windows (must stay 0 in the steady window)")

# The read-replica serving plane ("front door"): sharded watch fan-out with
# bounded per-watcher queues on every apiserver, follower replicas serving
# list/watch with a bounded-staleness contract.
WATCH_DROPS = REGISTRY.counter(
    "apiserver_watch_drops_total",
    "Watchers force-disconnected because their bounded event queue "
    "overflowed (slow consumer), by kind — each drop closes the stream "
    "with an ERROR event, forcing the client to relist")
WATCH_CLIENTS = REGISTRY.gauge(
    "apiserver_watch_clients",
    "Currently-registered watchers by kind, summed over fan-out shards")
REPLICA_LAG = REGISTRY.gauge(
    "apiserver_replica_replay_lag_seconds",
    "Read replica commit-replay lag: seconds since this follower was last "
    "caught up to the leader's commit index (0 while current; grows when "
    "the leader is unreachable or replay falls behind)")
READ_REQUESTS = REGISTRY.counter(
    "apiserver_read_requests_total",
    "Read requests (GET/list/watch) served, by role (leader|replica)")

# The cluster time machine (kubernetes_tpu/scenario/driver.py): trace
# replay against the connected stack. Skew is the driver's own dispatch
# punctuality (how far behind the trace's scheduled offsets it ran);
# attempt latency is create-dispatch to observed-bound per trace pod,
# labeled by trace phase — the per-phase p99 the scenario SLO gates read.
SCENARIO_EVENTS = REGISTRY.counter(
    "scenario_events_total",
    "Trace events dispatched by the scenario driver, by verb and "
    "result (ok|error)")
SCENARIO_SKEW = REGISTRY.histogram(
    "scenario_dispatch_skew_seconds",
    "Per-event dispatch skew: actual dispatch time minus the trace's "
    "scheduled (time-warped) offset")
SCENARIO_ATTEMPT = REGISTRY.histogram(
    "scenario_attempt_latency_seconds",
    "Trace-pod scheduling attempt latency (create dispatch to the "
    "driver observing the binding), by trace phase")
