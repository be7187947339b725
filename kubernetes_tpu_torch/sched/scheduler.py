"""Scheduler main loop — pop batch -> snapshot -> gang step -> assume/bind.

The PyTorch port of ``kubernetes_tpu/sched/scheduler.py``. Reference shape:
``pkg/scheduler/scheduler.go`` (Scheduler.Run) + ``schedule_one.go``
(scheduleOne / schedulingCycle / bindingCycle), inverted for batching:
each iteration drains up to batch_size pods from the queue, runs ONE device
gang step for the whole batch, then assumes + binds asynchronously.
Binding overlaps the next batch's scheduling cycle exactly like the
reference's ``go bindingCycle`` — failures roll back via Cache.forget.

Profiles: pods are grouped by spec.schedulerName; unknown names are ignored
(the reference leaves such pods to whatever scheduler owns them).

Where the port differs from the reference:

- Dispatch is not asynchronous: ``drain_step`` reads its progress flag on
  the host once per chunk of K rounds (each chunk one captured CUDA graph,
  models/graphs.py), so it returns once the drain has converged. The pipeline
  (``_pending``, ``fill_bound`` reserved at dispatch and adjusted at
  resolve, the depth bound, the resolver thread) keeps its structure; the
  overlap with the card comes from the staging arena (the next batch's
  copy on a side stream) and the binding pool. The resolver's fetch is one
  non-blocking copy of ``assignments [B,P]`` and ``rounds [B]`` into pinned
  memory, plus an event it waits on.
- The resident context is updated IN PLACE where the reference donates
  it, so the ``ct`` an in-flight drain refers to is the live one:
  ``_resolve_one`` reads only the patch state and the host mirror, and
  ``warm_drain`` runs its warm-up drains on a context it throws away.
- The ``KTPU_*`` environment overrides of the reference's constructor are
  left out; the config fields behind them stay. ``cycle_log`` is None
  unless the caller sets it to a list.
- A failure that ``sched/faults.is_fatal`` calls fatal (a ``KernelError``,
  a ``ParityError``, a ``NotImplementedError`` or a CUDA error) is
  re-raised at every site that catches device work: the gang program, the
  drain dispatch and resolve, preemption, ``run``. It never feeds the
  breaker and never moves the work to the oracle or the host scan, where
  the reference degrades to the oracle on an XLA error. A CUDA
  out-of-memory error is not fatal and keeps that retry path.

- The explainer (``sched/explainer.py``) judges a failed cycle's pods on
  the scheduler's device, and with the oracle only a cycle at the
  breaker's oracle level; a failure of its device judge is counted
  (``LOOP_ERRORS{site=device_explain}``) and leaves the pods with the
  generic event, and a fatal failure there is raised at the next pop, as
  the parity sentinel's refutation is.
- Default preemption (the PostFilter path, ``sched/preemption.py``)
  catches a failure of its device programs only here, in
  ``_default_preempt`` and ``_default_preempt_wave``: a fatal failure
  propagates, anything else is counted
  (``LOOP_ERRORS{site=device_preempt}``), feeds the breaker and takes the
  exact host scan. The reference swallows such failures inside
  ``sched/preemption.py`` as well, uncounted.

- Slice gangs (``kubernetes-tpu.io/slice-shape``) are carved on the
  group path by ``topology/carve.carve_step`` on the scheduler's device,
  outside the gang program's breaker site: a carve that fails raises, and
  is never carved by the oracle in the card's place (only a cycle at the
  breaker's oracle level carves on the host). The snapshot moves to the
  device once and the carve and ``gang_schedule`` share it.

Out-of-tree tensor plugins (sched/framework.py) run inside the gang
rounds at the group path, the drain and the warm ladder, as in the
reference; a profile whose plugins filter is requeued rather than
scheduled by the oracle (``_schedule_oracle``). DRA device
claims (sched/dra.py) ride the resource axis as in the reference, and a
slice-shaped ResourceClaim routes its pod into the carver. A ``meshShape`` runs
single-device with a warning, as the reference does with too few
devices. Fleet mode (7b) is ported: ``sched/fleet.FleetRunner`` sets
``fleet_mode``. The parity sentinel (``audit/sentinel.py``) samples drains, preemption waves
and slice carves as in the reference, but an answer it refutes stops the
loop with a ``ParityError`` where the reference trips the breaker to the
oracle.
"""

from __future__ import annotations

import dataclasses
import logging
import queue as queue_mod
import threading
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.config.features import DEFAULT_FEATURE_GATE
from kubernetes_tpu_torch.config.types import SchedulerConfiguration
from kubernetes_tpu_torch.device import resolve_device
from kubernetes_tpu_torch.encode.snapshot import tenant_label_of
from kubernetes_tpu_torch.metrics.registry import (
    ATTEMPT_DURATION,
    BATCH_DURATION,
    DRAIN_SHARD_MS,
    GANG_ROUNDS,
    LOOP_ERRORS,
    MESH_DEVICES,
    PIPELINE_DEPTH,
    PIPELINE_INFLIGHT,
    QUEUE_DEPTH,
    RESOLVE_BYTES,
    SCHEDULE_ATTEMPTS,
)
from kubernetes_tpu_torch.models.gang import gang_schedule
from kubernetes_tpu_torch.audit.sentinel import ParitySentinel
from kubernetes_tpu_torch.sched import preemption as preemption_mod
from kubernetes_tpu_torch.sched.cache import SchedulerCache
from kubernetes_tpu_torch.sched.explainer import (GENERIC_MESSAGE,
                                                  SchedulingExplainer)
from kubernetes_tpu_torch.sched.faults import is_fatal
from kubernetes_tpu_torch.sched.queue import SchedulingQueue
from kubernetes_tpu_torch.sched.resilience import DeviceCircuitBreaker
from kubernetes_tpu_torch.utils import sanity
from kubernetes_tpu_torch.utils.events import NullRecorder
from kubernetes_tpu_torch.utils.tracing import FLIGHT, TRACER

_LOG = logging.getLogger(__name__)

# binder(pod, node_name) -> bool success. The client layer supplies the real
# POST pods/<p>/binding; tests pass a lambda.
Binder = Callable[[Pod, str], bool]

# Resident nominee-reservation bucket in the drain context (encode/patch.py):
# preemption storms patch reservations device-side instead of dropping the
# context. Static — part of the drain shapes.
DRAIN_NOM_BUCKET = 128

# Bounded resolve wait: how long the scheduling thread waits on the
# resolver's Event before degrading to an inline fetch — a dead or stalled
# resolver must never hang the loop.
RESOLVE_WAIT_S = 30.0


class Scheduler:
    def __init__(self, cfg: SchedulerConfiguration, cache: SchedulerCache,
                 queue: SchedulingQueue, binder: Binder,
                 feature_gate=DEFAULT_FEATURE_GATE,
                 preemptor: Optional[Callable] = None,
                 registry=None, bulk_binder: Optional[Callable] = None,
                 device=None):
        self.cfg = cfg
        self.cache = cache
        self.queue = queue
        self.binder = binder
        # the card unless the caller asks for the CPU (tests)
        self.device = resolve_device(device)
        mesh = cfg.mesh_shape
        if mesh is not None and mesh[0] * mesh[1] > 1:
            # the port runs on one device: as the reference does when the
            # backend has fewer devices than the mesh asks for, it runs
            # single-device rather than refuse to schedule (the mesh is a
            # throughput knob, not a correctness requirement)
            _LOG.warning("mesh shape %s unavailable: the port runs on one "
                         "device; running single-device", mesh)
        MESH_DEVICES.set(1)
        # bulk_binder(pairs: [(Pod, node_name)]) -> [bool]: one API call
        # binding a whole gang batch. Pods needing per-pod ceremony
        # (lifecycle hooks, volume binding) still go through ``binder``.
        self._bulk_binder = bulk_binder
        self.features = feature_gate
        self._custom_preemptor = preemptor is not None
        # PDBs for preemption's victim selection; the runner wires its
        # informer's store here
        self.pdb_lister: Callable[[], list] = lambda: []
        # scheduler extenders (extender.go HTTPExtender analog)
        from kubernetes_tpu_torch.sched.extender import (HTTPExtender,
                                                         extender_binder)
        self._extenders = [HTTPExtender(c) for c in (cfg.extenders or [])]
        self._extender_bind = (extender_binder(self._extenders)
                               if self._extenders else None)
        self.preemptor = preemptor if preemptor is not None else self._default_preempt
        # Binding pool: a fixed set of long-lived workers (the reference
        # spawns a goroutine per bindingCycle behind client-go's shared
        # rate-limited transport).
        self._bind_q: "queue_mod.Queue[tuple[Pod, str]]" = queue_mod.Queue()
        self._bind_workers: list[threading.Thread] = []
        self._bind_inflight = 0
        self._bind_cv = threading.Condition()
        # device-resident drain context (see _schedule_drain): the card's
        # replica of the cluster encoding, valid while the only pending
        # cache deltas are assumes this loop folded on the device
        self._drain_ctx = None
        # bumped by every context build (a rebuild, warm_drain): a rebuild
        # at the old shapes reuses the old tensors (gang.adopt_storage), so
        # the planners' race check reads this instead of their identity
        self._ctx_epoch = 0
        # the last warm ladder's report (warm_drain)
        self.warm_stats: dict = {}
        # on the card the gang rounds replay as captured CUDA graphs
        # (models/graphs.py); False runs them eagerly, for comparisons
        # only: the scheduler itself never turns it off, and a capture
        # that fails is fatal (sched/faults.is_fatal)
        self.capture = True
        # device circuit breaker: consecutive device-program failures walk
        # single-device -> pure-numpy oracle, with half-open recovery
        # (sched/resilience.py)
        self.breaker = DeviceCircuitBreaker(
            levels=("single", "oracle"), threshold=cfg.breaker_threshold,
            cooldown_s=cfg.breaker_cooldown_s)
        self._attempt_level = self.breaker.mode
        # device-parity sentinel (audit/sentinel.py): every Kth drain
        # dispatch is re-judged against the numpy oracle off this thread;
        # a refuted answer is a ParityError that the next pop raises (the
        # reference trips the breaker to the oracle instead)
        self.sentinel = None
        if cfg.parity_sample_every > 0:
            self.sentinel = ParitySentinel(every=cfg.parity_sample_every)
        # decision-provenance explainer (sched/explainer.py): re-runs the
        # static filter stack in per-filter-output mode over unschedulable
        # pods on its own thread — upstream-style FailedScheduling
        # messages and unschedulable-reason metrics with no work added to
        # the drain cycle. recorder_ref is a callable because the runner
        # swaps self.recorder after construction.
        self.explainer = None
        if cfg.explainer_enabled:
            self.explainer = SchedulingExplainer(
                cfg, lambda: self.recorder, device=self.device)
        # watchdog heartbeats (the runner wires these to its watchdog;
        # library embedders keep the no-ops)
        self.heartbeat: Callable[[], None] = lambda: None
        self.resolver_heartbeat: Callable[[], None] = lambda: None
        # Fused fold: churn patches ride the drain dispatch as drain_step's
        # patch input instead of a separate apply_ctx_patch (and fold-safe
        # churn skips the pipeline drain).
        self._fused_fold = cfg.fused_fold
        # double-buffered batch staging (sched/staging.py); the cache owns
        # the arena and stages for this scheduler's device
        self.cache.configure_staging(cfg.staging_arena, self.device)
        # context lifecycle counters: "folds" are churn deltas fused into a
        # drain dispatch, "patches" separate apply_ctx_patch calls —
        # steady-state fused churn keeps patches at 0
        self.ctx_stats = {"patches": 0, "folds": 0, "rebuilds": 0,
                          "unfit": 0, "reasons": {}}
        # per-drain-cycle debug trail (pop size, t_pop, marks); set it to a
        # list to record
        self.cycle_log: Optional[list] = None
        # Multi-deep software pipeline: in-flight drains awaiting
        # resolution, oldest first. Bounded by cfg.pipeline_depth.
        self._pending: "deque[dict]" = deque()
        # Dedicated resolver thread: the fetch of each drain's results runs
        # there; the scheduling thread waits on a plain Event.
        # serializes (queue, thread) swaps between the scheduling thread's
        # lazy spawn, the watchdog's restart_resolver, and close()
        self._resolver_swap_lock = threading.Lock()
        self._resolver_q: Optional["queue_mod.Queue"] = None  # guarded by: self._resolver_swap_lock
        self._resolver_thread: Optional[threading.Thread] = None  # guarded by: self._resolver_swap_lock
        # Fleet mode (sched/fleet.py FleetRunner sets this): pops are split
        # into TENANT-HOMOGENEOUS drain chunks so every tenant's pods sit at
        # positions 0..n of their own chunk — the alignment property that
        # makes fleet-batched placements bit-equal to independent
        # per-tenant runs (same seed, same tie-break salts).
        self.fleet_mode = False
        # fragment pops parked while the device is busy (see run_once)
        self._staged: list = []
        self._staged_once = False   # a parked fragment merges at most once
        self._last_pop_full = False  # burst heuristic: arrivals are hot
        # ---- topology slice carving (topology/) --------------------------
        # Carve plans for slice gangs that could NOT be placed this cycle:
        # gang id -> {"res": CarveResult, "members": [...], "nodes": [...],
        # "shape": ..., "dims": ...}. Written by _carve_slices and consumed
        # by _handle_failures within the SAME _run_batch call — scheduling
        # thread only, cleared each cycle.
        self._carve_plans: dict[str, dict] = {}
        self._carve_lock = threading.Lock()
        # shapes seen on slice gangs + carve outcome counters — read by the
        # runner's status thread (topology_status)
        self._carve_shapes_seen: set = set()  # guarded by: self._carve_lock
        self._carve_stats = {"carved": 0, "failed": 0, "slicePreempts": 0}  # guarded by: self._carve_lock
        # preemption nominees awaiting re-schedule: key -> (node, prio, pod,
        # ts). Their freed capacity is reserved against lower-priority pods
        # until they bind. The TTL backstops pods deleted while nominated.
        self._nominated: dict[str, tuple] = {}
        self._nominated_ttl = 300.0
        # API-visible nominations set by OTHER components, staged under a
        # lock by the informer thread and folded into _nominated on the
        # scheduling thread each cycle
        self._nominated_staged: dict[str, Optional[tuple]] = {}
        self._nominated_staged_lock = threading.Lock()
        # keys whose _nominated entry came from the API: only those may be
        # cleared by an API-side removal
        self._nominated_external: set[str] = set()
        # event recording; the runner wires a real recorder
        self.recorder = NullRecorder()
        # out-of-tree plugin registry (framework.Registry analog). Profiles
        # referencing unregistered names fail fast here.
        from kubernetes_tpu_torch.sched.framework import Registry
        self.registry = registry if registry is not None else Registry()
        known = {p.name for p in self.registry.tensor_plugins()} \
            | {p.name for p in self.registry.lifecycle_plugins()}
        for prof in cfg.profiles:
            unknown = set(prof.out_of_tree or ()) - known
            if unknown:
                raise ValueError(
                    f"profile {prof.scheduler_name!r} references "
                    f"unregistered out-of-tree plugins: {sorted(unknown)}")

    def _tensor_plugins(self, profile) -> tuple:
        """The profile's out-of-tree TensorPlugins, order-stable by name
        (every registered one when the profile lists none)."""
        oot = (None if profile is None or profile.out_of_tree is None
               else set(profile.out_of_tree))
        return self.registry.tensor_plugins(oot)

    # ---- staging ---------------------------------------------------------

    def _stage_batch(self, pb_stack, ticket, n_pods: int):
        """Dispatch-time batch staging: the whole operation is
        ``scheduler/stage_batch`` and the arena redeem within it is
        ``scheduler/stage_swap`` — in steady state the swap IS the whole
        cost, and an inline fallback shows up as stage_batch time exceeding
        stage_swap. Every drain staging site goes through here."""
        with TRACER.span("scheduler/stage_batch", pods=n_pods):
            if ticket is not None:
                with TRACER.span("scheduler/stage_swap", pods=n_pods):
                    staged = self.cache.stage_redeem(ticket)
                if staged is not None:
                    return staged
            return self.cache.stage_drain_batch(pb_stack)

    def _stage_fill(self, fill: int):
        """Device-resident fill scalar for a fresh context (the steady state
        passes the previous drain's new_fill through)."""
        return torch.tensor(fill, dtype=torch.int32, device=self.device)

    # ---- external nominations -------------------------------------------

    def nominate_external(self, pod: Pod, node_name: str) -> None:
        """Register a nominatedNodeName another component wrote to the API.
        The reservation shields the node's capacity from lower-priority
        pods until the nominee binds. Safe to call from the informer
        thread; entries fold into _nominated on the scheduling thread. An
        empty ``node_name`` stages a CLEAR of an API-origin entry."""
        with self._nominated_staged_lock:
            if node_name:
                self._nominated_staged[pod.key] = (
                    node_name, pod.spec.priority, pod, time.time())
            else:
                self._nominated_staged[pod.key] = None

    def _fold_staged_nominations(self) -> None:
        if not self._nominated_staged:
            return
        with self._nominated_staged_lock:
            staged, self._nominated_staged = self._nominated_staged, {}
        # entries pruned since registration (bound / TTL) drop out of the
        # external set too, keeping it bounded by live nominations
        self._nominated_external &= set(self._nominated)
        for k, e in staged.items():
            if e is None:
                if k in self._nominated_external:
                    self._nominated.pop(k, None)
                    self._nominated_external.discard(k)
            elif not self.cache.is_bound(k):
                self._nominated[k] = e
                self._nominated_external.add(k)

    # ---- dispatch pipeline ----------------------------------------------

    @property
    def _pending_drain(self) -> Optional[dict]:
        """Oldest in-flight drain, or None when the pipeline is empty."""
        return self._pending[0] if self._pending else None

    @staticmethod
    def _drain_ready(pend: dict) -> bool:
        return pend["done"].is_set()

    def _resolve_ready(self) -> int:
        """Land every in-flight drain whose results are already on the host
        (no blocking). Returns pods bound."""
        n = 0
        while self._pending and self._drain_ready(self._pending[0]):
            n += self._resolve_one()
        return n

    def _start_fetch(self, pend: dict) -> None:
        """Queue the copy of the drain's results to the host: on the card
        one non-blocking copy each of assignments [B,P] and rounds [B] into
        pinned memory, then an event the resolver waits on."""
        a, r = pend["assignments"], pend["rounds"]
        if a.device.type != "cuda":
            pend["host"] = (a, r)
            return
        host = tuple(torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                     for x in (a, r))
        for h, x in zip(host, (a, r)):
            h.copy_(x, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        pend["host"] = host
        pend["fetched"] = ev

    @staticmethod
    def _fetch(pend: dict):
        """(assignments, rounds) as numpy: waits for the queued copy."""
        ev = pend.get("fetched")
        if ev is not None:
            ev.synchronize()
        return tuple(h.numpy().copy() for h in pend["host"])

    def _submit_resolve(self, pend: dict) -> None:
        """Hand the drain's result fetch to the resolver thread: it waits
        for the copy and publishes numpy results + sets ``pend['done']``."""
        self._start_fetch(pend)
        pend["done"] = threading.Event()
        self._ensure_resolver().put(pend)

    def _ensure_resolver(self) -> "queue_mod.Queue":
        """Resolver queue, (re)spawning the thread if dead. Serialized with
        restart_resolver."""
        with self._resolver_swap_lock:
            if (self._resolver_thread is None
                    or not self._resolver_thread.is_alive()):
                self._spawn_resolver_locked()
            return self._resolver_q

    def _spawn_resolver_locked(self) -> None:
        """Install a fresh (queue, thread) pair and MIGRATE the old queue's
        drains — a dead thread's queued pends would otherwise never get
        their done Event set. The thread is published only once started:
        the watchdog reads ``_resolver_thread.is_alive()`` without the
        swap lock, and a thread published before ``start()`` returns reads
        as dead, so a sweep in that window restarted a healthy resolver."""
        old_q = self._resolver_q
        new_q = queue_mod.Queue()
        t = threading.Thread(
            target=self._resolver_loop, args=(new_q,),
            daemon=True, name="drain-resolver")
        t.start()
        self._resolver_q = new_q
        self._resolver_thread = t
        if old_q is not None:
            try:
                while True:
                    it = old_q.get_nowait()
                    if it is not None:
                        new_q.put(it)
            except queue_mod.Empty:
                pass
            old_q.put(None)  # poison, should the old thread still wake

    def restart_resolver(self) -> None:
        """Watchdog restart path: swap in a fresh resolver thread and move
        the old queue's drains over. The resident ctx is NOT touched —
        resolver death loses no device state, only a fetch."""
        with self._resolver_swap_lock:
            self._spawn_resolver_locked()

    def _resolver_loop(self, q: "queue_mod.Queue") -> None:
        while True:
            pend = q.get()
            if pend is None:  # poison pill from close()/restart
                return
            try:
                self.resolver_heartbeat()
                pend["resolved"] = self._fetch(pend)
            except Exception as e:
                if is_fatal(e):
                    # the scheduling thread raises it in _resolve_one
                    pend["fault"] = e
                else:
                    # surface on the scheduling thread: _resolve_one
                    # retries the fetch inline and handles the real error
                    LOOP_ERRORS.inc({"site": "resolver"})
                    _LOG.exception("drain resolver fetch failed")
            finally:
                pend["done"].set()

    # ---- one batch iteration --------------------------------------------

    def run_once(self, wait: float = 0.5) -> int:
        """Schedule one pop's worth of pods. Returns pods bound (or assumed).

        A pop can yield up to ``batch_size * max_drain_batches`` pods; a deep
        backlog takes the resident drain path while shallow pops run the
        single-batch program.

        Raises the sentinel's ``ParityError`` once it has refuted a
        drain, and the explainer's fault (a fatal failure of its device
        judge, ``sched/faults.is_fatal``), before popping anything."""
        if self.sentinel is not None and self.sentinel.fault is not None:
            raise self.sentinel.fault
        if self.explainer is not None and self.explainer.fault is not None:
            raise self.explainer.fault
        self._fold_staged_nominations()
        # land finished drains' bindings first (don't let finished results
        # sit behind a blocking pop)
        n_early = self._resolve_ready()
        cap = self.cfg.batch_size * max(1, self.cfg.max_drain_batches)
        batch = self.queue.pop_batch(
            max(1, cap - len(self._staged)),
            wait=0.05 if self._pending else wait)
        if self._staged:
            batch = self._staged + batch
            self._staged = []
        if not batch:
            return n_early + self._resolve_pending()
        try:
            return n_early + self._run_batch(batch, cap)
        except BaseException:
            # mid-cycle failure with the popped batch in hand: the pods are
            # in no queue and no watch event will re-deliver them — requeue
            # before the exception escapes
            self._rescue_batch(batch)
            raise

    def _rescue_batch(self, batch) -> None:
        self._staged = []  # a fragment staged THIS cycle is part of batch
        rescued = 0
        for pod, attempts in batch:
            if not self.cache.is_assumed_or_bound(pod.key):
                self.queue.add_unschedulable(pod, attempts + 1)
                rescued += 1
        if rescued:
            _LOG.warning("mid-cycle failure: requeued %d popped pods",
                         rescued)

    def _run_batch(self, batch, cap: int) -> int:
        """The body of one cycle once a batch is in hand (split out so
        run_once can rescue the batch on ANY failure)."""
        if (len(batch) < self.cfg.batch_size and not self._staged_once
                and (self._pending or self._last_pop_full)):
            # A fragment pop while the device is busy or right after a
            # full-size pop: park it once, settle the OLDEST in-flight
            # drain, and let the fragment merge with the arrivals that land
            # meanwhile.
            self._staged = batch
            self._staged_once = True
            return self._resolve_one()
        self._staged_once = False
        self._last_pop_full = len(batch) >= cap
        self._carve_plans.clear()  # plans never outlive their cycle
        stats = self.queue.stats()
        for q, v in stats.items():
            QUEUE_DEPTH.set(v, {"queue": q})
        # Slot headroom = everything still pending (this batch + queued):
        # the snapshot reserves that many existing-pod slots so the whole
        # drain binds via incremental patches with stable tensor shapes.
        headroom = len(batch) + sum(stats.values())

        by_profile: dict[str, list[tuple[Pod, int]]] = {}
        for pod, attempts in batch:
            by_profile.setdefault(pod.spec.scheduler_name, []).append((pod, attempts))

        n_bound = n_landed = 0
        serial = not self.features.enabled("TPUBatchScheduling")
        # degrade-don't-die routing: the breaker picks the level this cycle
        # attempts — "single" runs the tensor programs, "oracle" bypasses
        # the device entirely
        level = self.breaker.attempt_level()
        self._attempt_level = level
        if level == "oracle" and self._pending:
            # oracle mode dispatches nothing new; in-flight drains from
            # before the degrade must not linger (bounded waits inside)
            n_landed += self._resolve_pending()
        for sched_name, items in by_profile.items():
            profile = self.cfg.profile_for(sched_name)
            if profile is None:
                # Not ours: park it rather than losing it.
                for pod, attempts in items:
                    self.queue.park_unschedulable(pod, attempts)
                continue
            if level == "oracle":
                n_bound += self._schedule_oracle(profile, items)
                continue
            # slice-shaped gangs never ride the drain path: the carve is a
            # group-path stage (_schedule_group), and a resident drain would
            # place members as independent pods — feasible but not
            # contiguous. Split them out and route them per gang.
            slice_items = [it for it in items
                           if self._slice_shape_of(it[0]) is not None]
            if slice_items:
                items = [it for it in items
                         if self._slice_shape_of(it[0]) is None]
                for chunk in self._slice_chunks(slice_items):
                    n_bound += self._schedule_group(profile, chunk, headroom)
            if not items:
                continue
            if ((len(items) > self.cfg.batch_size
                    or self._drain_ctx is not None)
                    and not serial and not self._extenders):
                n_bound += self._schedule_drain(profile, items, headroom)
            else:
                for chunk in self._tenant_chunks(items, self.cfg.batch_size):
                    n_bound += self._schedule_group(profile, chunk, headroom)
        return n_landed + n_bound

    def _tenant_chunks(self, items: list, P: int) -> list[list]:
        """Split a popped batch into device chunks of up to ``P`` pods.
        Single-tenant (the default): plain consecutive slices.
        Fleet mode: chunks are TENANT-HOMOGENEOUS — each tenant's pods,
        in pop (priority) order, fill their own chunks from position 0,
        so the per-position tie-break salt and the per-chunk balance
        guard see exactly what a standalone run of that tenant would.
        The chunk count is bounded by max_drain_batches (one drain width,
        the resident context's batch count): surplus partial chunks merge
        into mixed chunks, which stay CORRECT (the tenant gate isolates
        them) but waive bit-parity — only full per-tenant blocks claim
        it."""
        if not self.fleet_mode:
            return [items[i:i + P] for i in range(0, len(items), P)]
        groups: dict[str, list] = {}
        order: list[str] = []
        for it in items:
            t = tenant_label_of(it[0].metadata.labels) or ""
            if t not in groups:
                groups[t] = []
                order.append(t)
            groups[t].append(it)
        if len(order) <= 1:
            return [items[i:i + P] for i in range(0, len(items), P)]
        chunks: list[list] = []
        for t in order:
            g = groups[t]
            chunks += [g[i:i + P] for i in range(0, len(g), P)]
        cap = max(max(1, self.cfg.max_drain_batches), -(-len(items) // P))
        # Bound the batch axis by merging ADJACENT chunks — the flattened
        # pod order (and with it the pop's cross-tenant priority order
        # inside the sequential batch scan) is preserved exactly; a
        # size-sorted merge would let a larger low-priority chunk fold its
        # wins into contested capacity ahead of an earlier higher-priority
        # one.
        while len(chunks) > cap:
            best_i = None
            best = P + 1
            for i in range(len(chunks) - 1):
                comb = len(chunks[i]) + len(chunks[i + 1])
                if comb <= P and comb < best:
                    best, best_i = comb, i
            if best_i is None:
                break  # nothing merges within P: accept the extra width
            chunks[best_i] = chunks[best_i] + chunks[best_i + 1]
            del chunks[best_i + 1]
        return chunks

    # ---- topology slice carving (topology/) ------------------------------

    def _slice_shape_of(self, pod: Pod) -> Optional[tuple]:
        """The pod's requested slice shape: the slice-shape label, else a
        slice-shaped ResourceClaim (sched/dra.py). None = not a slice pod
        (malformed shapes schedule as normal pods by design)."""
        from kubernetes_tpu_torch.topology.slicing import shape_of_labels
        s = shape_of_labels(pod.metadata.labels)
        if s is None and self.cache.dra_catalog is not None:
            s = self.cache.dra_catalog.pod_slice_shape(pod)
        return s

    def _slice_chunks(self, items: list) -> list[list]:
        """Group slice pods into device chunks: members of one gang stay
        together (the carve is per-gang), chunks are tenant-homogeneous,
        and whole gangs pack greedily up to batch_size — an oversize gang
        still rides ONE chunk (the pod bucket grows; contiguity over
        bucket reuse)."""
        from kubernetes_tpu_torch.encode.snapshot import tenant_label_of
        from kubernetes_tpu_torch.topology.slicing import GANG_LABEL
        gangs: dict[tuple, list] = {}
        order: list[tuple] = []
        for it in items:
            pod = it[0]
            t = tenant_label_of(pod.metadata.labels) or ""
            g = (pod.metadata.labels or {}).get(GANG_LABEL) or f"pod:{pod.key}"
            key = (t, g)
            if key not in gangs:
                gangs[key] = []
                order.append(key)
            gangs[key].append(it)
        chunks: list[list] = []
        cur: list = []
        cur_tenant = None
        P = self.cfg.batch_size
        for key in order:
            g = gangs[key]
            if cur and (cur_tenant != key[0] or len(cur) + len(g) > P):
                chunks.append(cur)
                cur = []
            cur = cur + g
            cur_tenant = key[0]
        if cur:
            chunks.append(cur)
        return chunks

    def _carve_slices(self, items, nodes, ct, meta, pb, ext_mask):
        """Carve contiguous sub-slices for the batch's slice gangs and pin
        members to their cells.

        One ``carve_step`` call per gang over the SAME device tensors
        gang_schedule is about to run on (``ct`` is already on the
        scheduler's device); earlier gangs' cells are claimed against later
        ones. Returns ``(ext_mask, gang_of, gang_nodes)``: winners get a
        one-hot ext_mask row pinning member -> cell node (the gang
        program's atomicity/tenant machinery is untouched — the carve only
        narrows candidates); a failed carve writes all-False rows so the
        members fail through the NORMAL failure path, where the stashed
        plan (_carve_plans) drives slice preemption and the explain event.
        """
        from kubernetes_tpu_torch.encode.snapshot import TENANT_KEY_ID
        from kubernetes_tpu_torch.topology import carve as carve_mod
        from kubernetes_tpu_torch.topology.slicing import (GANG_LABEL,
                                                           coords_of_labels,
                                                           grid_dims,
                                                           shape_str)
        pods = [p for p, _ in items]
        groups: dict[str, list[int]] = {}
        shapes: dict[str, tuple] = {}
        for i, pod in enumerate(pods):
            shape = self._slice_shape_of(pod)
            if shape is None:
                continue
            g = (pod.metadata.labels or {}).get(GANG_LABEL) or f"pod:{pod.key}"
            groups.setdefault(g, []).append(i)
            shapes[g] = shape
        if not groups:
            return ext_mask, {}, {}
        dims = grid_dims([c for c in (coords_of_labels(n.metadata.labels)
                                      for n in nodes) if c is not None])
        Pb, Nb = pb.pod_valid.shape[0], ct.node_valid.shape[0]
        if ext_mask is None:
            ext_mask = np.ones((Pb, Nb), bool)
        pod_labels = np.asarray(pb.pod_labels)
        requests = np.asarray(pb.requests)
        # a host array that grows across the gangs of this cycle, copied in
        # per call
        claimed = np.zeros(Nb, bool)
        gang_of: dict[int, str] = {}
        gang_nodes: dict[str, dict[int, int]] = {}
        for g in sorted(groups):
            # member order is sorted by pod key — the SAME order the oracle
            # carver uses, so member m <-> C-order box cell m on both sides
            # (part of the bit-parity contract)
            idxs = sorted(groups[g], key=lambda i: pods[i].key)
            shape = shapes[g]
            want = shape[0] * shape[1] * shape[2]
            res = None
            asg = None
            if len(idxs) == want and dims is not None:
                # conservative homogeneous view of the gang: every cell must
                # fit the elementwise-MAX member request (the oracle carver
                # mirrors this)
                member_req = requests[idxs].max(axis=0)
                tenant = (int(pod_labels[idxs[0], TENANT_KEY_ID])
                          if pod_labels.shape[1] > TENANT_KEY_ID else -1)
                res = carve_mod.carve_device(ct, member_req, tenant,
                                             claimed, dims, shape)
                asg = carve_mod.select_assignment(res)
            with self._carve_lock:
                self._carve_shapes_seen.add(shape_str(shape))
                self._carve_stats["carved" if asg is not None
                                  else "failed"] += 1
            for i in idxs:
                gang_of[i] = g
            if asg is None:
                for i in idxs:
                    ext_mask[i, :] = False
                self._carve_plans[g] = {
                    "res": res, "dims": dims, "shape": shape, "nodes": nodes,
                    "members": [pods[i] for i in idxs]}  # cell order
                continue
            gang_nodes[g] = {}
            for m, i in enumerate(idxs):
                ni = asg[m]
                row = np.zeros(Nb, bool)
                row[ni] = True
                ext_mask[i] &= row  # AND keeps an extender's veto binding
                claimed[ni] = True
                gang_nodes[g][i] = ni
        return ext_mask, gang_of, gang_nodes

    def _carve_gang_of(self, pod: Pod) -> Optional[str]:
        """Gang id of a slice pod whose carve FAILED this cycle (a plan is
        stashed), else None."""
        from kubernetes_tpu_torch.topology.slicing import GANG_LABEL
        if not self._carve_plans or self._slice_shape_of(pod) is None:
            return None
        g = (pod.metadata.labels or {}).get(GANG_LABEL) or f"pod:{pod.key}"
        return g if g in self._carve_plans else None

    @staticmethod
    def _slice_fail_message(plan: dict) -> str:
        """The slice flavor of failed_scheduling_message: "0/N origins can
        host a 2x2x4 slice: <why>" with N = candidate origins actually
        evaluated (rotations x torus cells)."""
        from kubernetes_tpu_torch.topology import carve as carve_mod
        from kubernetes_tpu_torch.topology.slicing import shape_str
        res = plan["res"]
        shape = shape_str(plan["shape"])
        want = plan["shape"][0] * plan["shape"][1] * plan["shape"][2]
        if len(plan["members"]) != want:
            return (f"0/0 origins can host a {shape} slice: gang has "
                    f"{len(plan['members'])} member(s), the shape needs "
                    f"{want}")
        if plan["dims"] is None:
            return (f"0/0 origins can host a {shape} slice: no node "
                    "carries kubernetes-tpu.io/topology-{x,y,z} labels")
        if res is None:
            return (f"0/0 origins can host a {shape} slice: no rotation "
                    f"of the shape fits the {shape_str(plan['dims'])} grid")
        sel = carve_mod.select_eviction(res)
        hint = (f"freeing the cheapest origin costs {int(sel[2])} "
                "eviction(s)" if sel is not None
                else "no origin can ever host it")
        return (f"0/{res.fits.size} origins can host a {shape} slice: "
                f"{int(res.free_grid.sum())} free cell(s) on the "
                f"{shape_str(res.dims)} torus are too fragmented; {hint}")

    def _slice_preempt_gang(self, gang: str, members: list,
                            preempt_on: bool) -> None:
        """Slice preemption: a blocked slice nominates the CHEAPEST
        CONTIGUOUS victim set — the finite-minimum origin of the carve's
        eviction plane — instead of asking the per-pod wave for N unrelated
        nodes. Victims are chosen per occupied cell with the full
        preemption machinery (PDBs, priorities, graceful victim ordering:
        sched/preemption.find_candidate restricted to that cell's node);
        free cells need no victims; any cell without a legal victim set
        abandons the whole wave — a half-freed slice helps nobody."""
        from kubernetes_tpu_torch.topology import carve as carve_mod
        plan = self._carve_plans.pop(gang, None)
        nominations: Optional[dict] = None
        if (plan is not None and preempt_on
                and any(p.spec.priority > 0 for p, _a in members)
                and len(plan["members"]) == len(members)):
            sel = carve_mod.select_eviction(plan["res"])
            if sel is not None:
                node_idxs, cells, _cost = sel
                nodes = plan["nodes"]
                cell_members = plan["members"]  # cell order
                free_grid = plan["res"].free_grid
                bound_left = self.cache.bound_pods(include_assumed=True)
                victims: list = []
                ok = True
                for m, (ni, cell) in enumerate(zip(node_idxs, cells)):
                    if free_grid[cell]:
                        continue  # free cell: nothing to evict
                    found = preemption_mod.find_candidate(
                        [nodes[ni]], bound_left,
                        self._preempt_view(cell_members[m]),
                        pdbs=self.pdb_lister(),
                        dra=self.cache.dra_catalog)
                    if found is None:
                        ok = False
                        break
                    gone = {v.key for v in found.victims}
                    bound_left = [p for p in bound_left
                                  if p.key not in gone]
                    victims.extend(found.victims)
                if ok:
                    # ONE eviction for the whole contiguous set — evict
                    # nothing unless every cell cleared
                    lead = max((p for p, _a in members),
                               key=lambda p: p.spec.priority)
                    if self._evict_victims(lead, victims):
                        with self._carve_lock:
                            self._carve_stats["slicePreempts"] += 1
                        nominations = {
                            cell_members[m].key:
                                nodes[ni].metadata.name
                            for m, ni in enumerate(node_idxs)}
        for pod, attempts in members:
            self._after_preempt(
                pod, attempts,
                None if nominations is None
                else nominations.get(pod.key))

    def topology_status(self) -> Optional[dict]:
        """Topology block for the status ConfigMap: grid extent,
        per-requested-shape carveable-origin counts + fragmentation %, and
        carve counters. Host-side numpy over the cache's lists — a status
        surface, not the carve itself, so "free" here is the defrag notion
        (a schedulable node with ZERO bound pods). None when no node
        carries coordinates."""
        from kubernetes_tpu_torch.topology import carve as carve_mod
        from kubernetes_tpu_torch.topology.slicing import (coords_of_labels,
                                                           grid_dims,
                                                           parse_shape,
                                                           shape_str)
        nodes = self.cache.list_nodes()
        coords = [coords_of_labels(n.metadata.labels) for n in nodes]
        dims = grid_dims([c for c in coords if c is not None])
        if dims is None:
            return None
        with self._carve_lock:
            shapes = sorted(self._carve_shapes_seen)
            stats = dict(self._carve_stats)
        per_node: dict[str, int] = {}
        for p in self.cache.bound_pods(include_assumed=True):
            if p.spec.node_name:
                per_node[p.spec.node_name] = (
                    per_node.get(p.spec.node_name, 0) + 1)
        free, evictable, n_pods = [], [], []
        for n in nodes:
            b = per_node.get(n.metadata.name, 0)
            sched = not n.spec.unschedulable
            free.append(sched and b == 0)
            evictable.append(sched)
            n_pods.append(b)
        out_shapes: dict[str, dict] = {}
        for s in shapes:
            res = carve_mod.numpy_grids(coords, free, evictable, n_pods,
                                        dims, parse_shape(s))
            out_shapes[s] = carve_mod.coverage_stats(res)
        return {"grid": shape_str(dims),
                "nodes": sum(1 for c in coords if c is not None),
                "freeCells": int(sum(free)),
                "shapes": out_shapes,
                "carves": stats}

    def _schedule_group(self, profile, items, slot_headroom: int = 0) -> int:
        t0 = time.time()
        pods = [p for p, _ in items]
        with TRACER.span("scheduler/snapshot", pods=len(pods)):
            nodes, ct, meta = self.cache.snapshot(pending_pods=pods,
                                                  slot_headroom=slot_headroom)
        if not nodes:
            for pod, attempts in items:
                self.queue.add_unschedulable(pod, attempts + 1)
                SCHEDULE_ATTEMPTS.inc({"result": "unschedulable"})
            return 0
        batch_keys = {p.key for p in pods}
        now = time.time()
        self._nominated = {
            k: e for k, e in self._nominated.items()
            if now - e[3] < self._nominated_ttl and not self.cache.is_bound(k)}
        entries = [(n, prio, p) for k, (n, prio, p, _ts)
                   in self._nominated.items() if k not in batch_keys]
        # nominations the snapshot is about to reserve resource-accurately
        # (overlay below); only arrivals AFTER this point need the coarse
        # assume-time re-check
        overlaid_noms = set(self._nominated)
        if entries:
            # nominees OUTSIDE this batch hold their reservation tensor-side;
            # the bucket is pinned so the batch shapes stay stable
            ct = self.cache.overlay_nominated(ct, meta, entries,
                                              min_m=DRAIN_NOM_BUCKET)
        with TRACER.span("scheduler/encode_pods", pods=len(pods)):
            # placement-time view: the profile's addedAffinity folds into
            # the encoded terms; assume/bind/requeue keep the ORIGINAL pod.
            # min_p pins the batch bucket to ONE width
            pb = self.cache.encode_pods(
                profile.apply_added_affinity(pods), meta,
                min_p=self.cfg.batch_size,
                cache_rows=not profile.added_affinity)
        ext_mask = ext_scores = None
        ext_errors: set = set()
        if self._extenders:
            from kubernetes_tpu_torch.sched.extender import run_extenders
            with TRACER.span("scheduler/extenders", pods=len(pods)):
                m, s, ext_errors = run_extenders(self._extenders, pods, nodes)
            Pb, Nb = pb.pod_valid.shape[0], ct.node_valid.shape[0]
            if m is not None:  # pad to bucket dims; padding is neutral
                ext_mask = np.ones((Pb, Nb), bool)
                ext_mask[:m.shape[0], :m.shape[1]] = m
            if s is not None:
                ext_scores = np.zeros((Pb, Nb), np.float32)
                ext_scores[:s.shape[0], :s.shape[1]] = s
            if ext_errors:
                # extender transport failure = attempt ERROR: exclude from
                # the gang batch and requeue with backoff — never feed it to
                # preemption as if the cluster had no room
                valid = np.asarray(pb.pod_valid).copy()
                for i in ext_errors:
                    valid[i] = False
                pb = pb.replace(pod_valid=valid)
        # the snapshot moves to the device ONCE: the carve and the gang
        # program read the same tensors
        ct = ct.to(self.device)
        gang_of: dict[int, str] = {}
        gang_nodes: dict[str, dict[int, int]] = {}
        if any(self._slice_shape_of(p) is not None for p in pods):
            # outside the gang program's breaker site: a carve that fails
            # on the device raises, and the oracle never carves in its
            # place (only a cycle at the breaker's oracle level does)
            with TRACER.span("scheduler/carve", pods=len(pods)):
                ext_mask, gang_of, gang_nodes = self._carve_slices(
                    items, nodes, ct, meta, pb, ext_mask)
            if gang_nodes and self.sentinel is not None and not entries:
                # parity sampling only when the snapshot had no nominee
                # overlay (the host replay can't see overlay reservations)
                self.sentinel.maybe_submit_carve(
                    nodes, self.cache.bound_pods(include_assumed=True),
                    {g: {pods[i].key: meta.node_names[ni]
                         for i, ni in picks.items()}
                     for g, picks in gang_nodes.items()},
                    [pods[i] for i in sorted(gang_of)],
                    dra=self.cache.dra_catalog,
                    level=self._attempt_level)
        serial = not self.features.enabled("TPUBatchScheduling")
        with BATCH_DURATION.time(), TRACER.span(
                "scheduler/gang_schedule", pods=len(pods),
                nodes=len(nodes)) as sp_gang:
            try:
                assignment, rounds = gang_schedule(
                    ct, pb.to(self.device),
                    seed=self.cfg.seed,
                    fit_strategy=profile.fit_strategy,
                    topo_keys=meta.topo_keys, serial=serial,
                    max_rounds=self.cfg.max_gang_rounds,
                    weights=profile.weights(),
                    enabled_filters=profile.enabled_filters,
                    ext_mask=ext_mask, ext_scores=ext_scores,
                    plugins=self._tensor_plugins(profile),
                    capture=self.capture)
            except Exception as e:
                if is_fatal(e):
                    # a kernel that does not build or launch, or a CUDA
                    # error, is not a device fault to degrade around
                    raise
                # device program failed (out of memory): feed the breaker
                # and schedule THIS batch with the pure-numpy oracle —
                # degraded, never dropped
                LOOP_ERRORS.inc({"site": "device_gang"})
                _LOG.warning("gang program failed at level %r; scheduling "
                             "the batch with the host oracle",
                             self._attempt_level, exc_info=True)
                self.breaker.fail(self._attempt_level)
                return self._schedule_oracle(profile, items)
        self.breaker.succeed(self._attempt_level)
        GANG_ROUNDS.observe(rounds)
        if sanity.check_enabled():
            for problem in sanity.check_assignment(assignment, len(nodes)):
                _LOG.error("KTPU_CHECK: %s (batch of %d)", problem, len(pods))

        # Nominations that arrived while this cycle's snapshot was in
        # flight: the snapshot could not reserve them, so winners re-check
        # against them before the assume. ONLY the mid-cycle arrivals.
        self._fold_staged_nominations()
        reserved: dict[str, int] = {}
        for k, (n, prio, _p, _ts) in self._nominated.items():
            if k not in batch_keys and k not in overlaid_noms:
                reserved[n] = max(prio, reserved.get(n, prio))

        # slice gangs bind all-or-nothing: the carve pinned each member to
        # its cell, so ANY member the program (or the reservation shield
        # below) refuses fails the WHOLE gang this cycle — no partial
        # assume ever reaches the cache
        gang_ok: dict[str, bool] = {}
        for i, g in gang_of.items():
            pod = items[i][0]
            a = int(assignment[i]) if i < len(items) else -1
            ok = a >= 0 and gang_nodes.get(g, {}).get(i) == a
            if ok:
                rp = reserved.get(meta.node_names[a])
                ok = rp is None or rp < pod.spec.priority
            gang_ok[g] = gang_ok.get(g, True) and ok

        n_bound = n_err = n_unsched = 0
        to_bind: list[tuple[Pod, str]] = []
        failures: list[tuple[Pod, int]] = []
        dt = time.time() - t0
        for i, ((pod, attempts), a) in enumerate(
                zip(items, assignment[:len(items)])):
            if i in ext_errors:
                self.queue.add_unschedulable(pod, attempts + 1)
                n_err += 1
                continue
            g = gang_of.get(i)
            if g is not None and not gang_ok.get(g, False):
                failures.append((pod, attempts))
                n_unsched += 1
                continue
            if a >= 0:
                node_name = meta.node_names[int(a)]
                rp = reserved.get(node_name)
                # >=: equal-priority nominees shield too, matching the
                # device-side fit_mask (prio_s >= pb.priority)
                if rp is not None and rp >= pod.spec.priority:
                    failures.append((pod, attempts))
                    n_unsched += 1
                    continue
                self._nominated.pop(pod.key, None)
                self.cache.assume(pod, node_name)
                to_bind.append((pod, node_name))
                n_bound += 1
            else:
                failures.append((pod, attempts))
                n_unsched += 1
        if FLIGHT.enabled:
            for pod, _a in items:
                FLIGHT.record(pod.key, "dispatch", span=sp_gang)
            for pod, _n in to_bind:
                FLIGHT.record(pod.key, "resolve", span=sp_gang)
        self._handle_failures(failures)
        self._bind_async_batch(to_bind, profile)
        # every pod in the batch shares one cycle's wall time
        for result, n in (("scheduled", n_bound), ("error", n_err),
                          ("unschedulable", n_unsched)):
            if n:
                SCHEDULE_ATTEMPTS.inc({"result": result}, by=n)
                ATTEMPT_DURATION.observe(dt, {"result": result}, n=n)
        return n_bound

    def _schedule_drain(self, profile, items, slot_headroom: int = 0) -> int:
        """Deep-backlog path: the whole pop in ONE ``drain_step`` over a
        DEVICE-RESIDENT cluster encoding.

        The cluster tensors stay on the card (``_drain_ctx``), each drain
        ships only the new pod batches, and ``drain_step`` folds what it
        commits into free existing-pod slots. Foreign changes — node churn,
        pod deletes, rebinds, preemption nominees — are replayed from the
        cache's delta log as DEVICE-SIDE PATCHES (encode/patch.py) before
        or inside the next dispatch; the context rebuilds from a host
        snapshot only when a delta doesn't fit the resident buckets."""
        from kubernetes_tpu_torch.encode.patch import (entries_all_folded,
                                                       entries_fold_safe,
                                                       fork_meta,
                                                       sync_resident_widths)
        from kubernetes_tpu_torch.models.gang import (
            adopt_storage, apply_ctx_patch, batch_shapes, build_drain_context,
            drain_step, drain_widths_fit, pad_batch_to, stack_batches,
            unify_batches)
        from kubernetes_tpu_torch.sched.staging import ResidentShadow
        t0 = time.time()
        self._cyc_marks = []  # fresh debug trail per cycle (cycle_log)
        pods = [p for p, _ in items]
        batch_keys = {p.key for p in pods}
        now = time.time()
        self._nominated = {
            k: e for k, e in self._nominated.items()
            if now - e[3] < self._nominated_ttl and not self.cache.is_bound(k)}
        # desired resident reservation set: nominees NOT in this pop (a
        # nominee scheduling itself must not be blocked by its own hold)
        nom_target = {k: (n, prio, p) for k, (n, prio, p, _ts)
                      in self._nominated.items() if k not in batch_keys}

        ctx = self._drain_ctx
        old_ct = None       # the context a rebuild replaces
        use_ctx = False
        fused_patch = None  # churn deltas riding THIS dispatch (fused fold)
        n_prev = 0
        if ctx is not None and ctx["profile"] == profile.scheduler_name:
            cs = ctx["cs"]
            known = set(ctx["meta"].resources)
            fits = (not cs.tainted
                    and ctx["fill_bound"] + len(pods) <= cs.top
                    and not any(r not in known for p in pods
                                for r in p.resource_requests()))
            if not fits:
                self._ctx_reason("tainted" if cs.tainted else "capacity")
            else:
                entries = self.cache.deltas_since(ctx["seq"])
                nom_dirty = (set(nom_target) != set(cs.nom_applied)
                             or any(cs.nom_applied[k][1:] != (n, prio)
                                    for k, (n, prio, _p)
                                    in nom_target.items()
                                    if k in cs.nom_applied))
                if entries is None:
                    self._ctx_reason("log_window")
                elif not nom_dirty and entries_all_folded(cs, entries):
                    # Every entry is an assume of a placement this context
                    # already folded device-side (our own resolves): advance
                    # the cursor and dispatch WITHOUT draining the pipeline.
                    if entries:
                        ctx["seq"] = entries[-1][0] + 1
                    use_ctx = True
                else:
                    # Foreign churn / nominee change. Fused-fold mode
                    # compiles the patch against the LIVE patch state and
                    # ships it as the drain's patch input — the pipeline
                    # drains first only when a delta depends on an
                    # in-flight drain's unmirrored folds
                    # (encode/patch.py entries_fold_safe). Legacy mode
                    # resolves everything and applies a separate patch.
                    if self._pending and not (
                            self._fused_fold and entries_fold_safe(
                                cs, entries,
                                {p.key for pend in self._pending
                                 for c in pend["chunks"] for p, _ in c})):
                        if self.cycle_log is not None:
                            self._cyc_marks.append(("resolve_prev_start",
                                                    round(time.time() - t0,
                                                          3)))
                        n_prev += self._resolve_pending()
                        if self.cycle_log is not None:
                            self._cyc_marks.append(
                                ("resolve_prev_end",
                                 round(time.time() - t0, 3)))
                        entries = self.cache.deltas_since(ctx["seq"])
                    if entries is not None:
                        new_seq = (entries[-1][0] + 1 if entries
                                   else ctx["seq"])
                        # host-side half of the fold: delta log -> static
                        # shape scatter arrays. fold_floor pins the patch
                        # allocator above the DISPATCH-side fill reservation
                        # so a patch compiled with drains still in flight
                        # can never hand out a slot an unresolved fold takes.
                        with TRACER.span("scheduler/fold_deltas",
                                         deltas=len(entries)):
                            patch = self.cache.compile_ctx_patch(
                                ctx["meta"], cs, entries, nom_target,
                                DRAIN_NOM_BUCKET,
                                fold_floor=ctx["fill_bound"])
                        # the patch may have moved the slot cursor: the fold
                        # region this dispatch writes must still clear every
                        # patched slot (re-check AFTER compile; on failure
                        # the context is discarded and rebuilt)
                        if (patch is not None
                                and ctx["fill_bound"] + len(pods)
                                <= cs.top):
                            shadow = ctx.get("shadow")
                            if shadow is not None:
                                # mirror the requested/allocatable writes
                                # host-side; pending winner folds flush
                                # FIRST (ResidentShadow.apply_patch)
                                shadow.catch_up(
                                    lambda p: self.cache.request_vector(
                                        p, cs.resources))
                                shadow.apply_patch(patch)
                            if self._fused_fold:
                                fused_patch = patch
                                self.ctx_stats["folds"] += 1
                            else:
                                with TRACER.span("scheduler/ctx_patch_apply"):
                                    ctx["ct"] = apply_ctx_patch(
                                        ctx["ct"],
                                        self.cache.stage_patch(patch))
                                self.ctx_stats["patches"] += 1
                            ctx["seq"] = new_seq
                            use_ctx = True
                        elif patch is None:
                            self.ctx_stats["unfit"] += 1
                            self._ctx_reason("patch_unfit")
                        else:
                            self._ctx_reason("capacity")
        if use_ctx:
            nodes, meta = ctx["nodes"], ctx["meta"]
        else:
            # the in-flight drain's placements must land in the cache before
            # a host snapshot, or the re-encode double-books their capacity
            n_prev += self._resolve_pending()
            if self._drain_ctx is not None:
                old_ct = self._drain_ctx["ct"]
            self._drain_ctx = None
            with TRACER.span("scheduler/snapshot", pods=len(pods)):
                nodes, ct, meta = self.cache.snapshot(
                    pending_pods=pods, slot_headroom=slot_headroom)
            seq0 = self.cache.last_snapshot_seq()
            if not nodes:
                for pod, attempts in items:
                    self.queue.add_unschedulable(pod, attempts + 1)
                    SCHEDULE_ATTEMPTS.inc({"result": "unschedulable"})
                return n_prev

        P = self.cfg.batch_size
        if self.cycle_log is not None:
            self._cyc_marks.append(("encode_start",
                                    round(time.time() - t0, 3)))
        chunks = self._tenant_chunks(items, P)
        with TRACER.span("scheduler/encode_pods", pods=len(pods)) as sp_enc:
            pbs = [self.cache.encode_pods(
                profile.apply_added_affinity([p for p, _ in c]),
                meta, min_p=P,
                cache_rows=not profile.added_affinity) for c in chunks]
        if FLIGHT.enabled:
            for pod, _a in items:
                FLIGHT.record(pod.key, "drain_fill", span=sp_enc)
        # pad to the fixed drain width with all-invalid batches (their pods
        # propose nothing; each converges in one dead round)
        B = max(1, self.cfg.max_drain_batches)
        while len(pbs) < B:
            pad = pbs[-1]
            pbs.append(pad.replace(
                pod_valid=np.zeros_like(np.asarray(pad.pod_valid))))
        pb_stack = stack_batches(unify_batches(pbs))

        if not use_ctx:
            built = build_drain_context(ct, pbs, nom_bucket=DRAIN_NOM_BUCKET,
                                        device=self.device)
            cs = self.cache.patch_state_fork()
            if built is None or cs is None:
                # base slots not packed (host patches left holes): run the
                # host per-batch path this cycle
                self._drain_ctx = None
                return n_prev + sum(
                    self._schedule_group(profile, c, slot_headroom)
                    for c in chunks)
            ct_dev, e0, fill = built
            # a rebuild at the old shapes takes the old context's storage:
            # the graphs of the rounds, keyed on its addresses, stay valid
            # (nothing in flight refers to it: _resolve_pending ran)
            ct_dev = adopt_storage(old_ct, ct_dev)
            sync_resident_widths(cs, ct_dev)
            self.ctx_stats["rebuilds"] += 1
            self._ctx_epoch += 1
            ctx = {"ct": ct_dev, "e0": e0, "epoch": self._ctx_epoch,
                   "fill_dev": self._stage_fill(fill),
                   "fill_bound": fill, "meta": fork_meta(meta),
                   "nodes": nodes, "cs": cs, "seq": seq0,
                   "pb_shape": batch_shapes(pb_stack),
                   "profile": profile.scheduler_name,
                   # host mirror of the resident [N,R] totals, cut from the
                   # SAME host encoding the context staged (its own copies)
                   "shadow": ResidentShadow(ct.allocatable, ct.requested)}
            meta = ctx["meta"]
            if nom_target:
                patch = self.cache.compile_ctx_patch(
                    meta, cs, [], nom_target, DRAIN_NOM_BUCKET)
                if patch is None:
                    # reservation set exceeds the resident bucket: keep
                    # semantics via the per-batch overlay path this cycle
                    return n_prev + sum(
                        self._schedule_group(profile, c, slot_headroom)
                        for c in chunks)
                ctx["shadow"].apply_patch(patch)
                ctx["ct"] = apply_ctx_patch(ctx["ct"],
                                            self.cache.stage_patch(patch))
            self._drain_ctx = ctx
        else:
            # pin the batch to the context's shapes: pop-dependent bucket
            # widths would otherwise change the resident extension rows
            padded = pad_batch_to(pb_stack, ctx["pb_shape"])
            if padded is None or not drain_widths_fit(ctx["ct"], padded):
                # wider than the context: rebuild it
                self._ctx_reason("batch_shape")
                n_prev += self._resolve_pending()
                self._drain_ctx = None
                return n_prev + self._schedule_drain(profile, items,
                                                     slot_headroom)
            pb_stack = padded

        # hand the FINAL stacked batch to the staging arena now: the stager
        # copies it while this thread finishes the cycle's remaining host
        # work — the dispatch below then swaps buffers
        stage_ticket = self.cache.stage_submit(pb_stack)
        # parity sentinel: on sampled dispatches capture the host views the
        # resident encoding mirrors (consistent here — the ctx's log cursor
        # was settled on this thread moments ago; anything newer is carried
        # as the exempt set). Winners of still-in-flight drains resolve
        # before this one, so their placements are collected at resolve.
        parity_cap = None
        if self.sentinel is not None and not self._extenders:
            parity_cap = self.sentinel.maybe_capture_drain(
                self.cache, profile, self._attempt_level, ctx["seq"])
            if parity_cap is not None:
                parity_cap["prior"] = list(self._pending)
        if self.cycle_log is not None:
            self._cyc_marks.append(("dispatch_start",
                                    round(time.time() - t0, 3)))
        pb_staged = self._stage_batch(pb_stack, stage_ticket, len(pods))
        if fused_patch is not None:
            fused_patch = self.cache.stage_patch(fused_patch)
        with TRACER.span("scheduler/gang_dispatch",
                         pods=len(pods), nodes=len(nodes),
                         depth=len(self._pending) + 1) as sp_disp:
            try:
                assignments, rounds, new_ct, new_fill = drain_step(
                    ctx["ct"], pb_staged,
                    ctx["fill_dev"], fused_patch, e0=ctx["e0"],
                    seed=self.cfg.seed, fit_strategy=profile.fit_strategy,
                    topo_keys=meta.topo_keys,
                    weights=tuple(sorted(profile.weights().items())),
                    enabled_filters=tuple(
                        sorted(profile.enabled_filters or ())),
                    max_rounds=self.cfg.max_gang_rounds,
                    plugins=self._tensor_plugins(profile),
                    capture=self.capture)
            except Exception as e:
                if is_fatal(e):
                    # never degraded around (see _schedule_group); the
                    # context may be half-updated in place, so it goes with
                    # the error
                    self._drain_ctx = None
                    raise
                # the drain failed: the resident context's device state is
                # unaccountable (it is updated in place) — drop it, land
                # whatever is still in flight, and schedule this pop on the
                # per-batch path (which itself degrades to the oracle if the
                # device stays broken)
                LOOP_ERRORS.inc({"site": "device_drain"})
                _LOG.warning("drain dispatch failed at level %r; falling "
                             "back to the per-batch path",
                             self._attempt_level, exc_info=True)
                self.breaker.fail(self._attempt_level)
                self._drain_ctx = None
                n_prev += self._resolve_pending()
                return n_prev + sum(
                    self._schedule_group(profile, c, slot_headroom)
                    for c in chunks)
        ctx["ct"] = new_ct
        ctx["fill_dev"] = new_fill
        ctx["fill_bound"] += len(pods)
        pend = {
            "assignments": assignments, "rounds": rounds,
            "chunks": chunks, "ctx": ctx,
            "meta": meta, "n_nodes": len(nodes), "profile": profile,
            "t0": t0,
            # breaker attribution: the level THIS drain was dispatched at
            # and the dispatch time on the BREAKER's clock
            "level": self._attempt_level,
            "dispatched_at": self.breaker.clock.now(),
            # nominations the dispatched program already respects; resolve
            # re-checks winners only against later ones
            "nom_keys": set(nom_target),
        }
        if parity_cap is not None:
            pend["parity"] = parity_cap
        if FLIGHT.enabled:
            for pod, _a in items:
                FLIGHT.record(pod.key, "dispatch", span=sp_disp)
        if self.cycle_log is not None:
            marks = dict(self._cyc_marks)
            marks["done"] = round(time.time() - t0, 3)
            pend["cyc"] = (len(pods), t0, marks)
        self._submit_resolve(pend)
        self._pending.append(pend)
        PIPELINE_DEPTH.observe(len(self._pending))
        PIPELINE_INFLIGHT.set(len(self._pending))
        # land whatever already finished, then enforce the depth bound: the
        # oldest drain resolves (blocking) only once MORE than
        # cfg.pipeline_depth drains are in flight
        n_prev += self._resolve_ready()
        while len(self._pending) > max(1, self.cfg.pipeline_depth):
            n_prev += self._resolve_one()
        return n_prev

    def _ctx_reason(self, why: str):
        r = self.ctx_stats["reasons"]
        r[why] = r.get(why, 0) + 1

    def _resolve_pending(self) -> int:
        """Drain the WHOLE dispatch pipeline, oldest first, and apply the
        results host-side. Returns pods bound."""
        n = 0
        while self._pending:
            n += self._resolve_one()
        return n

    def _resolve_one(self) -> int:
        """Wait for the OLDEST in-flight drain's results and apply them
        host-side: assume + bulk-bind the placements, requeue the failures,
        and record the device folds in the context's patch state (the fold
        packs committed pods into base slots [fill, fill+n) in flattened
        batch order — mirrored here so later churn patches can address
        them). Reads no tensor of the context. Returns pods bound."""
        if not self._pending:
            return 0
        pend = self._pending.popleft()
        PIPELINE_INFLIGHT.set(len(self._pending))
        if self.cycle_log is not None and "cyc" in pend:
            n, tp, marks = pend["cyc"]
            marks["resolve_at"] = round(time.time() - tp, 3)
            self.cycle_log.append((n, round(tp, 3), marks))
        t_wait = time.time()
        fetch_failed = False
        with BATCH_DURATION.time(), TRACER.span(
                "scheduler/resolve_wait",
                depth=len(self._pending) + 1) as sp_res:
            done = pend.get("done")
            res = None
            if done is not None:
                # the resolver thread owns the fetch; this thread parks on a
                # plain Event — BOUNDED: a dead or stalled resolver degrades
                # to an inline fetch instead of hanging the loop
                deadline = time.time() + RESOLVE_WAIT_S
                while not done.wait(0.25):
                    t = self._resolver_thread  # ktpu-lint: disable=KTL001 -- lock-free liveness peek: a stale handle costs one redundant 0.25s wait round, never a wrong resolve
                    dead = t is not None and not t.is_alive()
                    if dead or time.time() > deadline:
                        LOOP_ERRORS.inc({"site": "resolver_wait"})
                        _LOG.warning(
                            "drain resolver %s; fetching inline",
                            "died" if dead
                            else f"silent for {RESOLVE_WAIT_S:.0f}s")
                        break
                res = pend.pop("resolved", None)
                if "fault" in pend:
                    raise pend["fault"]
            if res is None:  # resolver off/stalled or its fetch failed
                try:
                    res = self._fetch(pend)
                except Exception as e:
                    if is_fatal(e):
                        raise
                    fetch_failed = True
                    LOOP_ERRORS.inc({"site": "drain_resolve"})
                    _LOG.exception("drain results unrecoverable; "
                                   "requeueing the drain's pods")
            if not fetch_failed:
                assignments, rounds = res
        if fetch_failed:
            # the drain's winners are lost: requeue every pod (the cache
            # never assumed them), release the fold reservation, and taint
            # the resident context — the device-side fold state is unknown
            self.breaker.fail(pend.get("level", self._attempt_level))
            ctx = pend["ctx"]
            pend_count = sum(len(c) for c in pend["chunks"])
            if self._drain_ctx is ctx:
                ctx["cs"].tainted = True
                ctx["fill_bound"] -= pend_count
            for chunk in pend["chunks"]:
                for pod, attempts in chunk:
                    if not self.cache.is_bound(pod.key):
                        self.queue.add_unschedulable(pod, attempts + 1)
            SCHEDULE_ATTEMPTS.inc({"result": "error"}, by=pend_count)
            return 0
        # results landed: the breaker's success signal for the drain path,
        # attributed to the level and time the drain was DISPATCHED at
        self.breaker.succeed(pend.get("level", self._attempt_level),
                             dispatched_at=pend.get("dispatched_at"))
        wait_ms = round((time.time() - t_wait) * 1000.0, 3)
        RESOLVE_BYTES.set(assignments.nbytes + rounds.nbytes)
        DRAIN_SHARD_MS.set(wait_ms)
        ctx, meta, profile = pend["ctx"], pend["meta"], pend["profile"]
        active = self._drain_ctx is ctx
        pend_count = sum(len(c) for c in pend["chunks"])
        GANG_ROUNDS.observe(int(np.sum(rounds)))
        # nominations that arrived while this drain was in flight: the
        # dispatched program could not reserve them, so winners re-check
        # here — same contract as _schedule_group's assume-time re-check
        self._fold_staged_nominations()
        fresh: dict[str, int] = {}
        if self._nominated:
            known = pend.get("nom_keys", set())
            drain_keys = {pod.key for chunk in pend["chunks"]
                          for pod, _ in chunk}
            for k, (n, prio, _p, _ts) in self._nominated.items():
                if k not in known and k not in drain_keys:
                    fresh[n] = max(prio, fresh.get(n, prio))
        lost_races = 0
        to_bind: list[tuple[Pod, str]] = []
        bound_rows: list[int] = []  # node index per to_bind entry
        failures: list[tuple[Pod, int]] = []
        with TRACER.span("scheduler/apply"):
            for b, chunk in enumerate(pend["chunks"]):
                assignment = assignments[b]
                if sanity.check_enabled():
                    for problem in sanity.check_assignment(
                            assignment, pend["n_nodes"]):
                        _LOG.error("KTPU_CHECK: %s (drain chunk %d)",
                                   problem, b)
                node_names = meta.node_names
                for (pod, attempts), a in zip(chunk,
                                              assignment[:len(chunk)]):
                    if a >= 0:
                        node_name = node_names[int(a)]
                        rp = fresh.get(node_name)
                        if rp is not None and rp >= pod.spec.priority:
                            failures.append((pod, attempts))
                            lost_races += 1
                            continue
                        to_bind.append((pod, node_name))
                        bound_rows.append(int(a))
                    else:
                        failures.append((pod, attempts))
            if lost_races and active:
                # the device fold already committed the rejected winners
                # into the resident encoding: it is now approximate —
                # rebuild at next dispatch
                ctx["cs"].tainted = True
            if to_bind:
                # one lock pass for the whole drain's winners; failures are
                # handled AFTER
                self.cache.assume_many(to_bind)
                nominated = self._nominated
                if active:
                    # mirror the device fold: winners occupy base slots
                    # [fill_host, fill_host+n) in this exact order. slot_req
                    # stores the Pod itself — the request vector is computed
                    # lazily only if the pod is later deleted/rebound.
                    cs = ctx["cs"]
                    fill = cs.fill_host
                    for (pod, node), row in zip(to_bind, bound_rows):
                        cs.slot_of[pod.key] = fill
                        cs.slot_node[pod.key] = row
                        cs.slot_req[pod.key] = pod
                        cs.row_pods[row] = cs.row_pods.get(row, 0) + 1
                        cs.folded[pod.key] = node
                        fill += 1
                        if pod.spec.volumes or pod.host_ports():
                            # the fold cannot reproduce this pod's node-side
                            # port/volume state: rebuild at next dispatch
                            cs.tainted = True
                    cs.fill_host = fill
                    shadow = ctx.get("shadow")
                    if shadow is not None:
                        shadow.fold_winners(
                            [(pod, row) for (pod, _n), row
                             in zip(to_bind, bound_rows)])
                for pod, _node in to_bind:
                    if nominated:
                        nominated.pop(pod.key, None)
        # every resolved drain records its winners: a later sampled drain's
        # parity check needs the placements of the drains that were in
        # flight when it dispatched (the device fold already counted them)
        pend["winners"] = list(to_bind)
        cap = pend.get("parity")
        if cap is not None and self.sentinel is not None:
            prior = [w for pp in cap.pop("prior", ())
                     for w in pp.get("winners", ())]
            self.sentinel.submit_drain(cap, list(to_bind), prior)
        n_bound = len(to_bind)
        n_unsched = len(failures)
        if FLIGHT.enabled:
            for pod, _n in to_bind:
                FLIGHT.record(pod.key, "resolve", span=sp_res)
            for pod, _a in failures:
                FLIGHT.record(pod.key, "resolve", span=sp_res)
        self._handle_failures(failures)
        # fill_bound is ADJUSTED, never overwritten: drains dispatched after
        # this one already reserved their own += len(pods) on top, so only
        # this drain's unused reservation (pend_count - n_bound) is released
        if active and self._drain_ctx is ctx:
            ctx["fill_bound"] -= (pend_count - n_bound)
        self._bind_async_batch(to_bind, profile)
        dt = time.time() - pend["t0"]
        for result, n in (("scheduled", n_bound),
                          ("unschedulable", n_unsched)):
            if n:
                SCHEDULE_ATTEMPTS.inc({"result": result}, by=n)
                ATTEMPT_DURATION.observe(dt, {"result": result}, n=n)
        return n_bound

    def warm_drain(self, sample_pods: list, slot_headroom: int) -> bool:
        """The warm ladder: run the drain at the shapes a representative
        workload will use and stage the device-resident cluster context;
        benchmarks call it so the measured window is steady-state. The
        first call builds the card's kernels (or loads them from the
        durable cache, sched/aotcache.py), and the first drain_step
        captures the CUDA graphs of the rounds at the drain's bucketed
        shape, one per batch slot (models/graphs.py), where the
        reference's ladder compiles drain_step; the fused-patch drain that
        follows replays them. The warm-up drains run on a context whose
        content is thrown away: drain_step updates it in place, so the
        kept context is built afterwards from the host encoding and
        written into the same storage, where the graphs read it.
        ``self.warm_stats`` reports the ladder's captures, builds and
        seconds. Returns True when the context is armed."""
        from kubernetes_tpu_torch.encode.patch import (fork_meta,
                                                       sync_resident_widths)
        from kubernetes_tpu_torch.models.gang import (
            adopt_storage, apply_ctx_patch, batch_shapes, build_drain_context,
            drain_step, stack_batches, unify_batches)
        from kubernetes_tpu_torch.models import graphs
        from kubernetes_tpu_torch.ops import kernels
        from kubernetes_tpu_torch.sched.staging import ResidentShadow
        if not sample_pods:
            return False
        t_ladder = time.perf_counter()
        builds0, captures0 = kernels.BUILDS, graphs.CAPTURES
        profile = self.cfg.profile_for(sample_pods[0].spec.scheduler_name)
        if profile is None:
            return False
        B, P = max(1, self.cfg.max_drain_batches), self.cfg.batch_size
        nodes, ct, meta = self.cache.snapshot(
            pending_pods=sample_pods[:P], slot_headroom=slot_headroom)
        if not nodes:
            return False
        chunks = [sample_pods[i * P:(i + 1) * P] or sample_pods[:P]
                  for i in range(B)]
        pbs = [self.cache.encode_pods(profile.apply_added_affinity(c),
                                      meta, min_p=P,
                                      cache_rows=not profile.added_affinity)
               for c in chunks]
        pb_stack = stack_batches(unify_batches(pbs))
        built = build_drain_context(ct, pbs, nom_bucket=DRAIN_NOM_BUCKET,
                                    device=self.device)
        if built is None:
            return False
        ct_warm, e0, fill = built
        kw = dict(e0=e0, seed=self.cfg.seed,
                  fit_strategy=profile.fit_strategy,
                  topo_keys=meta.topo_keys,
                  weights=tuple(sorted(profile.weights().items())),
                  enabled_filters=tuple(sorted(profile.enabled_filters or ())),
                  max_rounds=self.cfg.max_gang_rounds,
                  plugins=self._tensor_plugins(profile),
                  capture=self.capture)
        # the SAME staging path (and spans) the live dispatch uses — warms
        # the stager thread and the pinned buffers
        pb_staged = self._stage_batch(
            pb_stack, self.cache.stage_submit(pb_stack), len(sample_pods))
        _, _, ct_warm, fill2 = drain_step(ct_warm, pb_staged,
                                          self._stage_fill(fill), **kw)
        # rehearse the churn programs on the throwaway context: the fused
        # drain (patch input) in fused mode, the standalone apply_ctx_patch
        # in both (it stages rebuild-time nominee reservations)
        try:
            cs_warm = self.cache.patch_state_fork()
            if cs_warm is not None:
                # compiled at the throwaway context's widths, as the live
                # path compiles at the resident ones
                sync_resident_widths(cs_warm, ct_warm)
                warm_patch = self.cache.stage_patch(
                    self.cache.compile_ctx_patch(
                        fork_meta(meta), cs_warm, [], {},
                        DRAIN_NOM_BUCKET))
                if warm_patch is not None and self._fused_fold:
                    drain_step(ct_warm, pb_staged, fill2, warm_patch, **kw)
                    apply_ctx_patch(ct_warm, warm_patch)
                elif warm_patch is not None:
                    apply_ctx_patch(ct_warm, warm_patch)
                    drain_step(ct_warm, pb_staged, fill2, **kw)
        except Exception as e:
            if is_fatal(e):
                raise
            _LOG.exception("patch-program warmup failed (non-fatal)")
        built = build_drain_context(ct, pbs, nom_bucket=DRAIN_NOM_BUCKET,
                                    device=self.device)
        cs = self.cache.patch_state_fork()
        if built is None or cs is None:
            return False
        ct_dev, e0, fill = built
        ct_dev = adopt_storage(ct_warm, ct_dev)
        del ct_warm
        sync_resident_widths(cs, ct_dev)
        if self.device.type == "cuda":
            # the context upload is queued on the stream: wait for it, so
            # the first real drain does not pay it inside the window
            torch.cuda.synchronize(self.device)
        self.warm_stats = {
            "seconds": time.perf_counter() - t_ladder,
            "builds": kernels.BUILDS - builds0,
            "captures": graphs.CAPTURES - captures0}
        self._ctx_epoch += 1
        self._drain_ctx = {"ct": ct_dev, "e0": e0, "epoch": self._ctx_epoch,
                           "fill_dev": self._stage_fill(fill),
                           "fill_bound": fill,
                           "meta": fork_meta(meta), "nodes": nodes,
                           "cs": cs,
                           "seq": self.cache.last_snapshot_seq(),
                           "pb_shape": batch_shapes(pb_stack),
                           "profile": profile.scheduler_name,
                           "shadow": ResidentShadow(ct.allocatable,
                                                    ct.requested)}
        return True

    # ---- degraded floor: pure-numpy oracle scheduling --------------------

    def _schedule_oracle(self, profile, items) -> int:
        """Degrade-don't-die floor: schedule a batch with the serial
        pure-numpy oracle (sched/oracle.py). Orders of magnitude slower
        than the tensor programs, but device-free and exactly
        parity-tested against them — the breaker routes here when the
        device layer is broken so a scheduling cycle is never dropped."""
        from kubernetes_tpu_torch.sched.oracle import OracleScheduler
        vetoes = [p.name for p in self._tensor_plugins(profile)
                  if p.filter_fn is not None]
        if self._extenders or vetoes:
            # an extender's filter veto is authoritative (it guards state
            # the scheduler cannot see — storage capacity, license seats),
            # and so is an out-of-tree tensor filter's (the reference's
            # oracle binds past it); the oracle can consult neither, and
            # binding past a veto is worse than waiting one backoff for
            # the device (or the operator) to come back
            _LOG.warning("degraded to oracle but %d extender(s) and tensor "
                         "filter plugin(s) %s are configured: requeueing %d "
                         "pods instead of bypassing their filters",
                         len(self._extenders), vetoes, len(items))
            for pod, attempts in items:
                self.queue.add_unschedulable(pod, attempts + 1)
                SCHEDULE_ATTEMPTS.inc({"result": "unschedulable"})
            return 0
        # one span per oracle batch: a run counts the pods that left the
        # card from these
        with TRACER.span("scheduler/oracle", pods=len(items)):
            t0 = time.time()
            nodes = self.cache.list_nodes()
            if not nodes:
                for pod, attempts in items:
                    self.queue.add_unschedulable(pod, attempts + 1)
                    SCHEDULE_ATTEMPTS.inc({"result": "unschedulable"})
                return 0
            orc = OracleScheduler(
                nodes, bound_pods=self.cache.bound_pods(include_assumed=True),
                weights=profile.weights(), seed=self.cfg.seed,
                volumes=self.cache.volume_catalog,
                namespace_labels=self.cache.namespace_labels(),
                dra=self.cache.dra_catalog)
            pods = profile.apply_added_affinity([p for p, _ in items])
            # the oracle's assume() writes node_name onto what it schedules:
            # give it detached views so a failed bind can requeue the ORIGINAL
            # pod unbound
            views = [dataclasses.replace(p, spec=dataclasses.replace(p.spec))
                     for p in pods]
            placed = orc.schedule_all(views)
            # same assume-time nomination re-check as the tensor paths; the
            # prune matters here too (in a long oracle window this is the only
            # path running)
            self._fold_staged_nominations()
            now = time.time()
            self._nominated = {
                k: e for k, e in self._nominated.items()
                if now - e[3] < self._nominated_ttl
                and not self.cache.is_bound(k)}
            batch_keys = {p.key for p, _ in items}
            reserved: dict[str, int] = {}
            for k, (n, prio, _p, _ts) in self._nominated.items():
                if k not in batch_keys:
                    reserved[n] = max(prio, reserved.get(n, prio))
            n_bound = n_unsched = 0
            to_bind: list[tuple[Pod, str]] = []
            failures: list[tuple[Pod, int]] = []
            for (pod, attempts), ni in zip(items, placed):
                if ni is None:
                    failures.append((pod, attempts))
                    n_unsched += 1
                    continue
                node_name = nodes[ni].metadata.name
                rp = reserved.get(node_name)
                if rp is not None and rp >= pod.spec.priority:
                    failures.append((pod, attempts))
                    n_unsched += 1
                    continue
                self._nominated.pop(pod.key, None)
                self.cache.assume(pod, node_name)
                to_bind.append((pod, node_name))
                n_bound += 1
            if FLIGHT.enabled:
                for pod, _n in to_bind:
                    FLIGHT.record(pod.key, "resolve", mode="oracle")
            self._handle_failures(failures)
            self._bind_async_batch(to_bind, profile)
            dt = time.time() - t0
            for result, n in (("scheduled", n_bound),
                              ("unschedulable", n_unsched)):
                if n:
                    SCHEDULE_ATTEMPTS.inc({"result": result}, by=n)
                    ATTEMPT_DURATION.observe(dt, {"result": result}, n=n)
            return n_bound

    # ---- failure path: PostFilter / preemption ---------------------------

    def _handle_failures(self, failures: list[tuple[Pod, int]]):
        """Failure path for a whole batch: a failed-carve slice gang
        preempts as one contiguous victim set; other preemption-eligible
        pods go to the preemptor (an injected one, or a lone pod, one at a
        time; else one default preemption wave), the rest requeue with
        backoff.
        (Metrics for the unschedulable result are batched by the caller.)"""
        preemptable: list[tuple[Pod, int]] = []
        preempt_on = self.features.enabled("PreemptionSimulation")
        unschedulable: list[Pod] = []
        slice_gangs: dict[str, list[tuple[Pod, int]]] = {}
        for pod, attempts in failures:
            if self.cache.is_bound(pod.key):
                # Bound by another party while in-flight: requeueing would
                # cycle it through backoffQ forever. No FailedScheduling
                # event either: the pod IS scheduled.
                continue
            unschedulable.append(pod)
            g = self._carve_gang_of(pod)
            if g is not None:
                # failed-carve slice members: the whole gang preempts as
                # one contiguous victim set (below), never as per-pod
                # wave entries chasing unrelated nodes
                slice_gangs.setdefault(g, []).append((pod, attempts))
            elif pod.spec.priority > 0 and preempt_on:
                preemptable.append((pod, attempts))
            else:
                self._after_preempt(pod, attempts, None)
        self._emit_failed_scheduling(unschedulable)
        for g, gang_members in sorted(slice_gangs.items()):
            self._slice_preempt_gang(g, gang_members, preempt_on)
        if not preemptable:
            return
        if self._custom_preemptor or len(preemptable) == 1:
            # injected preemptors keep the one-pod contract
            for pod, attempts in preemptable:
                self._after_preempt(pod, attempts, self.preemptor(pod))
        else:
            nominations = self._default_preempt_wave(
                [p for p, _ in preemptable])
            for (pod, attempts), node in zip(preemptable, nominations):
                self._after_preempt(pod, attempts, node)

    def _emit_failed_scheduling(self, pods: list[Pod]) -> None:
        """FailedScheduling events for one cycle's unschedulable pods. The
        explainer owns them when it accepts the capture (its verdict is the
        upstream-style per-filter message); the generic single-line event
        remains the fallback for pods it refused (backlog full, disabled).
        Failed-carve slice members get the carve's own verdict instead."""
        if not pods:
            return
        if self._carve_plans:
            # failed-carve slice members get the carve's own verdict — the
            # per-node explainer cannot say "the free nodes don't compose
            # into a 2x2x4 box"; the stashed score planes can
            remaining: list[Pod] = []
            for pod in pods:
                g = self._carve_gang_of(pod)
                if g is not None:
                    plan = self._carve_plans[g]
                    msg = self._slice_fail_message(plan)
                    self.recorder.event(
                        pod, "Warning", "FailedScheduling", msg)
                    if self.explainer is not None:
                        # the carve verdict goes into the explanations
                        # ConfigMap too (event emission stays here)
                        self.explainer.submit_direct(
                            pod, msg,
                            {"SliceCarve": len(plan["nodes"])},
                            len(plan["nodes"]),
                            profile=pod.spec.scheduler_name)
                else:
                    remaining.append(pod)
            pods = remaining
            if not pods:
                return
        leftovers = pods
        if self.explainer is not None:
            by_prof: dict[str, list[Pod]] = {}
            for p in pods:
                by_prof.setdefault(p.spec.scheduler_name, []).append(p)
            leftovers = []
            for name, group in by_prof.items():
                if not self.explainer.submit(
                        self.cache, self.cfg.profile_for(name),
                        self._attempt_level, group):
                    leftovers.extend(group)
        for pod in leftovers:
            self.recorder.event(pod, "Warning", "FailedScheduling",
                                GENERIC_MESSAGE)

    def _after_preempt(self, pod: Pod, attempts: int,
                       nominated: Optional[str]):
        if nominated:
            # Victims were evicted: retry immediately (no backoff); until
            # the pod binds, the reservation shields the capacity from
            # lower-priority pods in other batches.
            pod.status.nominated_node_name = nominated
            self._nominated[pod.key] = (nominated, pod.spec.priority, pod,
                                        time.time())
            # this entry is in-memory, whatever the key's history
            self._nominated_external.discard(pod.key)
            self.queue.add(pod)
        else:
            self.queue.add_unschedulable(pod, attempts + 1)
            if self.cache.is_bound(pod.key):  # bound event raced the requeue
                self.queue.delete(pod)

    def _preempt_view(self, pod: Pod) -> Pod:
        """Feasibility view of the pod for preemption: the profile's
        addedAffinity applies there too (upstream preemption re-runs the
        NodeAffinity plugin, which carries the args)."""
        profile = self.cfg.profile_for(pod.spec.scheduler_name)
        if profile is None or not profile.added_affinity:
            return pod
        return profile.apply_added_affinity([pod])[0]

    def _device_preempt_failed(self, what: str) -> None:
        """A device preemption program failed with an error a retry may
        cure: count it, feed the breaker; the caller takes the exact host
        scan. (A failure ``is_fatal`` calls fatal never reaches here: it
        propagates.)"""
        LOOP_ERRORS.inc({"site": "device_preempt"})
        _LOG.warning("%s failed at level %r; degrading to the exact host "
                     "scan", what, self._attempt_level, exc_info=True)
        self.breaker.fail(self._attempt_level)

    def _default_preempt(self, pod: Pod) -> Optional[str]:
        nodes, _, _ = self.cache.snapshot()
        bound = self.cache.bound_pods(include_assumed=True)
        view = self._preempt_view(pod)
        device_ok = self._attempt_level != "oracle"
        if device_ok:
            try:
                res = preemption_mod.find_candidate_tensor(
                    nodes, bound, view, pdbs=self.pdb_lister(),
                    dra=self.cache.dra_catalog, device=self.device)
            except Exception as e:
                if is_fatal(e):
                    raise
                self._device_preempt_failed("the preemption dry-run")
                device_ok = False
        if not device_ok:
            # device known-broken (or broke just now): the exact host scan
            res = preemption_mod.find_candidate(
                nodes, bound, view, pdbs=self.pdb_lister(),
                dra=self.cache.dra_catalog)
        if res is None:
            return None
        if not self._evict_victims(pod, res.victims):
            return None
        return res.node_name

    @staticmethod
    def _pod_tenant(pod: Pod):
        from kubernetes_tpu_torch.encode.snapshot import tenant_label_of
        return tenant_label_of(pod.metadata.labels)

    def _evict_victims(self, preemptor: Pod, victims: list) -> bool:
        """Evict a preemption result's victims — REFUSING the whole result
        if any victim belongs to a foreign tenant. The tenant gate makes a
        cross-tenant candidate node unreachable, so this can only fire on
        scheduler-side corruption; when it does, evicting a sibling
        tenant's workload is strictly worse than failing this preemptor."""
        pt = self._pod_tenant(preemptor)
        foreign = [v for v in victims if self._pod_tenant(v) != pt]
        if foreign:
            LOOP_ERRORS.inc({"site": "cross_tenant_preempt"})
            _LOG.error(
                "REFUSING preemption for %s: victim(s) %s belong to a "
                "foreign tenant", preemptor.key,
                ", ".join(v.key for v in foreign))
            return False
        for v in victims:
            self._evict(v)
        return True

    def _preempt_serial(self, nodes, bound, views) -> list:
        """Serial host-scan preemption for a wave: each winner's victims
        leave the shared bound view before the next pick, mirroring the
        wave's sequential-commit semantics without the device."""
        results = []
        bound_left = list(bound)
        for v in views:
            res = preemption_mod.find_candidate(
                nodes, bound_left, v, pdbs=self.pdb_lister(),
                dra=self.cache.dra_catalog)
            results.append(res)
            if res is not None:
                gone = {x.key for x in res.victims}
                bound_left = [p for p in bound_left if p.key not in gone]
        return results

    def resident_plan_view(self) -> tuple[Optional[dict], str]:
        """(view, reason) for consumers of the DEVICE-RESIDENT drain
        context — the preemption wave and the three background planners
        (encode/overlay.ResidentPlanner). ``view`` is None when the
        resident encoding cannot stand in for a fresh snapshot, with
        ``reason`` naming why (the planners' decline accounting).
        Valid only when the context is accountable (untainted) and current
        with the cache — every unconsumed delta-log entry is an assume the
        context already folded. That is exactly the state at a drain
        resolve: the wave then shares the resident cluster image (masks
        run on it in place, per-node totals read from its host shadow or
        the card, victim request vectors served from its fold ledger)
        instead of re-staging tensors the card already holds. (The
        reference also declines a context staged under an older mesh; the
        port has no mesh.) ``seq`` is the delta-log position the context
        has consumed: the planners compare it after a dispatch to see
        whether a churn patch moved the context meanwhile."""
        from kubernetes_tpu_torch.encode.patch import entries_all_folded
        ctx = self._drain_ctx
        if ctx is None:
            return None, "no_ctx"
        if self._pending:
            # in-flight drains' winners are folded into the resident
            # requested[N,R] but not yet in the cache's bound view — the
            # consumers' semantics (judge against bound+assumed, like the
            # snapshot path) require the two to agree
            return None, "in_flight"
        cs = ctx["cs"]
        if cs.tainted:
            return None, "tainted"
        entries = self.cache.deltas_since(ctx["seq"])
        if entries is None or not entries_all_folded(cs, entries):
            return None, "stale_log"
        nodes = self.cache.list_nodes()
        meta = ctx["meta"]
        rows = []
        for n in nodes:
            ni = meta.node_index.get(n.metadata.name, -1)
            if ni < 0:
                return None, "missing_node"  # node the context has not absorbed
            rows.append(ni)
        return {"ct": ctx["ct"], "meta": meta, "cs": cs,
                "nodes": nodes, "rows": np.asarray(rows, np.int32),
                "shadow": ctx.get("shadow"), "seq": ctx["seq"],
                "epoch": ctx["epoch"]}, "ok"

    def _resident_wave_view(self) -> Optional[dict]:
        """The preemption wave's view of the resident drain context (see
        resident_plan_view) — the wave has no decline accounting."""
        view, _reason = self.resident_plan_view()
        return view

    def _resident_cluster_arrays(self, view: dict):
        """``fn(resources) -> (allocatable, requested)`` for dry_run_wave:
        the resident [N,R] totals, rows gathered into the live node-list
        order and columns remapped onto the wave's resource axis. Steady
        state serves them from the HOST SHADOW (sched/staging.py
        ResidentShadow — winner folds mirrored at resolve, churn patches
        applied from their host arrays), so the wave reads nothing back
        from the card for cluster totals; a poisoned or absent shadow
        falls back to one readback of the resident arrays. Resources the
        resident encoding doesn't know stay 0 on both arrays — identical
        to the host encode, which scales ``alloc.get(r, 0)`` and can have
        no bound requests for a resource no bound pod carries (patches
        refuse unknown resource kinds)."""

        def arrays(resources):
            cs = view["cs"]
            got = None
            shadow = view.get("shadow")
            if shadow is not None:
                shadow.catch_up(
                    lambda p: self.cache.request_vector(p, cs.resources))
                got = shadow.arrays()
            if got is None:
                got = (view["ct"].allocatable.cpu().numpy(),
                       view["ct"].requested.cpu().numpy())
            alloc_res, req_res = got
            rows = view["rows"]
            res_index = cs.res_index
            N, R = len(view["nodes"]), len(resources)
            allocatable = np.zeros((N, R), np.int64)
            requested = np.zeros((N, R), np.int64)
            for j, r in enumerate(resources):
                ri = res_index.get(r)
                if ri is not None:
                    allocatable[:, j] = alloc_res[rows, ri]
                    requested[:, j] = req_res[rows, ri]
            return allocatable, requested

        return arrays

    def _resident_req_lookup(self, view: dict):
        """``fn(pod, resources) -> [R] | None`` serving victim request
        vectors from the fold ledger's cached per-pod vectors (compiled at
        encode/patch time on the RESIDENT resource axis), remapped onto
        the wave's axis. Pods the ledger holds as raw Pod objects (device
        folds defer the vector) fall back to the wave's own computation."""
        slot_req = view["cs"].slot_req
        res_index = view["cs"].res_index

        def lookup(pod, resources):
            v = slot_req.get(pod.key)
            if not isinstance(v, np.ndarray):
                return None
            out = np.zeros(len(resources), np.int64)
            for j, r in enumerate(resources):
                ri = res_index.get(r)
                if ri is not None:
                    out[j] = int(v[ri])
            return out

        return lookup

    def _evict_results(self, pods: list[Pod], results: list) -> list:
        out: list[Optional[str]] = []
        with TRACER.span("preempt/evict"):
            for p, res in zip(pods, results):
                if res is None or not self._evict_victims(p, res.victims):
                    out.append(None)
                    continue
                out.append(res.node_name)
        return out

    def _default_preempt_wave(self, pods: list[Pod]) -> list[Optional[str]]:
        """One sequential-commit wave for a batch of preemptors
        (preempt_wave); victims are evicted per winner in wave order,
        mirroring Q serial _default_preempt calls. Whenever the drain
        context is current (_resident_wave_view) the wave rides it: static
        masks run on the resident encoding in place, per-node totals come
        from its host shadow, and victim vectors from its fold ledger — no
        snapshot, no re-encode. Otherwise the wave takes one cache
        snapshot (which itself reuses the cached encoding).

        A failure of the device wave that ``is_fatal`` does not call fatal
        is counted (``LOOP_ERRORS{site=device_preempt}``), feeds the
        breaker, and the wave runs as the serial host scan; a fatal one
        propagates."""
        resident = None
        if self._attempt_level != "oracle":
            # bound is captured BEFORE the staleness check: a foreign bind
            # racing this wave from the informer thread is then either in
            # BOTH the victim list and the delta log (the view declines) or
            # in NEITHER the list nor the resident totals — the two views
            # dry_run_wave reconciles can never disagree
            bound = self.cache.bound_pods(include_assumed=True)
            resident = self._resident_wave_view()
        if resident is not None:
            with TRACER.span("preempt/resident", pods=len(pods)):
                nodes = resident["nodes"]
                ct, meta = resident["ct"], resident["meta"]
        else:
            with TRACER.span("preempt/snapshot"):
                nodes, ct, meta = self.cache.snapshot()
                bound = self.cache.bound_pods(include_assumed=True)
        views = [self._preempt_view(p) for p in pods]
        if self._attempt_level == "oracle":
            # device known-broken this cycle: go straight to the host scan
            with TRACER.span("preempt/serial", pods=len(pods)):
                results = self._preempt_serial(nodes, bound, views)
            return self._evict_results(pods, results)
        try:
            with TRACER.span("preempt/masks", pods=len(pods)):
                masks = preemption_mod.tensor_static_masks(
                    nodes, views, ct=ct, meta=meta,
                    encode_pods=self.cache.encode_pods,
                    min_p=preemption_mod.WAVE_BUCKET,
                    pre_staged=resident is not None,
                    node_rows=(resident["rows"] if resident is not None
                               else None),
                    device=self.device)
            with TRACER.span("preempt/wave", pods=len(pods),
                             nodes=len(nodes)):
                results = preemption_mod.preempt_wave(
                    nodes, bound, views, pdbs=self.pdb_lister(),
                    dra=self.cache.dra_catalog, static_masks=masks,
                    min_q=preemption_mod.WAVE_BUCKET,
                    resident_arrays=(
                        self._resident_cluster_arrays(resident)
                        if resident is not None else None),
                    req_lookup=(self._resident_req_lookup(resident)
                                if resident is not None else None),
                    device=self.device)
        except Exception as e:
            if is_fatal(e):
                raise
            self._device_preempt_failed("the preemption wave")
            with TRACER.span("preempt/serial", pods=len(pods)):
                results = self._preempt_serial(nodes, bound, views)
            return self._evict_results(pods, results)
        if self.sentinel is not None:
            # parity sample for the DEVICE wave only — the serial fallback
            # IS the oracle. Inputs are the exact host objects the wave's
            # masks were built from; judging runs off this thread.
            self.sentinel.maybe_submit_wave(
                nodes, bound, views, results, self._attempt_level,
                namespace_labels=self.cache.namespace_labels)
        return self._evict_results(pods, results)

    def _evict(self, victim: Pod):
        """Delete the victim via the binder-side client (the runner
        overrides this); cache removal happens via the watch event."""
        self.cache.remove_pod(victim.key)

    # ---- binding cycle (async, overlaps next batch) ----------------------

    def _bind_async_batch(self, pairs: list[tuple[Pod, str]], profile):
        """Dispatch a batch's bindings: pods needing per-pod ceremony
        (lifecycle hooks, extender binds, volume binding) go one call each;
        the rest ride ONE bulk-binding call per chunk."""
        if not pairs:
            return
        oot = (None if profile is None or profile.out_of_tree is None
               else set(profile.out_of_tree))
        lifecycle = self.registry.lifecycle_plugins(oot)
        if (self._bulk_binder is None or lifecycle
                or self._extender_bind is not None):
            for pod, node_name in pairs:
                self._bind_async(pod, node_name)
            return
        simple: list[tuple[Pod, str]] = []
        for pod, node_name in pairs:
            if pod.spec.resource_claims or pod.pvc_names():
                self._bind_async(pod, node_name)
            else:
                simple.append((pod, node_name))
        # chunk bulk requests so one call never grows unbounded
        CHUNK = 2048
        for i in range(0, len(simple), CHUNK):
            chunk = simple[i:i + CHUNK]
            self._enqueue_bind(("bulk", chunk), n=len(chunk))

    def _bind_async(self, pod: Pod, node_name: str):
        self._enqueue_bind(("one", pod, node_name), n=1)

    def _enqueue_bind(self, item, n: int):
        with self._bind_cv:
            self._bind_inflight += n
            if (len(self._bind_workers) < max(1, self.cfg.bind_workers)
                    and len(self._bind_workers) < self._bind_inflight):
                t = threading.Thread(target=self._bind_worker, daemon=True,
                                     name=f"binder-{len(self._bind_workers)}")
                t.start()
                self._bind_workers.append(t)
        self._bind_q.put(item)

    def _bind_worker(self):
        while True:
            item = self._bind_q.get()
            if item is None:  # poison pill from close()
                return
            n = 1
            try:
                if item[0] == "bulk":
                    n = len(item[1])
                    self._bind_bulk(item[1])
                else:
                    self._bind_one(item[1], item[2])
            except Exception:
                LOOP_ERRORS.inc({"site": "bind_worker"})
                _LOG.exception("binding cycle failed")
            finally:
                with self._bind_cv:
                    self._bind_inflight -= n
                    if self._bind_inflight == 0:
                        self._bind_cv.notify_all()

    def _bind_bulk(self, pairs: list[tuple[Pod, str]]):
        """One call binds the whole chunk; per-item results fan back out
        into the same success/failure handling as _bind_one."""
        try:
            results = self._bulk_binder(pairs)
        except Exception:
            _LOG.exception("bulk binding failed (%d pods)", len(pairs))
            results = [False] * len(pairs)
        if len(results) != len(pairs):
            results = list(results) + [False] * (len(pairs) - len(results))
        for (pod, node_name), ok in zip(pairs, results):
            if ok:
                self.cache.finish_binding(pod.key)
                FLIGHT.record(pod.key, "bind", node=node_name)
                self.recorder.event(
                    pod, "Normal", "Scheduled",
                    f"Successfully assigned {pod.key} to {node_name}")
            elif ok is None:
                # the pod vanished while its binding was in flight: drop
                # the assumption quietly (the informer's DELETED event owns
                # the queue cleanup)
                self.cache.forget(pod.key)
            else:
                self.cache.forget(pod.key)
                if not self.cache.is_bound(pod.key):
                    self.queue.add_unschedulable(pod, 1)
                    if self.cache.is_bound(pod.key):  # event raced the requeue
                        self.queue.delete(pod)
                SCHEDULE_ATTEMPTS.inc({"result": "error"})

    def close(self, timeout: float = 5.0):
        """Stop the binding pool: land in-flight drains, poison-pill every
        worker and join them. Idempotent. A fatal failure while landing the
        drains is raised once the rest is shut down."""
        fault = None
        try:
            self._resolve_pending()  # land every in-flight drain's bindings
        except Exception as e:
            if is_fatal(e):
                fault = e  # raised once the rest of the pool is down
            else:
                _LOG.exception("resolving in-flight drains at close")
        resolver = None
        with self._resolver_swap_lock:  # vs a racing watchdog restart
            if self._resolver_q is not None:
                self._resolver_q.put(None)  # poison pill
                resolver = self._resolver_thread
                self._resolver_thread = None
                self._resolver_q = None
        if resolver is not None:
            # joined, as every thread close() stops: a daemon thread still
            # inside a torch call when the interpreter exits aborts it
            resolver.join(timeout=timeout)
        self.cache.close_staging()  # poison the batch-stager (daemon too)
        if self.sentinel is not None:
            self.sentinel.close()
        if self.explainer is not None:
            self.explainer.close()
        if self._staged:
            # parked fragments go back to the queue, not the void — with
            # their attempt history, so backoff does not reset
            for pod, attempts in self._staged:
                self.queue.add(pod, attempts=attempts)
            self._staged = []
        with self._bind_cv:
            workers = list(self._bind_workers)
            self._bind_workers = []
        for _ in workers:
            self._bind_q.put(None)
        for t in workers:
            t.join(timeout=timeout)
        if fault is not None:
            raise fault

    def _bind_one(self, pod: Pod, node_name: str):
        from kubernetes_tpu_torch.sched import framework as fw
        # lifecycle hooks honor the pod's profile opt-in
        profile = self.cfg.profile_for(pod.spec.scheduler_name)
        oot = (None if profile is None or profile.out_of_tree is None
               else set(profile.out_of_tree))
        lifecycle = self.registry.lifecycle_plugins(oot)
        rollback: list = []
        try:
            # Permit -> PreBind -> Bind (framework extension-point order);
            # plugins that allowed/prepared join the unreserve rollback set
            ok, permitted = fw.run_permit(lifecycle, pod, node_name)
            rollback.extend(permitted)
            if ok:
                ok, prebound = fw.run_pre_bind(lifecycle, pod, node_name)
                rollback.extend(p for p in prebound if p not in rollback)
            if ok:
                delegated = None
                if self._extender_bind is not None:
                    # an interested extender with a bindVerb owns the binding
                    delegated = self._extender_bind(pod, node_name)
                ok = (self.binder(pod, node_name) if delegated is None
                      else delegated)
        except Exception:
            LOOP_ERRORS.inc({"site": "bind_lifecycle"})
            _LOG.exception("binding cycle for %s failed", pod.key)
            ok = False
        # a binder returning None means the pod no longer exists (deleted
        # while the binding was in flight): nothing to requeue, nothing
        # failed
        gone = ok is None
        if ok:
            fw.run_post_bind(lifecycle, pod, node_name)
            FLIGHT.record(pod.key, "bind", node=node_name)
            self.recorder.event(pod, "Normal", "Scheduled",
                                f"Successfully assigned {pod.key} to {node_name}")
        else:
            fw.run_unreserve(rollback, pod, node_name)
        if ok:
            self.cache.finish_binding(pod.key)
        elif gone:
            self.cache.forget(pod.key)
        else:
            self.cache.forget(pod.key)
            # 409 ordering: if another party bound this pod while it was
            # in-flight, requeueing now would retry forever
            if not self.cache.is_bound(pod.key):
                self.queue.add_unschedulable(pod, 1)
                if self.cache.is_bound(pod.key):  # event raced the requeue
                    self.queue.delete(pod)
            SCHEDULE_ATTEMPTS.inc({"result": "error"})

    def wait_for_bindings(self, timeout: float = 5.0):
        deadline = time.time() + timeout
        with self._bind_cv:
            while self._bind_inflight > 0:
                remaining = deadline - time.time()
                if remaining <= 0 or not self._bind_cv.wait(remaining):
                    break

    # ---- loop ------------------------------------------------------------

    def taint_ctx(self) -> None:
        """Mark the device-resident drain context unaccountable: the next
        dispatch rebuilds from a host snapshot."""
        ctx = self._drain_ctx
        if ctx is not None:
            ctx["cs"].tainted = True

    def audit_ctx_view(self) -> Optional[dict]:
        """Plain-value view of the resident drain context's host-side fold
        ledger for the invariant auditor. Reads from a foreign thread:
        each field is one GIL-atomic read or dict copy."""
        ctx = self._drain_ctx
        if ctx is None:
            return None
        cs = ctx["cs"]
        return {"profile": ctx["profile"], "tainted": cs.tainted,
                "seq": ctx["seq"], "fill_bound": ctx["fill_bound"],
                "fill_host": cs.fill_host, "top": cs.top,
                "folded": dict(cs.folded),
                "pending": len(self._pending)}

    def run(self, stop: threading.Event):
        """wait.UntilWithContext(sched.ScheduleOne, 0) analog — hardened:
        a run_once failure is logged + counted (never swallowed, never
        fatal), the resident drain context is tainted, and the loop backs
        off briefly and continues. A BaseException escapes, and so does a
        failure a retry cannot cure (``sched/faults.is_fatal``: a feature
        this port has not got yet, a kernel that does not build or launch,
        a device answer the parity sentinel refuted, a CUDA error).
        run_once has requeued the popped pods."""
        consecutive = 0
        while not stop.is_set() and not self.queue.closed:
            self.heartbeat()
            try:
                self.run_once()
                consecutive = 0
            except Exception as e:
                if is_fatal(e):
                    raise
                consecutive += 1
                LOOP_ERRORS.inc({"site": "run_once"})
                _LOG.exception("run_once failed (%d consecutive); "
                               "self-healing", consecutive)
                self.taint_ctx()
                stop.wait(min(0.05 * (2 ** min(consecutive, 6)), 2.0))
