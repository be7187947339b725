"""Connected scheduler — informers in, bindings out.

Reference: ``cmd/kube-scheduler/app/server.go`` (Run: informers + event
handlers feeding the queue/cache, then the scheduling loop) and the event
registration in ``pkg/scheduler/eventhandlers.go``. Optionally wraps the loop
in leader election (active-passive HA, SURVEY §5).

The port of ``kubernetes_tpu/sched/runner.py``. Where it differs:

- A loop that dies of a failure ``sched/faults.is_fatal`` calls fatal — a
  ``KernelError`` (a kernel that does not build, load or launch), a
  ``ParityError`` (the parity sentinel refuted a device answer), a
  ``NotImplementedError`` (a feature the port has not got yet) or a CUDA
  error (the context is unusable) — is not revived: a retry cannot cure
  any of them, and a revived loop would hide the fault behind a process
  that looks alive. The exception is
  kept as ``loop_error``, and ``stop()`` re-raises it.
- The durable cache (``aotCacheDir``, sched/aotcache.py) holds the
  port's one persistent artifact, the ``nvcc``-built kernel libraries; the
  CUDA graphs of the rounds are captured again by every process (its warm
  ladder). A cache that cannot be activated is counted and the runner
  builds afresh, on the card as always.
- Left out: the ``KTPU_SWITCH_INTERVAL`` knob.
- DRA is wired as in the reference: the ``resourceclaims``,
  ``deviceclasses`` and ``resourceslices`` informers feed the cache's
  catalog, ``_bind`` allocates a pod's claims before its binding and
  unreserves them on a later failure; releasing a finished pod's claims
  is the ResourceClaim controller's (controllers/resourceclaim.py). One
  difference: the unreserve writes against the claim object that the
  allocation returned. The reference keeps the object it sent, whose
  resourceVersion the allocation has moved, so its unreserve is refused
  (409) and the claim stays allocated to a node its pod never bound to.
- ``device`` and ``feature_gate`` go to the ``Scheduler``: the card unless
  the caller asks for the CPU.
- The binding calls are traced (``runner/bind``, one span per request), and
  so is the pod handler (``runner/pod_added``, ``runner/pod_modified``,
  ``runner/pod_deleted``, one span per watch event), so a window's bind
  and watch time sit beside the loop's spans.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

_LOG = logging.getLogger("kubernetes_tpu_torch.sched.runner")

from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.client.leaderelection import (LeaderElectionConfig,
                                                        LeaderElector)
from kubernetes_tpu_torch.config.features import DEFAULT_FEATURE_GATE
from kubernetes_tpu_torch.config.types import SchedulerConfiguration
from kubernetes_tpu_torch.metrics.registry import (
    BIND_RESULTS,
    BIND_RETRIES,
    LOOP_ERRORS,
    NODE_LIVENESS_SKIPS,
)
from kubernetes_tpu_torch.sched.cache import SchedulerCache
from kubernetes_tpu_torch.sched.faults import is_fatal
from kubernetes_tpu_torch.sched.resilience import ThreadWatchdog
from kubernetes_tpu_torch.utils.retry import with_retries
from kubernetes_tpu_torch.sched.queue import (
    EVENT_NODE_ADD,
    EVENT_NODE_UPDATE,
    EVENT_POD_DELETE,
    SchedulingQueue,
)
from kubernetes_tpu_torch.sched.scheduler import Scheduler
from kubernetes_tpu_torch.sched.volumebinding import VolumeBinder
from kubernetes_tpu_torch.store.store import ADDED, DELETED, MODIFIED
from kubernetes_tpu_torch.utils.tracing import TRACER

# Published like the autoscaler's cluster-autoscaler-status: one ConfigMap
# other components (and ``ktpu status``) read for the live deployment shape.
STATUS_CONFIGMAP = "kubernetes-tpu-scheduler-status"
# Decision provenance: per-pod unschedulability explanations (the
# explainer's verdicts), read by ``ktpu why <pod>`` in the reference.
EXPLAIN_CONFIGMAP = "scheduler-explanations"
# Flight-recorder export: the newest window of batch spans + per-pod
# lifecycle tracks as Chrome trace-event JSON, read by ``ktpu trace dump``
# (loads directly in Perfetto). Bounded — see _publish_trace.
TRACE_CONFIGMAP = "kubernetes-tpu-scheduler-trace"
# span events / pod tracks kept in the published trace ConfigMap (the
# full in-process ring is TRACER.max_spans and FLIGHT.max_pods; the
# ConfigMap is a bounded API object rewritten on the audit cadence)
TRACE_PUBLISH_EVENTS = 1000
TRACE_PUBLISH_PODS = 200

# one span per pod watch event, by type
_POD_SPANS = {ADDED: "runner/pod_added", MODIFIED: "runner/pod_modified",
              DELETED: "runner/pod_deleted"}


class SchedulerRunner:
    """Owns informers, cache, queue, scheduler; drives the loop."""

    def __init__(self, client, cfg: Optional[SchedulerConfiguration] = None,
                 identity: str = "kubernetes-tpu-scheduler", registry=None,
                 status_namespace: str = "default",
                 status_name: str = STATUS_CONFIGMAP,
                 explain_name: str = EXPLAIN_CONFIGMAP,
                 trace_name: str = TRACE_CONFIGMAP,
                 feature_gate=DEFAULT_FEATURE_GATE, device=None):
        self.client = client
        # where publish_status writes its ConfigMap (same shape as the
        # autoscaler's status_namespace: RBAC commonly restricts writes to
        # the component's own namespace; ktpu -n <ns> status must match)
        self.status_namespace = status_namespace
        # Per-INSTANCE ConfigMap names: two scheduler identities sharing
        # one apiserver must not clobber each other's status/explanations/
        # trace.
        self.status_name = status_name
        self.explain_name = explain_name
        self.trace_name = trace_name
        if hasattr(client, "default_user_agent"):
            client.default_user_agent("kube-scheduler")

        self.cfg = cfg or SchedulerConfiguration()
        # durable kernel cache: armed BEFORE the Scheduler exists so every
        # kernel this process builds lands in it, and a restarted scheduler
        # loads instead of building (sched/aotcache.py). Activation never
        # raises on cache damage; a cache that cannot be armed at all is
        # counted and the kernels build afresh into build/kernels/.
        self.aot_cache = None
        from kubernetes_tpu_torch.sched.aotcache import (AotExecutableCache,
                                                         cache_knobs,
                                                         resolve_cache_dir)
        cache_dir = resolve_cache_dir(self.cfg)
        if cache_dir:
            try:
                self.aot_cache = AotExecutableCache(
                    cache_dir, knobs=cache_knobs(self.cfg),
                    max_bytes=self.cfg.aot_cache_max_mb * 1024 * 1024)
                self.aot_cache.activate()
            except Exception:
                # the cache is an accelerant, never a dependency
                from kubernetes_tpu_torch.metrics.registry import (
                    AOT_CACHE_ERRORS)
                AOT_CACHE_ERRORS.inc({"reason": "activate"})
                _LOG.exception("kernel cache activation failed at %s; "
                               "building without persistence", cache_dir)
                AotExecutableCache.disarm()
                self.aot_cache = None
        self.cache = SchedulerCache(assume_ttl=self.cfg.assume_ttl_s)
        self.queue = self._build_queue(self.cfg)
        self.scheduler = Scheduler(self.cfg, self.cache, self.queue, self._bind,
                                   feature_gate=feature_gate,
                                   registry=registry,
                                   bulk_binder=self._bind_many,
                                   device=device)
        if self.aot_cache is not None:
            # on the card every kernel library is built (cold) or loaded
            # (warm) now, before the loop judges a pod
            try:
                self.aot_cache.ready_kernels(self.scheduler.device)
            except BaseException:
                self.scheduler.close()
                raise
        if (self.aot_cache is not None and self.aot_cache.boot.get("entries")
                and self.scheduler.sentinel is not None):
            # warm-from-cache canary: the FIRST drain answered with kernels
            # loaded from the cache is parity-judged regardless of the
            # every-Kth modulus — a wrong library stops the loop with a
            # ParityError before a second batch trusts it
            self.scheduler.sentinel.force_next()
        from kubernetes_tpu_torch.utils.events import EventRecorder
        self.scheduler.recorder = EventRecorder(client, "default-scheduler")
        self.scheduler._evict = self._evict  # preemption deletes via API
        # decision provenance: the explainer publishes its verdicts as the
        # scheduler-explanations ConfigMap (events ride the recorder wired
        # above)
        if self.scheduler.explainer is not None:
            self.scheduler.explainer.publisher = self._publish_explanations
        self.factory = InformerFactory(client)
        self.identity = identity
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        # Per-leadership-term scheduling loop: a lost lease stops the loop (no
        # split-brain binding), a re-acquired one starts a fresh term instead
        # of stacking a second concurrent loop.
        self._loop_stop: Optional[threading.Event] = None
        self._loop_thread: Optional[threading.Thread] = None
        self._loop_expected = False
        # the fatal failure (sched/faults.is_fatal) that ended the loop, if
        # one did: kept for stop() to re-raise, and it bars any
        # restart
        self.loop_error: Optional[BaseException] = None
        # serializes loop lifecycle transitions between the elector thread
        # (start/stop on leadership changes) and the watchdog's revive —
        # without it a revive racing a lost lease could restart a
        # non-leader's loop
        self._loop_lock = threading.Lock()
        self._scheduler_names = {p.scheduler_name for p in self.cfg.profiles}
        # liveness-only node MODIFIEDs skipped before decode (_on_node);
        # written from the single informer dispatch thread, mirrored into
        # the NODE_LIVENESS_SKIPS gauge
        self._node_skips = 0
        # thread watchdog (sched/resilience.py): restarts a dead or
        # stalled scheduling loop / drain resolver instead of letting the
        # runner hang with a live process and a dead brain
        self._watchdog = ThreadWatchdog(
            interval_s=self.cfg.watchdog_interval_s,
            stall_s=self.cfg.watchdog_stall_s)
        self.scheduler.heartbeat = lambda: self._watchdog.beat("loop")
        self.scheduler.resolver_heartbeat = \
            lambda: self._watchdog.beat("resolver")
        # continuous invariant auditor (audit/): background sweeps over a
        # consistent apiserver list + the scheduler's cache/resident-ctx
        # views. The stale-nomination GC rides the same cadence as the
        # pre-sweep hook, so every sweep judges the post-GC state; relist
        # counting gates cache-parity (an informer healing from a watch
        # outage is lagging, not wrong).
        from kubernetes_tpu_torch.audit.auditor import InvariantAuditor
        self.auditor = InvariantAuditor(
            client=client, cache=self.cache, scheduler=self.scheduler,
            interval_s=self.cfg.audit_interval_s,
            fail_fast=self.cfg.audit_fail_fast,
            pre_sweep=self.sweep_stale_nominations,
            post_sweep=self.publish_status,
            relists=self._total_relists)

    def _build_queue(self, cfg: SchedulerConfiguration) -> SchedulingQueue:
        return SchedulingQueue(backoff_initial=cfg.backoff_initial_s,
                               backoff_max=cfg.backoff_max_s)

    def _all_informers(self):
        """Every SharedInformer this runner owns."""
        return list(self.factory._informers.values())

    # ---- event handlers (pkg/scheduler/eventhandlers.go analog) ----------

    def _on_pod(self, type_, obj, old):
        with TRACER.span(_POD_SPANS.get(type_, "runner/pod_event")):
            self._handle_pod(type_, obj, old)

    def _handle_pod(self, type_, obj, old):
        if type_ != DELETED:
            # Fast path for bind confirmations: a gang bind storm is one
            # MODIFIED per pod whose only news is the nodeName the cache
            # already assumed — confirm from the raw dict and skip the full
            # Pod.from_dict (a first-order cost at 10k events/s).
            spec = obj.get("spec") or {}
            nn = spec.get("nodeName")
            if nn and (obj.get("status") or {}).get("phase") \
                    not in ("Succeeded", "Failed"):
                md = obj.get("metadata") or {}
                key = f"{md.get('namespace', 'default')}/{md.get('name', '')}"
                if self.cache.confirm(key, nn, md.get("labels") or {},
                                      spec=spec):
                    self.queue.delete_key(key)
                    return
        try:
            pod = Pod.from_dict(obj)
        except Exception:
            # a pod we cannot decode is a pod we silently never schedule:
            # count + log it loudly
            LOOP_ERRORS.inc({"site": "pod_decode"})
            _LOG.warning("dropping undecodable pod event %s: %s", type_,
                         (obj.get("metadata") or {}).get("name", "?"),
                         exc_info=True)
            return
        if type_ == DELETED or pod.status.phase in ("Succeeded", "Failed"):
            # Terminal pods release their node's resources immediately; the
            # reference filters them out of the scheduler's informer entirely
            # (eventhandlers.go assignedNonTerminatedPod FilterFunc).
            self.queue.delete(pod)
            self.cache.remove_pod(pod.key)
            self.queue.move_all_to_active_or_backoff(EVENT_POD_DELETE)
            return
        if pod.spec.node_name:
            # bound (or assumed-confirmed) pod — also drop it from the queue:
            # a pod bound by another party while sitting in backoffQ would
            # otherwise be double-counted (pending in the batch AND bound in
            # the cache) and retried in a 409 loop forever. Mirrors the
            # reference's addPodToCache -> SchedulingQueue.AssignedPodAdded.
            # Order matters: cache BEFORE queue. The scheduler's failure
            # paths requeue only if not cache.is_bound, then re-check; with
            # this order, an is_bound=False re-check guarantees our
            # queue.delete below still lies ahead and will clean up.
            self.cache.add_pod(pod)
            self.queue.delete(pod)
            return
        if pod.spec.scheduler_name not in self._scheduler_names:
            return
        if pod.status.nominated_node_name:
            # another component reserved capacity for this pending pod via
            # the API (descheduler gang defrag); honor it like our own
            # preemption nominations (eventhandlers.go addNominatedPod)
            self.scheduler.nominate_external(
                pod, pod.status.nominated_node_name)
        elif type_ == MODIFIED and ((old or {}).get("status") or {}) \
                .get("nominatedNodeName"):
            # field removed (aborted gang plan): clear the API-origin
            # reservation instead of pinning the node for the full TTL.
            # Only when the PREVIOUS object carried one.
            self.scheduler.nominate_external(pod, "")
        from kubernetes_tpu_torch.utils.tracing import FLIGHT
        FLIGHT.record(pod.key, "informer", event=type_)
        # incremental encode: compile the pod's encode record NOW, on the
        # watch thread, so the drain's encode_pods is array-fill only by
        # the time this pod pops (sched/cache.py precompile_pod never
        # blocks behind an in-progress encode; it is numpy only)
        self.cache.precompile_pod(pod)
        FLIGHT.record(pod.key, "precompile")
        if type_ == MODIFIED and not pod.spec.scheduling_gates:
            self.queue.activate_gated(pod)
        self.queue.add(pod)

    @staticmethod
    def _node_liveness_only(obj: dict, old: dict) -> bool:
        """True when a node MODIFIED carries only liveness news — heartbeat
        condition timestamps, kubelet endpoint/address re-assertions — and
        nothing scheduling-relevant (spec/taints, labels, allocatable,
        capacity, images, condition STATUS transitions). At 10k-node fleet
        scale the bulk heartbeat/lease paths emit one such MODIFIED per
        node per period; decoding each and waking the scheduling queue for
        it is pure informer-thread burn."""
        if obj.get("spec") != old.get("spec"):
            return False
        if ((obj.get("metadata") or {}).get("labels")
                != (old.get("metadata") or {}).get("labels")):
            return False
        st, ost = obj.get("status") or {}, old.get("status") or {}
        for k in ("allocatable", "capacity", "images"):
            if st.get(k) != ost.get(k):
                return False
        return ({(c.get("type"), c.get("status"))
                 for c in st.get("conditions") or []}
                == {(c.get("type"), c.get("status"))
                    for c in ost.get("conditions") or []})

    def _on_node(self, type_, obj, old):
        if type_ == MODIFIED and old is not None \
                and self._node_liveness_only(obj, old):
            # liveness-only refresh: no decode, no cache delta, no queue
            # wake
            self._node_skips += 1
            NODE_LIVENESS_SKIPS.set(self._node_skips)
            return
        try:
            node = Node.from_dict(obj)
        except Exception:
            LOOP_ERRORS.inc({"site": "node_decode"})
            _LOG.warning("dropping undecodable node event %s: %s", type_,
                         (obj.get("metadata") or {}).get("name", "?"),
                         exc_info=True)
            return
        if type_ == DELETED:
            self.cache.remove_node(node.metadata.name)
        else:
            self.cache.update_node(node)
            self.queue.move_all_to_active_or_backoff(
                EVENT_NODE_ADD if type_ == ADDED else EVENT_NODE_UPDATE)

    # ---- event handler: volume objects -----------------------------------

    def _on_volume(self, kind: str):
        def handler(type_, obj, old):
            self.cache.update_volume_object(kind, obj, deleted=type_ == DELETED)
            # a new/changed PV or PVC can unblock pending pods
            self.queue.move_all_to_active_or_backoff(EVENT_NODE_UPDATE)
        return handler

    def _on_dra(self, kind: str):
        def handler(type_, obj, old):
            self.cache.update_dra_object(kind, obj, deleted=type_ == DELETED)
            # a new slice/claim (or a released allocation) can unblock pods
            self.queue.move_all_to_active_or_backoff(EVENT_NODE_UPDATE)
        return handler

    # ---- binding via API (DefaultBinder analog) --------------------------

    def _retry(self, fn):
        """Jittered bounded retries for bind/status writes (utils/retry):
        a transient API failure (connection reset, 5xx, 429) retries
        in-request instead of failing straight through to a requeue —
        semantic outcomes (404 gone, 409 conflict) still surface
        immediately to the callers' existing handling."""
        return with_retries(
            fn, attempts=self.cfg.bind_retries + 1,
            base_s=self.cfg.bind_retry_backoff_s,
            on_retry=lambda e: BIND_RETRIES.inc())

    def _bind(self, pod: Pod, node_name: str) -> bool:
        # PreBind: claim allocations (dynamicresources.go bindClaim), then
        # volumes (volumebinding.go BindPodVolumes), then the binding itself.
        # Any later failure must UNRESERVE the claims we just allocated
        # (the plugin's Unreserve hook) or the pod stays pinned to a node it
        # never bound to.
        allocated: list[dict] = []
        dra = self.cache.dra_catalog
        if dra is not None and pod.spec.resource_claims:
            from kubernetes_tpu_torch.sched.dra import allocation_patch
            from kubernetes_tpu_torch.topology.slicing import (
                coords_of_labels, shape_of_labels)
            # carved-slice provenance: the allocation records the torus
            # coordinate the member landed on (node labels first, the
            # slice inventory's attributes as fallback) + requested shape
            node = self.cache.get_node(node_name)
            coords = (coords_of_labels(node.metadata.labels)
                      if node is not None else None)
            if coords is None:
                coords = dra.node_topology(node_name)
            shape = (shape_of_labels(pod.metadata.labels)
                     or dra.pod_slice_shape(pod))
            for claim in dra.pod_claims(pod):
                if ((claim.get("status") or {}).get("allocation")):
                    continue  # already allocated (shared or re-bind)
                ns = (claim.get("metadata") or {}).get("namespace", "default")
                patched = allocation_patch(
                    claim, node_name, pod,
                    coords=coords if shape is not None else None,
                    shape=shape)
                try:
                    # the object the write returns carries the claim's new
                    # resourceVersion, which an unreserve must present
                    allocated.append(self._retry(lambda: self.client.resource(
                        "resourceclaims", ns).update_status(patched)))
                except ApiError as e:
                    if e.code != 409:
                        _LOG.warning("claim allocation for %s failed: %s",
                                     pod.key, e)
                        self._unreserve(allocated)
                        return False
        catalog = self.cache.volume_catalog
        if catalog is not None and pod.pvc_names():
            node = self.cache.get_node(node_name)
            labels = node.metadata.labels if node is not None else {}
            if not VolumeBinder(self.client).bind_pod_volumes(
                    pod, node, catalog, labels, node_name):
                self._unreserve(allocated)
                return False
        try:
            with TRACER.span("runner/bind", pods=1):
                self._retry(lambda: self.client.pods(pod.metadata.namespace)
                            .bind(pod.metadata.name, node_name))
            return True
        except ApiError as e:
            self._unreserve(allocated)
            if e.code == 404:
                # pod deleted while the binding was in flight (churn): not a
                # failure — tell the scheduler there is nothing to requeue,
                # and keep the expected noise out of the logs
                BIND_RESULTS.inc({"result": "gone"})
                _LOG.debug("bind %s -> %s: pod gone", pod.key, node_name)
                return None
            # 409 = another party bound it first (expected race); anything
            # else is a systemic failure worth surfacing, not swallowing.
            label = "conflict" if e.code == 409 else "error"
            BIND_RESULTS.inc({"result": label})
            if e.code != 409:
                _LOG.warning("bind %s -> %s failed: %s", pod.key, node_name, e)
            return False
        except Exception as e:
            self._unreserve(allocated)
            BIND_RESULTS.inc({"result": "connection"})
            _LOG.warning("bind %s -> %s: API unreachable: %s", pod.key, node_name, e)
            return False

    def _bind_many(self, pairs) -> list:
        """Bulk DefaultBinder: one POST pods/-/binding for a whole gang
        batch. Only plain pods reach this (the scheduler routes DRA/volume/
        lifecycle pods through _bind); per-item 409s are expected races.
        Per-item result: True (bound), False (failed — requeue), None (pod
        vanished mid-flight — nothing to requeue, e.g. a churn delete)."""
        try:
            bindings = [(p.metadata.namespace, p.metadata.name, node)
                        for p, node in pairs]
            with TRACER.span("runner/bind", pods=len(pairs)):
                errs = self._retry(
                    lambda: self.client.pods("default").bind_many(bindings))
        except ApiError as e:
            BIND_RESULTS.inc({"result": "error"}, by=len(pairs))
            _LOG.warning("bulk bind of %d pods failed: %s", len(pairs), e)
            return [False] * len(pairs)
        except Exception as e:
            BIND_RESULTS.inc({"result": "connection"}, by=len(pairs))
            _LOG.warning("bulk bind: API unreachable: %s", e)
            return [False] * len(pairs)
        out = []
        for (pod, node), err in zip(pairs, errs):
            if err is None:
                out.append(True)
            elif "not found" in err:
                # deleted while in flight (churn teardown races the gang
                # step's binding every cycle): expected, debug-level only
                BIND_RESULTS.inc({"result": "gone"})
                _LOG.debug("bind %s -> %s: pod gone", pod.key, node)
                out.append(None)
            else:
                label = "conflict" if "bound" in err else "error"
                BIND_RESULTS.inc({"result": label})
                if label != "conflict":
                    _LOG.warning("bind %s -> %s failed: %s",
                                 pod.key, node, err)
                out.append(False)
        return out

    def _unreserve(self, allocated: list[dict]) -> None:
        """Roll back claim allocations written by a failed bind attempt."""
        from kubernetes_tpu_torch.sched.dra import release_patch
        for claim in allocated:
            ns = (claim.get("metadata") or {}).get("namespace", "default")
            try:
                self.client.resource("resourceclaims", ns).update_status(
                    release_patch(claim))
            except Exception as e:
                # the claim controller's release sweep is the backstop
                _LOG.warning("claim unreserve failed (sweep will catch): %s", e)

    def _total_relists(self) -> int:
        return sum(getattr(inf, "relists", 0)
                   for inf in self._all_informers())

    def sweep_stale_nominations(self) -> int:
        """Periodic GC: clear ``status.nominatedNodeName`` from bound or
        terminal pods. A nomination's job ends the moment its pod binds
        (or dies); the field surviving past that pins a node's capacity in
        every consumer that honors nominations and is exactly what the
        auditor's nomination_consistency invariant flags. Runs as the
        auditor's pre-sweep hook; returns pods cleared. Best effort per
        pod: 404/409 mean the pod moved on and the next sweep re-judges
        it."""
        cleared = 0
        try:
            pods = self.client.resource("pods", None).list()
        except Exception:
            LOOP_ERRORS.inc({"site": "nomination_gc"})
            _LOG.warning("stale-nomination sweep: pod list failed",
                         exc_info=True)
            return 0
        for p in pods:
            st = p.get("status") or {}
            if not st.get("nominatedNodeName"):
                continue
            bound = bool((p.get("spec") or {}).get("nodeName"))
            terminal = st.get("phase") in ("Succeeded", "Failed")
            if not (bound or terminal):
                continue
            md = p.get("metadata") or {}
            q = dict(p)
            q["status"] = {k: v for k, v in st.items()
                           if k != "nominatedNodeName"}
            try:
                self.client.pods(md.get("namespace", "default")) \
                    .update_status(q)
                cleared += 1
                _LOG.info("cleared stale nomination on %s pod %s/%s",
                          "bound" if bound else "terminal",
                          md.get("namespace", "default"), md.get("name"))
            except ApiError as e:
                if e.code not in (404, 409):
                    LOOP_ERRORS.inc({"site": "nomination_gc"})
                    _LOG.warning("stale-nomination clear for %s failed: %s",
                                 md.get("name"), e)
            except Exception:
                LOOP_ERRORS.inc({"site": "nomination_gc"})
                _LOG.warning("stale-nomination clear for %s failed",
                             md.get("name"), exc_info=True)
        return cleared

    def _evict(self, victim: Pod):
        # Preemption DELETEs the victim directly (schedule_one.go preempts
        # via clientset Pods().Delete, not the Eviction API): victim
        # selection already preferred PDB-safe victims, and upstream allows
        # violating a budget as a last resort.
        try:
            self.client.pods(victim.metadata.namespace).delete(victim.metadata.name)
        except ApiError as e:
            if e.code != 404:  # already gone is fine
                LOOP_ERRORS.inc({"site": "evict"})
                _LOG.warning("evict %s failed: %s", victim.key, e)
        except Exception as e:
            LOOP_ERRORS.inc({"site": "evict"})
            _LOG.warning("evict %s: API unreachable: %s", victim.key, e)
        self.cache.remove_pod(victim.key)

    # ---- lifecycle -------------------------------------------------------

    def start(self, wait_sync: float = 10.0, start_loop: bool = True):
        """Start informers (+ scheduling loop). ``start_loop=False`` starts
        only the informer layer — callers that need to warm caches and
        kernels against synced state first (benchmarks, tests) call
        ``start_loop()`` afterwards."""
        return self._start(wait_sync, start_loop)

    def start_loop(self):
        """Start the scheduling loop (after a start(start_loop=False))."""
        if self.cfg.leader_elect:
            raise RuntimeError("leader election owns the loop lifecycle")
        self._start_loop()

    def has_synced(self) -> bool:
        """Every informer has delivered its initial list."""
        return all(inf.has_synced() for inf in self._all_informers())

    def _wire_informers(self, factory: InformerFactory, wrap=None):
        """Register every watched resource's handlers on ``factory`` —
        THE single list of what the scheduler watches. ``wrap(handler,
        plural)`` adapts handlers (the FleetRunner re-keys each tenant's
        events through it); a watched resource added here reaches fleet
        tenants too. Returns the PDB informer (its store feeds
        preemption's victim selection)."""
        w = wrap if wrap is not None else (lambda h, _plural: h)
        factory.informer("pods", None).add_event_handler(
            w(self._on_pod, "pods"))
        factory.informer("nodes", None).add_event_handler(
            w(self._on_node, "nodes"))
        for plural, kind in (("persistentvolumeclaims", "PersistentVolumeClaim"),
                             ("persistentvolumes", "PersistentVolume"),
                             ("storageclasses", "StorageClass")):
            factory.informer(plural, None).add_event_handler(
                w(self._on_volume(kind), plural))
        for plural, kind in (("resourceclaims", "ResourceClaim"),
                             ("deviceclasses", "DeviceClass"),
                             ("resourceslices", "ResourceSlice")):
            factory.informer(plural, None).add_event_handler(
                w(self._on_dra(kind), plural))
        factory.informer("namespaces", None).add_event_handler(
            w(lambda type_, obj, old: self.cache.update_namespace(
                obj, deleted=(type_ == "DELETED")), "namespaces"))
        # PDBs feed preemption's victim selection (default_preemption.go
        # checks budgets when picking victims)
        return factory.informer("poddisruptionbudgets", None)

    def _start_informers(self, wait_sync: float):
        """Wire, start and sync the informers. -> the PDB lister that
        preemption reads (the FleetRunner gives a fleet-wide one)."""
        pdb_inf = self._wire_informers(self.factory)
        self.factory.start_all()
        self.factory.wait_for_cache_sync(wait_sync)
        return lambda: list(pdb_inf.store.list())

    def _start(self, wait_sync: float, start_loop: bool):
        self.scheduler.pdb_lister = self._start_informers(wait_sync)
        # Boot resync: a predecessor that died mid-cycle leaves stale
        # nominations in the API. Sweeping HERE — after the informers
        # synced, before the loop binds anything — means the first
        # scheduling cycle judges clean state. Bound-pod state needs no
        # sweep: the informer sync itself rebuilt the cache from the API's
        # nodeName truth (_on_pod confirms, never re-binds).
        try:
            cleared = self.sweep_stale_nominations()
            if cleared:
                _LOG.info("boot resync: cleared %d stale nomination(s) "
                          "left by a prior incarnation", cleared)
        except Exception:
            LOOP_ERRORS.inc({"site": "nomination_gc"})
            _LOG.warning("boot-resync nomination sweep failed; the audit "
                         "cadence retries", exc_info=True)

        if self.cfg.leader_elect:
            elector = LeaderElector(self.client.leases(), LeaderElectionConfig(
                lock_name="kubernetes-tpu-scheduler", identity=self.identity,
                on_started_leading=self._start_loop,
                on_stopped_leading=self._stop_loop))
            self._elector = elector
            # elector.run self-heals per term (ApiError storms are missed
            # renewals, callback failures drop leadership and re-contend),
            # so the thread body needs no further wrapping
            t = threading.Thread(target=elector.run, args=(self._stop,),
                                 daemon=True)
            t.start()
            self._threads.append(t)
        elif start_loop:
            self._start_loop()
        self.auditor.start()
        self.publish_status()
        return self

    def _resilience_status(self) -> dict:
        """Live self-healing state for the status ConfigMap: degraded mode
        (single/oracle), breaker trip/restore counts, watchdog restarts,
        the informer layer's relist totals, and the fatal loop error."""
        from kubernetes_tpu_torch.utils.clock import rfc3339_from_epoch
        breaker = self.scheduler.breaker
        relists = 0
        last_relist = None
        for inf in self._all_informers():
            relists += getattr(inf, "relists", 0)
            lr = getattr(inf, "last_relist", None)
            if lr and (last_relist is None or lr > last_relist):
                last_relist = lr
        return {
            "degradedMode": breaker.mode,
            "degradedIndex": breaker.index,
            "breakerTrips": breaker.trips,
            "breakerTripReasons": dict(breaker.trip_reasons),
            "lastTripReason": breaker.last_trip_reason,
            "breakerRestores": breaker.restores,
            "watchdogRestarts": self._watchdog.restarts,
            "watchRelists": relists,
            "lastRelist": (rfc3339_from_epoch(last_relist)
                           if last_relist else None),
            "loopError": (repr(self.loop_error)
                          if self.loop_error is not None else None),
        }

    def _audit_status(self) -> dict:
        """Auditor + parity-sentinel state for the status ConfigMap
        (``ktpu audit status`` reads this block)."""
        status = self.auditor.status()
        sentinel = self.scheduler.sentinel
        status["parity"] = sentinel.stats() if sentinel is not None else None
        return status

    def _copy_reasons(self) -> dict:
        """Copy ctx_stats['reasons'] from the status thread while the
        scheduling thread may be inserting a first-seen reason key."""
        for _ in range(3):
            try:
                return dict(self.scheduler.ctx_stats["reasons"])
            except RuntimeError:  # resized mid-iteration; rare — retry
                continue
        return {}

    def publish_status(self) -> None:
        """Publish the deployment-shape status ConfigMap (``ktpu status``
        reads it): the batching knobs, the resident context, staging and
        the resilience state, and the active device mesh (its shape,
        device count and devices; null single-device). Best effort —
        status must never take the scheduler down."""
        import json
        mesh = self.scheduler.mesh
        status = {
            "identity": self.identity,
            "mesh": mesh.describe() if mesh is not None else None,
            "batchSize": self.cfg.batch_size,
            "maxDrainBatches": self.cfg.max_drain_batches,
            "pipelineDepth": self.cfg.pipeline_depth,
            # live pipeline depth + resident-context lifecycle counters:
            # degraded fusion (patches climbing instead of folds, rebuild
            # reasons piling up) is visible without a bench run
            "pipelineInflight": len(self.scheduler._pending),
            "fusedFold": self.scheduler._fused_fold,
            "staging": self.cache.staging_stats(),
            "ctx": dict(self.scheduler.ctx_stats,
                        reasons=self._copy_reasons()),
            "profiles": [p.scheduler_name for p in self.cfg.profiles],
            "resilience": self._resilience_status(),
            "audit": self._audit_status(),
            "pending": self.queue.stats(),
            "e2e": self._e2e_status(),
            "explain": (self.scheduler.explainer.stats()
                        if self.scheduler.explainer is not None else None),
            "flight": self._flight_status(),
            "aotCache": self._aot_cache_status(),
            # topology/ slice-carving surface: grid extent, carveable
            # origins per requested shape, fragmentation %, carve counters
            "topology": self.scheduler.topology_status(),
        }
        self._publish_configmap(self.status_name,
                                {"status": json.dumps(status, indent=1)})
        self._publish_trace()

    def _e2e_status(self) -> dict:
        """End-to-end scheduling SLI (flight-recorder-derived histogram)
        for the status ConfigMap."""
        from kubernetes_tpu_torch.metrics.registry import E2E_SCHEDULING
        return {"count": E2E_SCHEDULING.count(),
                "p50Seconds": E2E_SCHEDULING.percentile(0.50),
                "p99Seconds": E2E_SCHEDULING.percentile(0.99)}

    def _aot_cache_status(self):
        """Kernel-cache block for the status ConfigMap. Publishing rides
        the status cadence, so seal here too: libraries built since the
        last seal become checksum-verifiable at the next boot (a cheap
        no-op when the entry set is unchanged)."""
        if self.aot_cache is None:
            return {"enabled": False}
        try:
            self.aot_cache.seal()
            return self.aot_cache.stats()
        except OSError:
            LOOP_ERRORS.inc({"site": "publish_status"})
            _LOG.debug("kernel cache status failed", exc_info=True)
            return {"enabled": True, "error": "stats unavailable"}

    def _flight_status(self) -> dict:
        from kubernetes_tpu_torch.utils.tracing import FLIGHT, TRACER
        st = FLIGHT.stats()
        st["spanDrops"] = TRACER.dropped
        return st

    def _publish_configmap(self, name: str, data: dict) -> None:
        """Create-or-update one of the runner's published ConfigMaps.
        Best effort — publishing must never take the scheduler down."""
        from kubernetes_tpu_torch.utils.configmap import upsert_configmap
        upsert_configmap(self.client, self.status_namespace, name, data,
                         site="publish_status")

    def _publish_explanations(self, explanations: dict) -> None:
        """Explainer-thread callback: the scheduler-explanations ConfigMap.
        One JSON blob keyed by pod key."""
        import json
        import time as _time
        self._publish_configmap(
            self.explain_name,
            {"explanations": json.dumps(explanations),
             "updated": str(_time.time())})

    def publish_trace(self) -> None:
        """Publish the flight-recorder export NOW (``ktpu trace dump``
        freshness; publish_status also refreshes it on the audit cadence)."""
        self._publish_trace()

    def _publish_trace(self) -> None:
        import json
        import time as _time
        from kubernetes_tpu_torch.utils.tracing import TRACER
        try:
            doc = TRACER.export_chrome(max_events=TRACE_PUBLISH_EVENTS,
                                       max_flight_pods=TRACE_PUBLISH_PODS)
        except Exception:
            LOOP_ERRORS.inc({"site": "publish_status"})
            _LOG.debug("trace export failed", exc_info=True)
            return
        self._publish_configmap(
            self.trace_name,
            {"trace": json.dumps(doc), "updated": str(_time.time())})

    def _start_loop(self):
        with self._loop_lock:
            self._start_loop_locked()

    def _start_loop_locked(self):
        # Chain terms: if the previous term's loop is still draining (e.g.
        # stuck in a long run_once when the lease bounced), the new term's
        # thread waits for it rather than stacking a concurrent loop — and
        # rather than silently not starting one, which would leave a
        # leader that schedules nothing until the next transition.
        if self.loop_error is not None:
            _LOG.error("not starting the scheduling loop: it died of %r",
                       self.loop_error)
            return
        prev_t, prev_s = self._loop_thread, self._loop_stop
        stop = threading.Event()

        def term():
            if prev_t is not None and prev_t.is_alive():
                if prev_s is not None:
                    prev_s.set()
                prev_t.join()
            try:
                self.scheduler.run(stop)
            except Exception as e:
                if not is_fatal(e):
                    raise
                # a kernel that fails or counts wrong, a feature not ported
                # yet or a CUDA error: a restart cannot cure any of them.
                # Keep the error, mark the loop not expected (the watchdog
                # must not revive it) and end.
                with self._loop_lock:
                    self.loop_error = e
                    self._loop_expected = False
                LOOP_ERRORS.inc({"site": "loop_fatal"})
                _LOG.critical("scheduling loop stopped for good: %r", e)

        self._loop_expected = True
        self._loop_stop = stop
        self._loop_thread = threading.Thread(target=term, daemon=True,
                                             name="scheduling-loop")
        self._loop_thread.start()
        self._watch_threads()

    def _watch_threads(self) -> None:
        """Arm the watchdog over the loop + resolver threads (idempotent).
        ``_loop_expected`` distinguishes 'a loop should be running' from an
        intentional stop (lost lease, shutdown, a fatal loop error) — a
        watchdog-signaled term stays expected, so the sweep after the
        wedged thread finally exits restarts it."""
        self._watchdog.register(
            "loop",
            is_alive=lambda: (not self._loop_expected
                              or self._stop.is_set()
                              or (self._loop_thread is not None
                                  and self._loop_thread.is_alive())),
            restart=self._revive_loop,
            # an intentionally-stopped loop (standby replica after a lost
            # lease) has no heartbeat to give; stall detection applies
            # only while a loop is supposed to be running
            busy=lambda: (self._loop_expected and not self._stop.is_set()))
        sch = self.scheduler
        self._watchdog.register(
            "resolver",
            is_alive=lambda: (sch._resolver_thread is None
                              or sch._resolver_thread.is_alive()
                              or self._stop.is_set()),
            restart=self._revive_resolver,
            # a resolver with no in-flight drains has nothing to beat about
            busy=lambda: bool(sch._pending))
        self._watchdog.start()

    def _revive_loop(self):
        """Watchdog path. A DEAD loop thread (a BaseException) restarts
        immediately: the resident drain context is tainted — whatever the
        dead thread was mid-way through left the device state
        unaccountable — and a fresh term begins. A STALLED-but-alive
        thread is only SIGNALED to stop: two loops would mutate the
        scheduler's unsynchronized state concurrently (a Python thread
        cannot be killed), so the restart happens on the sweep after the
        wedged thread actually exits. A loop that died of a fatal failure
        (``sched/faults.is_fatal``) is never revived. Returns False when no
        restart actually happened (the watchdog then doesn't count one).
        Runs under the loop lock so a revive can never race a
        leadership-change start/stop."""
        with self._loop_lock:
            if (not self._loop_expected or self._stop.is_set()
                    or self.loop_error is not None):
                # leadership was lost, the runner is stopping, or the loop
                # died of a fault a restart cannot cure
                return False
            t = self._loop_thread
            if t is not None and t.is_alive():
                if self._loop_stop is not None:
                    self._loop_stop.set()
                self.scheduler.taint_ctx()
                return False  # signaled only; restart on a later sweep
            self.scheduler.taint_ctx()
            self._start_loop_locked()
        self.publish_status()
        return True

    def _revive_resolver(self) -> None:
        self.scheduler.restart_resolver()
        self.publish_status()

    def _stop_loop(self):
        with self._loop_lock:
            # intentional stop: the watchdog must not revive
            self._loop_expected = False
            if self._loop_stop is not None:
                self._loop_stop.set()
            t = self._loop_thread
        if t is not None:
            t.join(timeout=5.0)

    def stop(self):
        """Tear down the loop, the auditor, the watchdog and the informers.
        Re-raises the fatal failure that ended the loop, if one did."""
        self._stop.set()
        self._watchdog.stop()
        self.auditor.stop()
        self._stop_loop()
        self.queue.close()
        try:
            self.scheduler.close()
        finally:
            self.factory.stop_all()
        if self.loop_error is not None:
            raise self.loop_error

    def kill(self):
        """Crash simulation (recovery tests): tear the runner down WITHOUT
        the graceful-drain discipline — no resolve of in-flight device
        work, no binder flush, no status publish. Everything the dead
        incarnation assumed-but-never-bound or nominated must be
        reconstructable by a fresh runner from apiserver state alone."""
        self._stop.set()
        self._watchdog.stop()
        self.auditor.stop()
        self._loop_expected = False
        if self._loop_stop is not None:
            self._loop_stop.set()
        self.queue.close()
        self.factory.stop_all()
