"""Scheduler cache — cluster state aggregation + assume/expire + snapshots.

The PyTorch port of ``kubernetes_tpu/sched/cache.py``. Reference:
``pkg/scheduler/internal/cache/cache.go`` (``cacheImpl``:
AssumePod/FinishBinding/ForgetPod/UpdateSnapshot with generation counters).

The expensive artifact is not per-node NodeInfo structs but the encoded
ClusterTensors. ``snapshot()`` re-encodes only when the cluster generation
moved (any node/pod add/update/remove or assume/forget), and the persistent
SnapshotEncoder keeps intern tables stable across snapshots. The ordered
delta log feeds the device-resident drain context's churn patches
(encode/patch.py).

The staging arena (sched/staging.py) stages drain batches for the
scheduler's ``device``: pinned host buffers and a side CUDA stream on the
card, the plain conversion on the CPU; under a device mesh (``set_mesh``,
parallel/mesh.py) it stages one copy of the stack on each of the mesh's
devices (``presplit_stack``). DRA objects (``update_dra_object``) feed a ``DraCatalog``
(sched/dra.py) that the encoder turns into ``dra:<class>`` columns of the
resource axis, as in the reference.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np
import torch

from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.encode.convert import patch_to
from kubernetes_tpu_torch.encode.patch import compile_patch, fork_patch_state
from kubernetes_tpu_torch.encode.snapshot import (TENANT_LABEL, ClusterTensors,
                                                  SnapshotEncoder, SnapshotMeta)


# churn headroom of the encoding (the reference's KTPU_NODE_HEADROOM,
# KTPU_VALUE_HEADROOM and KTPU_NS_HEADROOM defaults): free node rows absorb
# node ADDs as device patches, spare label-value ids absorb the new values
# they intern (every node interns its own name), and spare namespace ids
# keep fresh namespaces from widening the NSB bucket — without them any such
# event would overflow its bucket and force a rebuild
NODE_HEADROOM = 64
VALUE_HEADROOM = 256
NS_HEADROOM = 16


class SchedulerCache:
    def __init__(self, assume_ttl: float = 30.0):
        self._lock = threading.Lock()
        # Serializes ENCODER work (snapshot/encode_pods/patch compile): the
        # state lock above stays cheap for informer handlers.
        self._encode_lock = threading.Lock()
        self._nodes: dict[str, Node] = {}  # guarded by: self._lock
        self._pods: dict[str, Pod] = {}  # guarded by: self._lock
        self._assumed: dict[str, tuple[Pod, float]] = {}  # guarded by: self._lock
        self._generation = 0  # guarded by: self._lock
        self._encoder = SnapshotEncoder()
        self._encoder.node_headroom = NODE_HEADROOM
        self._encoder.value_headroom = VALUE_HEADROOM
        self._encoder.ns_headroom = NS_HEADROOM
        self._cached: Optional[tuple[int, ClusterTensors, SnapshotMeta]] = None  # guarded by: self._lock
        self.assume_ttl = assume_ttl
        self._volumes = None  # guarded by: self._lock (VolumeCatalog once any PVC/PV/SC appears)
        self._dra = None      # guarded by: self._lock (DraCatalog once any resource.k8s.io object appears)
        self._namespace_labels: dict[str, dict] = {}  # guarded by: self._lock
        # incremental-snapshot delta tracking (Cache.UpdateSnapshot analog):
        # pod churn accumulates here and patches the cached encoding in place;
        # anything structural (node add/remove, volumes) forces a full encode.
        self._delta_upserts: dict[str, Pod] = {}  # guarded by: self._lock
        self._delta_deletes: set[str] = set()  # guarded by: self._lock
        self._needs_full = True  # guarded by: self._lock
        # ---- ordered delta LOG for the device-resident drain context ----
        # Every encoding-relevant mutation appends (seq, op, payload); the
        # drain context replays entries since its last-consumed seq as
        # device-side patches (encode/patch.py) instead of dying on any
        # foreign change. Bounded; a consumer older than the window rebuilds.
        self._dlog: list[tuple] = []  # guarded by: self._lock
        self._dlog_start = 0   # guarded by: self._lock (seq of _dlog[0])
        self._dlog_seq = 0     # guarded by: self._lock (seq of the NEXT entry)
        self._snap_seq = 0     # guarded by: self._lock (log seq captured with the last snapshot)
        self._dlog_max = 100_000
        # encode-relevant node fingerprints: heartbeats that only touch
        # status/conditions must not invalidate the encoding at all
        self._node_fps: dict[str, tuple] = {}  # guarded by: self._lock
        self._full_encodes = 0  # guarded by: self._lock
        # double-buffered batch staging (sched/staging.py): batch K+1
        # stages on the background stager thread while batch K's host work
        # finishes; dispatch redeems a buffer swap. configure_staging (the
        # scheduler, from SchedulerConfiguration.staging_arena) switches it
        # and names the device the drains run on.
        from kubernetes_tpu_torch.sched.staging import StagingArena
        self._arena = StagingArena()
        self._staging_enabled = True
        self._device = torch.device("cpu")
        self._mesh = None

    # ---- device and staging ----------------------------------------------

    def set_mesh(self, mesh) -> None:
        """Stage drain batches for ``mesh`` (parallel/mesh.py; None: the
        scheduler's device). Tickets staged for the old layout are
        invalidated: a redeem after a reshape stages inline, for the new
        one."""
        self._mesh = mesh
        self._arena.invalidate()

    @property
    def mesh(self):
        return self._mesh

    def configure_staging(self, enabled: bool, device=None) -> None:
        """Arena switch, and the device staged batches and patches go to
        (``None`` keeps the current one)."""
        self._staging_enabled = bool(enabled)
        if device is not None and torch.device(device) != self._device:
            self._device = torch.device(device)
            self._arena.invalidate()

    def stage_submit(self, pb_stack):
        """Hand the final stacked drain batch to the staging arena: the
        stager thread uploads it while the scheduling thread finishes the
        cycle's host work. Returns a ticket for stage_redeem, or None
        (arena off, or the double buffer full) — the dispatch then stages
        inline."""
        if not self._staging_enabled:
            return None
        return self._arena.submit(pb_stack, self._device, mesh=self._mesh)

    def stage_redeem(self, ticket):
        """Redeem a stage_submit ticket: the staged batch, ordered on the
        current stream, or None (invalidated/failed/timed out — caller
        stages inline)."""
        if ticket is None:
            return None
        return self._arena.redeem(ticket, self._device, mesh=self._mesh)

    def close_staging(self) -> None:
        self._arena.close()

    def stage_drain_batch(self, pb_stack):
        """INLINE staging of a stacked drain batch [B,P,...]: the fallback
        half of the staging pair (the steady state redeems a stage_submit
        ticket instead)."""
        from kubernetes_tpu_torch.metrics.registry import STAGE_BYTES
        from kubernetes_tpu_torch.sched.staging import _tree_nbytes
        if self._mesh is not None:
            from kubernetes_tpu_torch.parallel.mesh import presplit_stack
            staged = presplit_stack(self._mesh, pb_stack)
        else:
            staged = pb_stack.to(self._device)
        STAGE_BYTES.inc({"path": "inline"}, by=_tree_nbytes(pb_stack))
        return staged

    def stage_patch(self, patch):
        """A compiled churn patch's host arrays (~KB) on the device, one
        copy per key (``convert.patch_to``), before the dispatch that
        consumes them."""
        if patch is None:
            return None
        return patch_to(patch, self._device)

    def staging_stats(self) -> dict:
        """Arena health for status and bench legs."""
        return dict(self._arena.stats(), enabled=self._staging_enabled)

    # ---- delta log (drain-context patch feed) ----------------------------

    def _log_locked(self, op: str, payload):
        self._dlog.append((self._dlog_seq, op, payload))
        self._dlog_seq += 1
        if len(self._dlog) > self._dlog_max:
            drop = len(self._dlog) // 2
            del self._dlog[:drop]
            self._dlog_start += drop

    def deltas_since(self, seq: int):
        """Log entries with sequence >= ``seq`` in order, or None when the
        window no longer reaches back that far (consumer must rebuild)."""
        with self._lock:
            if seq < self._dlog_start:
                return None
            return self._dlog[seq - self._dlog_start:]

    def log_seq(self) -> int:
        with self._lock:
            return self._dlog_seq

    def last_snapshot_seq(self) -> int:
        """The log seq captured atomically with the last snapshot's state:
        a context built from that snapshot starts consuming here."""
        with self._lock:
            return self._snap_seq

    # ---- volume catalog (PVC/PV/StorageClass informers feed this) --------

    def update_volume_object(self, kind: str, obj: dict, deleted: bool = False):
        """Track PVC/PV/StorageClass state for the VolumeBinding tensors."""
        from kubernetes_tpu_torch.sched.volumebinding import VolumeCatalog
        with self._lock:
            if self._volumes is None:
                self._volumes = VolumeCatalog()
            md = obj.get("metadata") or {}
            if kind == "PersistentVolumeClaim":
                key = (md.get("namespace", "default"), md.get("name", ""))
                space = self._volumes.pvcs
            elif kind == "PersistentVolume":
                key = md.get("name", "")
                space = self._volumes.pvs
            else:
                key = md.get("name", "")
                space = self._volumes.storage_classes
            if deleted:
                space.pop(key, None)
            else:
                space[key] = obj
            self._encoder.set_volumes(self._volumes)
            self._generation += 1
            self._needs_full = True
            self._log_locked("full", None)

    @property
    def volume_catalog(self):
        with self._lock:
            return self._volumes

    # ---- DRA objects (resource.k8s.io informers feed this) ---------------

    def update_dra_object(self, kind: str, obj: dict, deleted: bool = False):
        """Track ResourceClaim/DeviceClass/ResourceSlice state; device
        classes become dra:<class> resources in the next encoding.

        Claim STATUS churn (allocation/reservedFor — which the scheduler
        itself writes on every bind of a claimed pod) must not invalidate
        the cluster encoding: pod batches read the live catalog at encode
        time, and the cluster tensors only depend on claim SPECS (bound
        pods' demands), slices, and the class set."""
        from kubernetes_tpu_torch.sched.dra import DraCatalog
        with self._lock:
            if self._dra is None:
                self._dra = DraCatalog()
            md = obj.get("metadata") or {}
            if kind == "ResourceClaim":
                key = (md.get("namespace", "default"), md.get("name", ""))
                space = self._dra.claims
            elif kind == "DeviceClass":
                key = md.get("name", "")
                space = self._dra.classes
            elif kind == "ResourceSlice":
                key = md.get("name", "")
                space = self._dra.slices
            else:
                return
            old = space.get(key)
            if deleted:
                if space.pop(key, None) is None:
                    return
            else:
                space[key] = obj
            if (kind == "ResourceClaim" and old is not None and not deleted
                    and DraCatalog.claim_demands(old)
                    == DraCatalog.claim_demands(obj)):
                # status-only change: encoding-neutral. Checked BEFORE
                # set_dra — the scheduler writes claim status on every bind
                # of a claimed pod, and letting that bump the encoder's pod
                # epoch would invalidate the whole precompile cache per
                # bind (the catalog object is shared and already mutated
                # in place above, so skipping set_dra loses nothing).
                return
            self._encoder.set_dra(self._dra)
            self._generation += 1
            self._needs_full = True
            self._log_locked("full", None)

    @property
    def dra_catalog(self):
        with self._lock:
            return self._dra

    # ---- namespace labels (Namespace informer feeds this) ----------------

    def update_namespace(self, obj: dict, deleted: bool = False):
        """Track namespace labels so affinity terms' namespaceSelector
        resolves at encode time (GetNamespaceLabelsSnapshot analog)."""
        with self._lock:
            md = obj.get("metadata") or {}
            name = md.get("name", "")
            if deleted:
                old = self._namespace_labels.pop(name, None)
                if old is None:
                    return
                tenants = {(old or {}).get(TENANT_LABEL)}
            else:
                new = dict(md.get("labels") or {})
                old = self._namespace_labels.get(name)
                if old == new:
                    return  # label-neutral churn: keep the encoding valid
                self._namespace_labels[name] = new
                # per-tenant catalog-epoch discipline: nsSelector resolution
                # is tenant-scoped, so only the touched tenants' precompiled
                # pod records go stale (old AND new tenant when relabelled)
                tenants = {new.get(TENANT_LABEL),
                           (old or {}).get(TENANT_LABEL)}
            self._encoder.set_namespaces(self._namespace_labels,
                                         changed_tenants=tenants)
            self._generation += 1
            # Pod batches always read the fresh snapshot at encode time; the
            # CLUSTER encoding only goes stale if an existing pod's anti term
            # actually resolved a namespaceSelector against the old labels.
            if self._encoder.cluster_depends_on_namespace_labels:
                self._needs_full = True
                self._log_locked("full", None)

    # ---- node events -----------------------------------------------------

    @staticmethod
    def _node_fp(node: Node) -> tuple:
        """Fingerprint of the encode-relevant node fields; status-only churn
        (heartbeat conditions) leaves it unchanged."""
        return (
            tuple(sorted(node.status.allocatable.items())),
            tuple(sorted(node.metadata.labels.items())),
            tuple((t.key, t.value, t.effect) for t in node.spec.taints),
            node.spec.unschedulable,
            tuple((tuple(i.names[:1]), i.size_bytes)
                  for i in node.status.images),
        )

    def add_node(self, node: Node):
        with self._lock:
            fp = self._node_fp(node)
            prev = self._node_fps.get(node.metadata.name)
            self._nodes[node.metadata.name] = node
            if prev == fp:
                return  # heartbeat-only update: encoding unaffected
            self._node_fps[node.metadata.name] = fp
            self._generation += 1
            self._needs_full = True
            self._log_locked("node", node)

    def update_node(self, node: Node):
        self.add_node(node)

    def remove_node(self, name: str):
        with self._lock:
            if self._nodes.pop(name, None) is not None:
                self._node_fps.pop(name, None)
                self._generation += 1
                self._needs_full = True
                self._log_locked("nodedel", name)

    # ---- pod events ------------------------------------------------------

    def add_pod(self, pod: Pod):
        """Bound pod observed (informer). Confirms an assume if present.

        Confirmation of an assume on the SAME node is encoding-neutral: the
        assume already patched this pod into the tensors, and nothing the
        encoder reads (node, namespace, labels, requests) changes between
        the assumed copy and the watch-confirmed object — so the cached
        encoding stays valid and the confirm costs a dict move.

        STATUS-only churn on an already-bound pod is encoding-neutral too
        (the pod twin of the node-fingerprint check): kubelets rewrite
        ``status`` on every sync; the encoder reads labels + spec only, so
        equality there keeps the encoding valid; the stored object still
        refreshes."""
        with self._lock:
            if not pod.spec.node_name:
                return
            prior = self._assumed.pop(pod.key, None)
            old = self._pods.get(pod.key)
            self._pods[pod.key] = pod
            if prior is not None:
                ap = prior[0]
                if (ap.spec.node_name == pod.spec.node_name
                        and ap.metadata.labels == pod.metadata.labels
                        and pod.key not in self._delta_deletes):
                    return  # pure confirmation: encoding unaffected
            elif (old is not None and pod.key not in self._delta_deletes
                    and old.metadata.labels == pod.metadata.labels
                    and old.spec.to_dict() == pod.spec.to_dict()):
                return  # status-only update: encoding unaffected
            self._generation += 1
            self._delta_upserts[pod.key] = pod
            self._delta_deletes.discard(pod.key)
            self._log_locked("pod", pod)
            # bound: it will never pass through encode_pods again
            self._encoder.pod_cache_discard(pod.key)

    def update_pod(self, pod: Pod):
        self.add_pod(pod)

    def confirm(self, pod_key: str, node_name: str, labels: dict,
                spec: Optional[dict] = None) -> bool:
        """Fast-path bind confirmation: promote the assumed copy to bound
        when the watch event matches it — the dict-level twin of add_pod's
        pure-confirmation branch. ``spec``: the event's raw spec dict; when
        given, it must equal the assumed copy's spec (nodeName aside) or
        the promotion is refused. Returns False when there is nothing to
        confirm (caller falls back to add_pod)."""
        with self._lock:
            prior = self._assumed.get(pod_key)
            if prior is None or pod_key in self._delta_deletes:
                return False
            ap = prior[0]
            if ap.spec.node_name != node_name or ap.metadata.labels != labels:
                return False
            if spec is not None:
                mine = ap.spec.to_dict()
                mine.pop("nodeName", None)
                theirs = {k: v for k, v in spec.items() if k != "nodeName"}
                if mine != theirs:
                    return False
            del self._assumed[pod_key]
            self._pods[pod_key] = ap
            self._encoder.pod_cache_discard(pod_key)
            return True

    def is_bound(self, pod_key: str) -> bool:
        """True if the pod is recorded as bound (confirmed via watch)."""
        with self._lock:
            return pod_key in self._pods

    def is_assumed_or_bound(self, pod_key: str) -> bool:
        """True if the pod holds capacity (assumed OR confirmed) — the
        mid-cycle rescue path must not requeue a pod whose placement this
        very cycle already committed."""
        with self._lock:
            return pod_key in self._pods or pod_key in self._assumed

    def remove_pod(self, pod_key: str):
        with self._lock:
            existed = self._pods.pop(pod_key, None) or self._assumed.pop(pod_key, None)
            self._encoder.pod_cache_discard(pod_key)
            if existed:
                self._generation += 1
                self._delta_upserts.pop(pod_key, None)
                self._delta_deletes.add(pod_key)
                self._log_locked("poddel", pod_key)

    # ---- optimistic binding ---------------------------------------------

    def assume(self, pod: Pod, node_name: str):
        """Optimistically treat the pod as bound NOW (AssumePod); the binding
        confirms via add_pod or expires after assume_ttl. Stores a two-level
        copy (new Pod + new spec): the caller's pod object stays unbound so
        a failed binding can requeue it cleanly."""
        with self._lock:
            p = dataclasses.replace(
                pod, spec=dataclasses.replace(pod.spec, node_name=node_name))
            self._assumed[p.key] = (p, time.time() + self.assume_ttl)
            self._generation += 1
            self._delta_upserts[p.key] = p
            self._delta_deletes.discard(p.key)
            self._log_locked("assume", (p.key, node_name, p))
            self._encoder.pod_cache_discard(p.key)

    def assume_many(self, pairs: list) -> None:
        """assume() for a whole drain's winners in ONE lock pass.
        ``pairs``: [(Pod, node_name)]. Advances the generation by exactly
        len(pairs)."""
        with self._lock:
            deadline = time.time() + self.assume_ttl
            for pod, node_name in pairs:
                p = dataclasses.replace(
                    pod, spec=dataclasses.replace(pod.spec,
                                                  node_name=node_name))
                self._assumed[p.key] = (p, deadline)
                self._delta_upserts[p.key] = p
                self._delta_deletes.discard(p.key)
                self._log_locked("assume", (p.key, node_name, p))
                self._encoder.pod_cache_discard(p.key)
            self._generation += len(pairs)

    def forget(self, pod_key: str):
        """Binding failed: drop the assumption (ForgetPod)."""
        with self._lock:
            if self._assumed.pop(pod_key, None):
                self._generation += 1
                self._delta_upserts.pop(pod_key, None)
                self._delta_deletes.add(pod_key)
                self._log_locked("poddel", pod_key)

    def finish_binding(self, pod_key: str):
        """Binding RPC done; keep assumed until the watch confirms (TTL holds)."""

    def _expire_assumed_locked(self):
        now = time.time()
        expired = [k for k, (_, dl) in self._assumed.items() if dl < now]
        for k in expired:
            del self._assumed[k]
            self._delta_upserts.pop(k, None)
            self._delta_deletes.add(k)
            self._log_locked("poddel", k)
        if expired:
            self._generation += 1

    # ---- snapshot --------------------------------------------------------

    def snapshot(self, pending_pods: Optional[list[Pod]] = None,
                 slot_headroom: int = 0):
        """-> (nodes list, ClusterTensors, SnapshotMeta), host (numpy).

        Three paths, mirroring ``Cache.UpdateSnapshot``:
          clean     — nothing changed: return the cached encoding.
          pod delta — only pod binds/unbinds since the last snapshot: patch
                      the cached arrays (apply_pod_deltas, copy-on-write).
          full      — structural change (node add/remove/relabel, volumes,
                      bucket overflow, new resource kind): re-encode.

        ``pending_pods`` widen the resource axis; passing a batch with a new
        extended resource forces the full path (rare).

        State is COLLECTED under the state lock, then the encode runs under
        the ENCODE lock only, so informer handlers never wait on an encode;
        deltas that arrive mid-encode stay queued for the next snapshot."""
        with self._encode_lock:
            return self._snapshot_serialized(pending_pods, slot_headroom)

    def _export_gauges_locked(self):
        from kubernetes_tpu_torch.metrics.registry import (
            CACHE_FULL_ENCODES,
            CACHE_GENERATION,
            ENCODE_POD_CACHE_HITS,
            ENCODE_POD_CACHE_MISSES,
            ENCODE_POD_ROWS_FILLED,
            ENCODE_POD_ROWS_STACKED,
        )
        CACHE_GENERATION.set(self._generation)
        CACHE_FULL_ENCODES.set(self._full_encodes)
        ENCODE_POD_CACHE_HITS.set(self._encoder.pod_cache_hits)
        ENCODE_POD_CACHE_MISSES.set(self._encoder.pod_cache_misses)
        ENCODE_POD_ROWS_STACKED.set(self._encoder.pod_rows_stacked)
        ENCODE_POD_ROWS_FILLED.set(self._encoder.pod_rows_filled)

    def _snapshot_serialized(self, pending_pods, slot_headroom):
        with self._lock:
            self._expire_assumed_locked()
            self._export_gauges_locked()
            self._snap_seq = self._dlog_seq
            nodes = list(self._nodes.values())
            gen = self._generation
            cached = self._cached
            needs_full = self._needs_full
            upserts = deletes = None
            bound = None
            if cached is not None and not needs_full:
                _, ct0, meta0 = cached
                known = set(meta0.resources)
                widen = any(r not in known for p in (pending_pods or [])
                            for r in p.resource_requests())
                if not widen:
                    if not self._delta_upserts and not self._delta_deletes:
                        return nodes, ct0, meta0
                    upserts = list(self._delta_upserts.values())
                    deletes = list(self._delta_deletes)
                    self._delta_upserts.clear()
                    self._delta_deletes.clear()
            if upserts is None:
                bound = (list(self._pods.values())
                         + [p for p, _ in self._assumed.values()])
                self._delta_upserts.clear()
                self._delta_deletes.clear()

        # ---- encode outside the state lock ------------------------------
        if upserts is not None:
            _, ct0, meta0 = cached
            patched = self._encoder.apply_pod_deltas(ct0, meta0, upserts,
                                                     deletes)
            if patched is not None:
                with self._lock:
                    self._cached = (gen, patched, meta0)
                return nodes, patched, meta0
            # patch didn't fit the buckets: fall through to a full encode,
            # folding the popped deltas back into the bound view
            with self._lock:
                bound = (list(self._pods.values())
                         + [p for p, _ in self._assumed.values()])
                self._delta_upserts.clear()
                self._delta_deletes.clear()
        ct, meta = self._encoder.encode_cluster(nodes, bound,
                                                pending_pods=pending_pods,
                                                slot_headroom=slot_headroom)
        with self._lock:
            self._cached = (gen, ct, meta)
            if self._generation == gen:
                self._needs_full = False
            self._full_encodes += 1
            self._export_gauges_locked()
        return nodes, ct, meta

    def patch_state_fork(self):
        """CtxPatchState forked from the encoder's post-encode bookkeeping
        (encode/patch.py) — the drain context's private slot/row maps."""
        with self._encode_lock:
            return fork_patch_state(self._encoder._patch)

    def compile_ctx_patch(self, meta, cs, entries, nom_target: dict,
                          nom_bucket: int, fold_floor: int = 0):
        """compile_patch under the encode lock (interning is shared with
        snapshot/encode_pods and must not interleave)."""
        with self._encode_lock:
            return compile_patch(self._encoder, meta, cs, entries,
                                 nom_target, nom_bucket,
                                 fold_floor=fold_floor)

    def encode_pods(self, pods: list[Pod], meta: SnapshotMeta,
                    min_p: int = 1, cache_rows: bool = True):
        with self._encode_lock:
            return self._encoder.encode_pods(pods, meta, min_p=min_p,
                                             cache_rows=cache_rows)

    def precompile_pod(self, pod: Pod) -> None:
        """Informer-event-time half of the incremental encode: compile the
        pod's encode record NOW (watch thread) so the drain's encode_pods
        later is array-fill only. NON-BLOCKING on the encode lock — if the
        scheduling loop is mid-encode, skipping is strictly better than
        convoying the watch thread behind the encode."""
        if not self._encode_lock.acquire(blocking=False):
            return
        try:
            self._encoder.precompile_pod(pod)
        except Exception:  # ktpu-lint: disable=KTL002 -- best-effort warm-up; encode_pods recompiles this pod authoritatively on the hot path, so a precompile failure costs latency, never correctness
            pass
        finally:
            self._encode_lock.release()

    def encode_cache_stats(self) -> dict[str, int]:
        """Hit/miss counters of the pod compile cache plus the row-pack
        assembly split (a healthy connected run shows hits >> misses and
        rows_stacked >> rows_filled)."""
        return {"hits": self._encoder.pod_cache_hits,
                "misses": self._encoder.pod_cache_misses,
                "rows_stacked": self._encoder.pod_rows_stacked,
                "rows_filled": self._encoder.pod_rows_filled}

    def overlay_nominated(self, ct, meta, entries, min_m: int = 0):
        """ct with nominated-pod reservations applied (encoder.with_nominated);
        entries: [(node_name, priority, Pod)]."""
        with self._encode_lock:
            return self._encoder.with_nominated(ct, meta, entries,
                                                min_m=min_m)

    def request_vector(self, pod: Pod, resources: list) -> np.ndarray:
        """One pod's scaled request vector on ``resources`` — the same
        ``_request_vector`` the encode and patch paths use."""
        with self._encode_lock:
            return self._encoder._request_vector(pod, resources)

    def request_full_encode(self) -> None:
        """Make the next snapshot a full encode. The resident planners ask
        for one when a node-group template declines because the encoder's
        intern tables outgrew a resident bucket (label keys, values,
        images): only a full encode sizes the buckets from those tables, and
        a static fleet makes no structural change that would bring one.
        The ``full`` log entry also tells the drain context to rebuild."""
        with self._lock:
            self._generation += 1
            self._needs_full = True
            self._log_locked("full", None)

    def with_encoder(self, fn):
        """Run ``fn(encoder)`` under the encode lock — the resident
        planners (encode/overlay.py) encode derived pod batches and build
        template planes against the LIVE encoder's intern tables, which
        must not interleave with snapshot/overlay work on other threads."""
        with self._encode_lock:
            return fn(self._encoder)

    def bound_pods(self, include_assumed: bool = True) -> list[Pod]:
        with self._lock:
            out = list(self._pods.values())
            if include_assumed:
                out += [p for p, _ in self._assumed.values()]
            return out

    def audit_view(self) -> dict:
        """One-lock-pass consistent view for the invariant auditor:
        confirmed-bound and assumed placements (key -> node), the node-name
        set, and the generation. Plain values only — the auditor runs on
        its own thread and must never hold references that alias the
        cache's mutable state."""
        with self._lock:
            return {
                "bound": {k: p.spec.node_name
                          for k, p in self._pods.items()},
                "assumed": {k: p.spec.node_name
                            for k, (p, _dl) in self._assumed.items()},
                "nodes": set(self._nodes),
                "generation": self._generation,
            }

    def get_node(self, name: str) -> Optional[Node]:
        """Cheap single-node lookup; avoids a full snapshot from
        non-scheduling threads."""
        with self._lock:
            return self._nodes.get(name)

    def list_nodes(self) -> list[Node]:
        """Plain node list WITHOUT an encode pass — the oracle fallback
        path reads typed objects only, so a broken device layer never
        stands between it and the cluster state."""
        with self._lock:
            return list(self._nodes.values())

    def namespace_labels(self) -> dict[str, dict]:
        """Namespace -> labels view (the oracle's namespaceSelector
        resolution source)."""
        with self._lock:
            return dict(self._namespace_labels)

    def delta_info(self) -> tuple[int, set, bool, bool]:
        """-> (generation, pending upsert keys, any deletes pending,
        needs_full)."""
        with self._lock:
            return (self._generation, set(self._delta_upserts),
                    bool(self._delta_deletes), self._needs_full)

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {"nodes": len(self._nodes), "pods": len(self._pods),
                    "assumed": len(self._assumed),
                    "generation": self._generation,
                    "full_encodes": self._full_encodes}
