"""The resident drain cycle, for tests and ``chip_smoke.py``.

``ResidentDrain`` follows the steady state of the reference scheduler's
drain (``kubernetes_tpu/sched/scheduler.py`` ``_schedule_drain`` and
``warm_drain``) over a ``SchedulerCache``, without pipelining, staging,
mesh, parity sentinel or preemption. One ``cycle`` is:

  1. patch or rebuild: the cache's delta-log entries since the context's
     cursor either are all folds the context already holds (advance), or
     compile into a churn patch (encode/patch.py) that rides this drain
     as ``drain_step``'s ``patch``, or do not fit, and the context is
     rebuilt from a host snapshot (``build_drain_context``);
  2. the pods, in chunks of ``batch_size``, encode against the context's
     meta and pad to ``max_drain_batches`` batches at the context's shapes;
  3. one ``drain_step`` on the device;
  4. the winners are assumed in the cache, and each fold is mirrored into
     the context's ``CtxPatchState`` (slot, row and request of every
     folded pod, in the fold's order), so later patches can address them.

``sched/scheduler.Scheduler`` replaces this harness once
``tests/test_torch_patch.py`` and ``chip_smoke.py``'s resident phase
move to it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from kubernetes_tpu_torch.device import resolve_device
from kubernetes_tpu_torch.encode.patch import (entries_all_folded, fork_meta,
                                               sync_resident_widths)
from kubernetes_tpu_torch.models.gang import (apply_ctx_patch, batch_shapes,
                                              build_drain_context, drain_step,
                                              drain_widths_fit, pad_batch_to,
                                              stack_batches, unify_batches)
from kubernetes_tpu_torch.sched.scheduler import DRAIN_NOM_BUCKET


@dataclass
class Cycle:
    """One cycle's outcome: ``placed`` maps pod key -> node name for every
    pod placed; ``patch`` is the compiled churn patch that rode the drain
    (None: none did); ``rebuilt`` says the context was built anew from a
    host snapshot; ``ms`` is the cycle's host time and ``drain_ms`` the
    part from the ``drain_step`` call to the assignments on the host."""

    placed: dict = field(default_factory=dict)
    rounds: list = field(default_factory=list)
    patch: Optional[dict] = None
    rebuilt: bool = False
    ms: float = 0.0
    drain_ms: float = 0.0

    @property
    def patched(self) -> bool:
        return self.patch is not None


class ResidentDrain:
    """A device-resident drain context over ``cache``.

    ``batch_size`` and ``max_drain_batches``: P and B of every drain
    (``cycle`` takes at most B*P pods). ``slot_headroom``: free
    existing-pod slots a rebuild reserves for the folds of later cycles.
    ``device``: None for the CUDA card. The drain runs the default profile
    (seed 0, LeastAllocated, every filter, 64 rounds at most)."""

    def __init__(self, cache, batch_size: int = 256,
                 max_drain_batches: int = 8, slot_headroom: int = 0,
                 device=None):
        self.cache = cache
        self.P = batch_size
        self.B = max(1, max_drain_batches)
        self.slot_headroom = slot_headroom
        self.device = resolve_device(device)
        self.ctx = None
        self.stats = {"rebuilds": 0, "folds": 0, "unfit": 0, "reasons": {}}
        # the padded batch stack of the last drain_step
        self.last_stack = None
        # False: the rounds run eagerly on the card (comparisons only)
        self.capture = True

    def _reason(self, why: str) -> None:
        r = self.stats["reasons"]
        r[why] = r.get(why, 0) + 1

    def _encode(self, pods, meta):
        """-> (per-chunk PodBatches padded to B, the stacked batch)."""
        chunks = [pods[i:i + self.P] for i in range(0, len(pods), self.P)]
        pbs = [self.cache.encode_pods(c, meta, min_p=self.P) for c in chunks]
        while len(pbs) < self.B:
            # all-invalid batches: their pods propose nothing, and each
            # converges in one round
            pbs.append(pbs[-1].replace(
                pod_valid=np.zeros_like(pbs[-1].pod_valid)))
        return chunks, pbs, stack_batches(unify_batches(pbs))

    def _build(self, ct, meta, nodes, pbs, pb_stack, seq0) -> bool:
        built = build_drain_context(ct, pbs, nom_bucket=DRAIN_NOM_BUCKET,
                                    device=self.device)
        cs = self.cache.patch_state_fork()
        if built is None or cs is None:
            return False
        ct_dev, e0, fill = built
        # extend_cluster may have widened the pod-side buckets past the
        # encoder's: patches must be compiled at the resident widths
        sync_resident_widths(cs, ct_dev)
        self.ctx = {"ct": ct_dev, "e0": e0, "fill_dev": fill,
                    "fill_bound": fill, "meta": fork_meta(meta),
                    "nodes": nodes, "cs": cs, "seq": seq0,
                    "pb_shape": batch_shapes(pb_stack)}
        return True

    def arm(self, sample_pods) -> None:
        """Build the context at the shapes of ``sample_pods`` (the
        reference scheduler's ``warm_drain``), placing nothing."""
        nodes, ct, meta = self.cache.snapshot(
            pending_pods=sample_pods[:self.P],
            slot_headroom=self.slot_headroom)
        if not nodes:
            raise RuntimeError("arm: the cache holds no node")
        chunks = [sample_pods[i * self.P:(i + 1) * self.P]
                  or sample_pods[:self.P] for i in range(self.B)]
        pbs = [self.cache.encode_pods(c, meta, min_p=self.P) for c in chunks]
        if not self._build(ct, meta, nodes, pbs,
                           stack_batches(unify_batches(pbs)),
                           self.cache.last_snapshot_seq()):
            raise RuntimeError("arm: the base epod slots are not packed")

    def cycle(self, pods, nom_target=None) -> Cycle:
        """One drain of ``pods`` (at most B*P). ``nom_target``: pod key ->
        (node name, priority, Pod), the nominee reservations to hold."""
        if len(pods) > self.B * self.P:
            raise ValueError(f"{len(pods)} pods exceed B*P = "
                             f"{self.B * self.P}")
        t0 = time.perf_counter()
        nom_target = dict(nom_target or {})
        out = Cycle()
        ctx, use_ctx, fused = self.ctx, False, None
        if ctx is not None:
            cs = ctx["cs"]
            known = set(ctx["meta"].resources)
            fits = (not cs.tainted
                    and ctx["fill_bound"] + len(pods) <= cs.top
                    and not any(r not in known for p in pods
                                for r in p.resource_requests()))
            if not fits:
                self._reason("tainted" if cs.tainted else "capacity")
            else:
                entries = self.cache.deltas_since(ctx["seq"])
                nom_dirty = (set(nom_target) != set(cs.nom_applied)
                             or any(cs.nom_applied[k][1:] != (n, prio)
                                    for k, (n, prio, _p) in nom_target.items()
                                    if k in cs.nom_applied))
                if entries is None:
                    self._reason("log_window")
                elif not nom_dirty and entries_all_folded(cs, entries):
                    if entries:
                        ctx["seq"] = entries[-1][0] + 1
                    use_ctx = True
                else:
                    new_seq = entries[-1][0] + 1 if entries else ctx["seq"]
                    patch = self.cache.compile_ctx_patch(
                        ctx["meta"], cs, entries, nom_target,
                        DRAIN_NOM_BUCKET, fold_floor=ctx["fill_bound"])
                    # the patch may have moved the slot cursor down: the
                    # fold region of this drain must still clear it
                    if (patch is not None
                            and ctx["fill_bound"] + len(pods) <= cs.top):
                        fused = patch
                        ctx["seq"] = new_seq
                        self.stats["folds"] += 1
                        use_ctx = True
                    elif patch is None:
                        self.stats["unfit"] += 1
                        self._reason("patch_unfit")
                    else:
                        self._reason("capacity")
        if use_ctx:
            meta = ctx["meta"]
        else:
            self.ctx = None
            nodes, ct, meta = self.cache.snapshot(
                pending_pods=pods, slot_headroom=self.slot_headroom)
            seq0 = self.cache.last_snapshot_seq()
            if not nodes:
                out.ms = (time.perf_counter() - t0) * 1e3
                return out
        chunks, pbs, pb_stack = self._encode(pods, meta)
        if not use_ctx:
            if not self._build(ct, meta, nodes, pbs, pb_stack, seq0):
                raise RuntimeError("rebuild: the base epod slots are not "
                                   "packed (host patches left holes)")
            self.stats["rebuilds"] += 1
            out.rebuilt = True
            ctx = self.ctx
            meta = ctx["meta"]
            if nom_target:
                patch = self.cache.compile_ctx_patch(
                    meta, ctx["cs"], [], nom_target, DRAIN_NOM_BUCKET)
                if patch is None:
                    raise RuntimeError("rebuild: the nominee reservations "
                                       "exceed the resident bucket")
                apply_ctx_patch(ctx["ct"], patch)
        else:
            padded = pad_batch_to(pb_stack, ctx["pb_shape"])
            if padded is None or not drain_widths_fit(ctx["ct"], padded):
                self._reason("batch_shape")
                self.ctx = None
                return self.cycle(pods, nom_target)
            pb_stack = padded

        self.last_stack = pb_stack
        t1 = time.perf_counter()
        assignments, rounds, ctx["ct"], ctx["fill_dev"] = drain_step(
            ctx["ct"], pb_stack, ctx["fill_dev"], fused,
            e0=ctx["e0"], topo_keys=meta.topo_keys, capture=self.capture)
        assignments = assignments.cpu().numpy()
        out.drain_ms = (time.perf_counter() - t1) * 1e3
        ctx["fill_bound"] += len(pods)
        out.patch = fused
        out.rounds = rounds.cpu().tolist()
        self._resolve(ctx, chunks, assignments, out)
        out.ms = (time.perf_counter() - t0) * 1e3
        return out

    def _resolve(self, ctx, chunks, assignments, out: Cycle) -> None:
        """Assume the winners and mirror the device fold: they occupy base
        slots [fill_host, fill_host+n) in flattened batch order."""
        names = ctx["meta"].node_names
        to_bind, rows = [], []
        for b, chunk in enumerate(chunks):
            for pod, a in zip(chunk, assignments[b][:len(chunk)]):
                if a >= 0:
                    to_bind.append((pod, names[int(a)]))
                    rows.append(int(a))
        if not to_bind:
            return
        self.cache.assume_many(to_bind)
        cs = ctx["cs"]
        fill = cs.fill_host
        for (pod, node), row in zip(to_bind, rows):
            cs.slot_of[pod.key] = fill
            cs.slot_node[pod.key] = row
            # the request vector is computed lazily, only if the pod is
            # later deleted or rebound
            cs.slot_req[pod.key] = pod
            cs.row_pods[row] = cs.row_pods.get(row, 0) + 1
            cs.folded[pod.key] = node
            fill += 1
            if pod.spec.volumes or pod.host_ports():
                # the fold cannot reproduce this pod's node-side
                # port/volume state: rebuild at the next cycle
                cs.tainted = True
        cs.fill_host = fill
        out.placed = {pod.key: node for pod, node in to_bind}
