"""Per-filter-output variant of the filter program — decision provenance.

The PyTorch port of ``kubernetes_tpu/models/explain.py`` (B10 in ROADMAP
Queue B): an XLA program in the reference, torch ops here; it reaches the
``count_pn`` kernel through the relational masks whenever a pod carries
hard relational terms.

The hot path (models/schedule_step.py) ANDs every plugin mask into one
feasibility tensor and reduces it to a winner index, discarding the
per-(filter, pod, node) verdicts that upstream's ``framework.Status``
carries through ``findNodesThatFitPod``. This module recovers them OFF the
hot path: ``explain_step`` runs the same static filter stack but KEEPS each
filter's [P,N] mask, stacked to [F,P,N] — one batched call over only the
pods being explained (sched/explainer.py drives it from a background
thread; the drain cycle never calls it).

Host-side helpers turn the stack into upstream-shaped artifacts:
``first_fail`` mirrors the oracle's short-circuit order (the FIRST failing
filter per node is "the" reason, exactly what ``_filter_one`` returns), and
``failed_scheduling_message`` renders the kube-scheduler event string
("0/N nodes are available: 3 Insufficient resources, ...").
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetes_tpu_torch.encode.snapshot import ClusterTensors, PodBatch
from kubernetes_tpu_torch.ops import topology
from kubernetes_tpu_torch.ops.filters import FILTERS, tenant_pair_mask
from kubernetes_tpu_torch.sched.oracle import FailReason

# Static filter stack in the ORACLE'S check order (sched/oracle.py
# _filter_one short-circuits in this order, so first-fail verdicts align
# bit-for-bit). Tenant visibility comes FIRST — it is part of run_filters'
# validity gate, not a disableable plugin, and the oracle checks it before
# anything else. FILTERS preserves the order for the in-tree masks; the
# relational filters follow, spread before inter-pod, as in the oracle.
EXPLAIN_FILTERS: tuple[str, ...] = ("Tenant",) + tuple(FILTERS) + (
    "PodTopologySpread", "InterPodAffinity")

# filter name -> the upstream-style reason fragment its rejections render
# as (FailReason strings double as the oracle's verdict vocabulary, which
# keeps the parity tests string-exact).
FILTER_MESSAGES: dict[str, str] = {
    "Tenant": FailReason.TENANT,
    "NodeUnschedulable": FailReason.UNSCHEDULABLE,
    "NodeName": FailReason.NODE_NAME,
    "NodeResourcesFit": FailReason.RESOURCES,
    "NodeAffinity": FailReason.AFFINITY,
    "TaintToleration": FailReason.TAINT,
    "NodePorts": FailReason.PORTS,
    "VolumeBinding": FailReason.VOLUME,
    "PodTopologySpread": FailReason.SPREAD,
    "InterPodAffinity": FailReason.POD_AFFINITY,
    # oracle-judge-only pseudo-filter (topology/): slice-shaped pods judged
    # via the oracle carver's coverage plane — not in EXPLAIN_FILTERS (the
    # tensor judge's stack), but failed_scheduling_message renders it
    "SliceCarve": FailReason.SLICE_UNAVAILABLE,
}

# oracle reason string -> filter name (both inter-pod reasons collapse to
# the one InterPodAffinity plugin, as upstream's plugin registry does).
REASON_TO_FILTER: dict[str, str] = {
    FailReason.TENANT: "Tenant",
    FailReason.UNSCHEDULABLE: "NodeUnschedulable",
    FailReason.NODE_NAME: "NodeName",
    FailReason.RESOURCES: "NodeResourcesFit",
    FailReason.AFFINITY: "NodeAffinity",
    FailReason.TAINT: "TaintToleration",
    FailReason.PORTS: "NodePorts",
    FailReason.VOLUME: "VolumeBinding",
    FailReason.SPREAD: "PodTopologySpread",
    FailReason.POD_AFFINITY: "InterPodAffinity",
    FailReason.POD_ANTI_AFFINITY: "InterPodAffinity",
    FailReason.SLICE_UNAVAILABLE: "SliceCarve",
}


def explain_step(ct: ClusterTensors, pb: PodBatch,
                 topo_keys: tuple[int, ...] = (),
                 enabled: tuple[str, ...] | None = None):
    """-> (verdicts [F,P,N] bool, valid [P,N] bool): each enabled filter's
    mask in EXPLAIN_FILTERS order (disabled filters pass everywhere, like
    run_filters skipping them), plus the pod/node validity gate. ``ct``
    and ``pb`` are on one device; the masks are computed there."""
    def _on(name: str) -> bool:
        return enabled is None or name in enabled

    valid = pb.pod_valid[:, None] & ct.node_valid[None, :]
    outs = []
    for name in EXPLAIN_FILTERS:
        if name == "Tenant":
            # validity-gate member: never disabled by a profile
            tmask = tenant_pair_mask(ct, pb)
            outs.append(torch.ones_like(valid) if tmask is None else tmask)
        elif not _on(name):
            outs.append(torch.ones_like(valid))
        elif name == "PodTopologySpread":
            outs.append(topology.spread_mask(ct, pb, topo_keys))
        elif name == "InterPodAffinity":
            outs.append(topology.interpod_required_mask(ct, pb, topo_keys)
                        & topology.interpod_symmetry_mask(ct, pb, topo_keys))
        else:
            outs.append(FILTERS[name](ct, pb))
    return torch.stack(outs), valid


def first_fail(verdicts: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """[P,N] int32: index into EXPLAIN_FILTERS of the FIRST failing filter
    per (pod, node) — the oracle's short-circuit verdict — or -1 where the
    node is feasible, -2 where the (pod, node) slot is padding."""
    fails = ~np.asarray(verdicts, bool)                       # [F,P,N]
    any_fail = fails.any(axis=0)
    idx = np.argmax(fails, axis=0).astype(np.int32)
    idx = np.where(any_fail, idx, np.int32(-1))
    return np.where(np.asarray(valid, bool), idx, np.int32(-2))


def reject_histogram(ff_row: np.ndarray) -> dict[str, int]:
    """One pod's first-fail row [N] -> {filter name: node count} (feasible
    and padding slots excluded)."""
    counts = np.bincount(ff_row[ff_row >= 0],
                         minlength=len(EXPLAIN_FILTERS))
    return {EXPLAIN_FILTERS[i]: int(c)
            for i, c in enumerate(counts) if c}


def failed_scheduling_message(n_nodes: int, hist: dict[str, int],
                              feasible_now: int = 0,
                              unjudged: int = 0) -> str:
    """The kube-scheduler FailedScheduling event string: "0/N nodes are
    available: 3 Insufficient resources, 2 node(s) had untolerated
    taint." — counts descending, ties broken by filter order.
    ``feasible_now``: nodes the re-run found feasible (the cluster moved
    between the failed cycle and the explanation) get their own clause
    instead of silently vanishing from the arithmetic. ``unjudged``:
    nodes whose verdict the explainer could not honestly render (the
    oracle judge rejected them only via a filter the profile disables,
    hiding any later check)."""
    order = {f: i for i, f in enumerate(EXPLAIN_FILTERS)}
    parts = [f"{c} {FILTER_MESSAGES.get(f, f)}"
             for f, c in sorted(hist.items(),
                                key=lambda kv: (-kv[1], order.get(kv[0], 99)))]
    if feasible_now:
        parts.append(f"{feasible_now} node(s) became feasible after the "
                     "failed cycle")
    if unjudged:
        parts.append(f"{unjudged} node(s) not judged (profile disables "
                     "the rejecting filter)")
    body = ", ".join(parts) if parts else (
        "no nodes in the cluster" if n_nodes == 0
        else "no verdict available")
    return f"0/{n_nodes} nodes are available: {body}."
