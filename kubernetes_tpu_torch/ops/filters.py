"""Feasibility masks — the in-tree Filter plugins as boolean tensor terms.

The PyTorch port of ``kubernetes_tpu/ops/filters.py``. Reference semantics,
plugin by plugin (pkg/scheduler/framework/plugins/):
  NodeUnschedulable  nodeunschedulable/node_unschedulable.go
  NodeName           nodename/node_name.go
  NodeResourcesFit   noderesources/fit.go
  TaintToleration    tainttoleration/taint_toleration.go
  NodeAffinity       nodeaffinity/node_affinity.go (+ nodeSelector)
  NodePorts          nodeports/node_ports.go

Each term is a pure function (ClusterTensors, PodBatch) -> mask [P,N] bool;
`run_filters` ANDs them. Every (pod, node) pair evaluates in one batch of
tensor ops.

Every filter is per node, so on a device mesh (parallel/mesh.py) a shard
runs it on its own node slice. The three that read across nodes say how:
``node_name_mask`` and the nominee reservations of ``fit_mask`` compare
GLOBAL node ids, and ``tenant_local_rank`` ranks the whole node axis.
"""

from __future__ import annotations

import torch

from kubernetes_tpu_torch.encode.snapshot import (
    EMPTY_VALUE_ID,
    TENANT_KEY_ID,
    TOLOPC_EXISTS,
    UNSCHED_TAINT_KEY_ID,
    ClusterTensors,
    PodBatch,
)
from kubernetes_tpu_torch.ops.exprs import eval_term_set, gather_values
from kubernetes_tpu_torch.ops.sorting import lexsort
from kubernetes_tpu_torch.parallel import mesh


# ---- fleet tenancy plane ---------------------------------------------------
# tenant_of_node / tenant_of_pod are the pre-interned TENANT label columns
# of the encodings (encode/snapshot.py TENANT_KEY_ID): -1 = untenanted.
# Hand-built test tensors may carry a narrower key bucket; the helpers then
# degrade to "everything same tenant", which IS the single-tenant semantics.

def tenant_of_node(ct: ClusterTensors):
    """[N] int32 tenant value-id per node, or None when the key bucket
    predates the tenant column (hand-built tensors)."""
    if ct.node_labels.shape[1] <= TENANT_KEY_ID:
        return None
    return ct.node_labels[:, TENANT_KEY_ID]


def tenant_of_pod(pb: PodBatch):
    if pb.pod_labels.shape[1] <= TENANT_KEY_ID:
        return None
    return pb.pod_labels[:, TENANT_KEY_ID]


def tenant_pair_mask(ct: ClusterTensors, pb: PodBatch):
    """[P,N] bool: node n is visible to pod p (same tenant; -1 == -1 keeps
    untenanted clusters fully visible). None = no tenant plane (all same)."""
    tv, pv = tenant_of_node(ct), tenant_of_pod(pb)
    if tv is None or pv is None:
        return None
    return pv[:, None] == tv[None, :]


def tenant_local_rank(ct: ClusterTensors):
    """[N] int32: each node's rank AMONG ITS OWN TENANT'S nodes (insertion
    order). Single-tenant clusters degenerate to ``arange(N)`` exactly, so
    the tie-break in ops/scores.select_host is the node index there, while
    under a fleet a tenant's nodes keep the ranks they would have in a
    standalone cluster. On a mesh shard: the ranks of the shard's nodes
    among the WHOLE node axis (the tenant column is gathered)."""
    tv = tenant_of_node(ct)
    N = ct.node_valid.shape[0]
    dev = ct.node_valid.device
    if tv is None:
        return mesh.node_ids(N, dev).to(torch.int32)
    tv = mesh.gather_nodes(tv)
    rank = _tenant_rank(tv)
    return mesh.node_slice(rank)


def _tenant_rank(tv):
    N = tv.shape[0]
    idx = torch.arange(N, dtype=torch.int32, device=tv.device)
    order = lexsort((idx, tv))              # stable group-by tenant value
    tvs = tv[order]
    seg_start = torch.cat([torch.ones(1, dtype=torch.bool, device=tv.device),
                           tvs[1:] != tvs[:-1]])
    # index within segment = position - position-of-segment-start
    start_pos = torch.where(seg_start, idx, 0)
    start_pos = torch.cummax(start_pos, dim=0).values
    rank_sorted = (idx - start_pos).to(torch.int32)
    out = torch.zeros(N, dtype=torch.int32, device=tv.device)
    out[order] = rank_sorted
    return out


def fit_mask(ct: ClusterTensors, pb: PodBatch):
    """NodeResourcesFit: requests fit into allocatable - requested, per
    resource. Nominated-but-unbound pods (preemption nominees) reserve their
    requests on their nominated node against LOWER-priority pods — the
    RunFilterPluginsWithNominatedPods pass of schedule_one.go, where
    higher-or-equal-priority nominees are added to the node before filtering."""
    free = ct.allocatable - ct.requested              # [N,R]
    fits = torch.all(pb.requests[:, None, :] <= free[None, :, :], dim=-1)
    M = ct.nom_valid.shape[0]
    if M == 0:
        return fits
    # The check lives in nominee-slot space and only the boolean verdict
    # scatters back to [P,N]. The priority dependence collapses to a prefix
    # sum: sort slots by priority desc, cumulate per-node requests along
    # the sorted axis, and index by "how many nominees outrank pod p".
    N = ct.node_valid.shape[0]
    P = pb.priority.shape[0]
    neg_inf = -(1 << 31) + 1
    prio = torch.where(ct.nom_valid, ct.nom_prio, neg_inf)      # [M]
    order = torch.argsort(-prio, stable=True)                   # desc
    prio_s = prio[order]
    node_s = ct.nom_node[order]
    valid_s = ct.nom_valid[order]
    req_s = torch.where(valid_s[:, None], ct.nom_req[order], 0)
    # G[c,m,r]: reservation on slot m's node from the top-c slots
    same = (node_s[:, None] == node_s[None, :]) \
        & valid_s[:, None] & valid_s[None, :]
    contrib = torch.where(same[:, :, None], req_s[:, None, :], 0)  # [M,M,R]
    G = torch.cat([torch.zeros_like(contrib[:1]),
                   torch.cumsum(contrib, dim=0, dtype=torch.int32)])  # [M+1,M,R]
    # count of nominees with priority >= pod p's (sorted-desc prefix len)
    count_p = torch.sum(prio_s[None, :] >= pb.priority[:, None], dim=1)  # [P]
    resv = G[count_p]                                            # [P,M,R]
    # nominee node ids are global: on a mesh shard only the nominees on
    # its own nodes reserve anything here
    cols, own = mesh.own_nodes(node_s, N)
    if own is not None:
        valid_s = valid_s & own
    free_at = free[cols]                                         # [M,R]
    ok = torch.all(pb.requests[:, None, :] + resv <= free_at[None], dim=-1) \
        | ~valid_s[None, :]                                      # [P,M]
    # repeated columns OR together: add the hits, then test > 0
    hits = ((~ok) & valid_s[None, :]).to(torch.int32)
    viol = torch.zeros((P, N), dtype=torch.int32, device=hits.device) \
        .index_add_(1, cols, hits) > 0
    return fits & ~viol


def node_name_mask(ct: ClusterTensors, pb: PodBatch):
    """NodeName: spec.nodeName equality (forced_node -2 = named node unknown)."""
    N = ct.node_valid.shape[0]
    forced = pb.forced_node
    idx = mesh.node_ids(N, forced.device)
    return (forced == -1)[:, None] | (forced[:, None] == idx[None, :])


def _tolerated_any(pb: PodBatch, taint_key, taint_val, taint_effect):
    """[P, *taint_shape] — any toleration of the pod tolerates each taint.

    Reference: v1.Toleration.ToleratesTaint. Toleration arrays are [P,TOL];
    taints broadcast with shape [*taint_shape].
    """
    tshape = (1,) * taint_key.ndim
    shape = tuple(pb.tol_key.shape) + tshape
    tol_key = pb.tol_key.reshape(shape)                              # [P,TOL,1*]
    tol_op = pb.tol_op.reshape(shape)
    tol_val = pb.tol_val.reshape(shape)
    tol_effect = pb.tol_effect.reshape(shape)
    tol_valid = pb.tol_valid.reshape(shape)
    tk = taint_key[None, None]
    key_ok = (tol_key == -1) | (tol_key == tk)
    effect_ok = (tol_effect == -1) | (tol_effect == taint_effect[None, None])
    value_ok = (tol_op == TOLOPC_EXISTS) | (tol_val == taint_val[None, None])
    return torch.any(tol_valid & key_ok & effect_ok & value_ok, dim=1)  # [P,*taint]


def taint_toleration_mask(ct: ClusterTensors, pb: PodBatch):
    """TaintToleration filter: every NoSchedule/NoExecute taint must be tolerated."""
    tol = _tolerated_any(pb, ct.taint_key, ct.taint_val, ct.taint_effect)  # [P,N,T]
    hard = ct.taint_valid & ((ct.taint_effect == 0) | (ct.taint_effect == 2))
    return torch.all(~hard[None] | tol, dim=-1)


def untolerated_prefer_count(ct: ClusterTensors, pb: PodBatch):
    """TaintToleration score input: # of intolerable PreferNoSchedule taints [P,N]."""
    tol = _tolerated_any(pb, ct.taint_key, ct.taint_val, ct.taint_effect)
    soft = ct.taint_valid & (ct.taint_effect == 1)
    return torch.sum(soft[None] & ~tol, dim=-1).to(torch.float32)


def unschedulable_mask(ct: ClusterTensors, pb: PodBatch):
    """NodeUnschedulable: .spec.unschedulable fails unless the pod tolerates the
    synthetic node.kubernetes.io/unschedulable:NoSchedule taint."""
    dev = ct.unschedulable.device
    key = torch.full((1,), UNSCHED_TAINT_KEY_ID, dtype=torch.int32, device=dev)
    val = torch.full((1,), EMPTY_VALUE_ID, dtype=torch.int32, device=dev)
    eff = torch.zeros((1,), dtype=torch.int32, device=dev)  # NoSchedule
    tol = _tolerated_any(pb, key, val, eff)[:, 0]  # [P]
    return ~ct.unschedulable[None, :] | tol[:, None]


def node_affinity_mask(ct: ClusterTensors, pb: PodBatch):
    """NodeAffinity required terms AND spec.nodeSelector (both must hold)."""
    # nodeSelector: AND of exact-match requirements.
    v = gather_values(ct.node_labels, pb.sel_key)          # [N,P,S]
    sel_ok = (v == pb.sel_val[None]) | ~pb.sel_valid[None]
    sel_ok = torch.all(sel_ok, dim=-1)                     # [N,P]
    # required affinity: OR over terms.
    term = eval_term_set(pb.req_terms, ct.node_labels, ct.label_value_num)  # [N,P,T]
    req_ok = torch.any(term, dim=-1) | ~pb.req_terms.has_any[None]          # [N,P]
    return (sel_ok & req_ok).T


def node_ports_mask(ct: ClusterTensors, pb: PodBatch):
    """NodePorts: no (protocol, port, ip) conflict with ports already in use.
    0.0.0.0 (ip id 0) conflicts with every ip."""
    pp = pb.port_port[:, :, None, None]     # [P,PP,1,1]
    np_ = ct.port_port[None, None]          # [1,1,N,PRT]
    port_eq = pp == np_
    proto_eq = pb.port_proto[:, :, None, None] == ct.port_proto[None, None]
    pip = pb.port_ip[:, :, None, None]
    nip = ct.port_ip[None, None]
    ip_clash = (pip == nip) | (pip == 0) | (nip == 0)
    valid = pb.port_valid[:, :, None, None] & ct.port_valid[None, None]
    conflict = torch.any(valid & port_eq & proto_eq & ip_clash, dim=(1, 3))  # [P,N]
    return ~conflict


def volume_mask(ct: ClusterTensors, pb: PodBatch):
    """VolumeBinding + VolumeZone + VolumeRestrictions + NodeVolumeLimits.

    Reference: framework/plugins/{volumebinding,volumezone,volumerestrictions,
    nodevolumelimits}. Constraints arrive pre-compiled as grouped
    node-selector terms (sched/volumebinding.compile_pod_volumes): a node
    passes when every PVC group has >=1 matching term (bound PV's affinity /
    any candidate PV / provisionable match-all), no node-exclusive PV the pod
    mounts is already attached, and the attach-count limit holds.
    """
    term = eval_term_set(pb.vol_terms, ct.node_labels, ct.label_value_num)  # [N,P,T]
    G = pb.vol_group_valid.shape[1]
    if G == 0:
        vol_ok = torch.ones(tuple(pb.pod_valid.shape) + tuple(ct.node_valid.shape),
                            dtype=torch.bool, device=term.device)
    else:
        groups = torch.arange(G, device=term.device)
        grp = (pb.vol_group[None, :, :, None]
               == groups[None, None, None, :])                   # [1,P,T,G]
        sat = torch.any(term[..., None] & grp, dim=2)            # [N,P,G]
        vol_ok = torch.all(sat | ~pb.vol_group_valid[None], dim=-1).T  # [P,N]
    # VolumeRestrictions: node-exclusive PV already in use on that node
    clash = torch.any(
        (pb.rwo_pv[:, None, :, None] == ct.used_rwo[None, :, None, :])
        & pb.rwo_valid[:, None, :, None] & ct.used_rwo_valid[None, :, None, :],
        dim=(2, 3))                                              # [P,N]
    # NodeVolumeLimits
    fits = (ct.attach_used[None, :] + pb.attach_req[:, None]
            <= ct.attach_limit[None, :])                         # [P,N]
    return vol_ok & ~clash & fits


# Ordered registry: name -> mask fn. Relational filters (PodTopologySpread,
# InterPodAffinity) live in ops/topology.py and join in models/schedule_step.
FILTERS = {
    "NodeUnschedulable": unschedulable_mask,
    "NodeName": node_name_mask,
    "NodeResourcesFit": fit_mask,
    "NodeAffinity": node_affinity_mask,
    "TaintToleration": taint_toleration_mask,
    "NodePorts": node_ports_mask,
    "VolumeBinding": volume_mask,
}


def run_filters(ct: ClusterTensors, pb: PodBatch, enabled=None):
    """AND of all enabled filter masks, plus validity gates. -> [P,N] bool.

    The tenant visibility mask is part of the VALIDITY GATE, not the
    pluggable filter set: a profile disabling filters must never be able to
    disable fleet isolation."""
    mask = pb.pod_valid[:, None] & ct.node_valid[None, :]
    tmask = tenant_pair_mask(ct, pb)
    if tmask is not None:
        mask = mask & tmask
    for name, fn in FILTERS.items():
        if enabled is None or name in enabled:
            mask = mask & fn(ct, pb)
    return mask
