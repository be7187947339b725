"""Correctness invariants over one consistent audit snapshot.

Each check is a pure function ``(AuditSnapshot) -> [Violation]`` so the
auditor can run them against a captured state and tests can feed crafted
corruption directly. The paper's state-convergence model makes the
apiserver the source of truth; most invariants therefore judge the API
state itself (overcommit, gang atomicity, nominations) and the rest judge
the scheduler's derived state *against* it (cache parity, resident drain
context parity, double-bind).

Anti-flap: live state is legitimately in flux (binds in flight, informer
lag, gangs mid-bind), so every candidate carries ``confirm`` — the number
of CONSECUTIVE sweeps the same fingerprint must appear before the auditor
reports it. State computed from one consistent API list alone (overcommit,
nominations) can't flap and confirms immediately; cross-source checks need
the discrepancy to survive at least one full sweep interval.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.encode.scaling import UNLIMITED, scale_allocatable, scale_request

_LOG = logging.getLogger(__name__)

GANG_LABEL = "kubernetes-tpu.io/gang"  # descheduler/strategies.py owner
_TERMINAL = ("Succeeded", "Failed")


@dataclass
class Violation:
    invariant: str
    detail: str
    # stable identity across sweeps: the confirm engine counts consecutive
    # sweeps the same fingerprint reappears before reporting
    fingerprint: tuple
    # offending raw objects (pod/node dicts, cache entries) for the bundle
    objects: list = field(default_factory=list)
    confirm: int = 1

    def to_dict(self) -> dict:
        return {"invariant": self.invariant, "detail": self.detail,
                "fingerprint": list(self.fingerprint),
                "objects": self.objects}


@dataclass
class AuditSnapshot:
    """One sweep's worth of state. ``api_pods`` + ``rv`` come from a single
    consistent list (the pods list carries the collection resourceVersion);
    nodes are a second list — acceptable because node identity/allocatable
    churn is orders slower than pod churn. Cache and ctx views are
    dict-copied under the cache lock / GIL respectively, and taken BEFORE
    the API lists: the scheduler assumes a preemptor only after its
    victims' deletes returned, so an assume in the view never meets, in
    the lists that follow, a victim it replaced. Taken after them (as the
    reference does), a sweep can hold a victim listed before its delete
    beside the assume that followed, and report an overcommit that never
    existed."""

    ts: float
    rv: Optional[int]
    api_pods: list  # raw dicts
    api_nodes: list  # raw dicts
    cache: Optional[dict] = None   # SchedulerCache.audit_view()
    ctx: Optional[dict] = None     # Scheduler.audit_ctx_view()
    # keys with cache delta-log entries the resident ctx has not consumed
    # yet — exempt from ctx parity (the ctx is ALLOWED to lag the cache by
    # exactly its unconsumed log suffix); None = log window lost, skip
    ctx_pending_keys: Optional[set] = None

    @classmethod
    def capture(cls, client, cache=None, scheduler=None) -> "AuditSnapshot":
        cache_view = cache.audit_view() if cache is not None else None
        ctx_view = pending = None
        if scheduler is not None:
            ctx_view = scheduler.audit_ctx_view()
            if ctx_view is not None and cache is not None:
                entries = cache.deltas_since(ctx_view["seq"])
                if entries is None:
                    pending = None  # window lost: ctx will rebuild; skip
                else:
                    pending = _delta_keys(entries)
                    if pending is None:
                        ctx_view = None  # a "full" entry: everything dirty
        pods_res = client.resource("pods", None)
        try:
            api_pods, rv = pods_res.list_rv()
        except (AttributeError, TypeError):
            api_pods, rv = pods_res.list(), None
        api_nodes = client.resource("nodes", None).list()
        return cls(ts=time.time(), rv=rv, api_pods=api_pods,
                   api_nodes=api_nodes, cache=cache_view, ctx=ctx_view,
                   ctx_pending_keys=pending)


def delta_pod_keys(entries: list, strict: bool = False) -> Optional[set]:
    """Pod keys named by cache delta-log entries. None when the entries
    make the whole view unjudgeable: a structural ``full`` entry always,
    and any node-level entry too under ``strict`` (the parity sentinel
    judges capacity per node, so pending node churn poisons every
    figure; ctx parity only follows pod keys and can ignore them)."""
    keys: set = set()
    for _seq, op, payload in entries:
        if op == "pod":
            keys.add(payload.key)
        elif op == "poddel":
            keys.add(payload)
        elif op == "assume":
            keys.add(payload[0])
        elif op == "full" or strict:  # node / nodedel only when strict
            return None
    return keys


_delta_keys = delta_pod_keys  # AuditSnapshot.capture's non-strict use


# ---- shared scaled-integer capacity arithmetic ----------------------------
# One implementation feeds BOTH the auditor's overcommit invariant and the
# parity sentinel's whole-set capacity audit: a future change to resource
# scaling or the 'pods' pseudo-resource must not weaken one silently.

def node_alloc_map(nodes) -> dict:
    """Typed Node list -> {name: {resource: scaled allocatable}} in the
    encoder's/oracle's scaled-integer units ('pods' defaults unlimited)."""
    out: dict = {}
    for node in nodes:
        a = {r: scale_allocatable(r, q)
             for r, q in node.allocatable_canonical().items()}
        a.setdefault("pods", UNLIMITED)
        out[node.metadata.name] = a
    return out


def charge_usage(used: dict, node_name: str, requests: dict) -> None:
    """Add one pod (1 toward 'pods' + its scaled requests) to a node's
    usage accumulator. ``Pod.resource_requests`` already holds the 'pods'
    pseudo-resource; it counts once (the reference adds it twice)."""
    u = used.setdefault(node_name, {})
    u["pods"] = u.get("pods", 0) + 1
    for r, q in requests.items():
        if r != "pods":
            u[r] = u.get(r, 0) + scale_request(r, q)


def find_overcommit(alloc: dict, used: dict) -> dict:
    """{node: {resource: (used, cap)}} for every resource whose usage
    exceeds allocatable (nodes absent from ``alloc`` are not judged)."""
    out: dict = {}
    for name, u in used.items():
        a = alloc.get(name)
        if a is None:
            continue
        over = {r: (v, a.get(r, 0)) for r, v in u.items()
                if v > a.get(r, 0)}
        if over:
            out[name] = over
    return out


def _pod_key(p: dict) -> str:
    md = p.get("metadata") or {}
    return f"{md.get('namespace', 'default')}/{md.get('name', '')}"


def _is_terminal(p: dict) -> bool:
    return (p.get("status") or {}).get("phase") in _TERMINAL


def _node_name(p: dict) -> str:
    return (p.get("spec") or {}).get("nodeName") or ""


# ---- invariant: no per-resource node overcommit ---------------------------

def check_node_overcommit(snap: AuditSnapshot) -> list[Violation]:
    """Sum of scheduled, non-terminal pods' requests must fit every node's
    allocatable for EVERY resource (same scaled-integer arithmetic as the
    tensor encoder and the oracle). Pods the scheduler has ASSUMED but not
    yet bound count too — overcommit born from an optimistic assume is
    exactly the silent-wrong-placement class this exists to catch. Each pod
    counts once: the API nodeName wins over a cache assume for the same
    key (a confirm racing the capture must not double-book)."""
    typed_nodes = []
    for nd in snap.api_nodes:
        try:
            typed_nodes.append(Node.from_dict(nd))
        except Exception:  # ktpu-lint: disable=KTL002 -- a sweep over live churn sees torn/undecodable API objects by design; the sweep judges what decodes, the next sweep re-sees the rest
            continue
    alloc = node_alloc_map(typed_nodes)
    used: dict[str, dict] = {}
    holders: dict[str, list] = {}
    seen: set = set()

    def _charge(node_name: str, key: str, requests: dict, obj) -> None:
        if key in seen or node_name not in alloc:
            return
        seen.add(key)
        charge_usage(used, node_name, requests)
        holders.setdefault(node_name, []).append(obj)

    pods_by_key: dict[str, dict] = {}
    for p in snap.api_pods:
        pods_by_key[_pod_key(p)] = p
        if _is_terminal(p) or not _node_name(p):
            continue
        try:
            pod = Pod.from_dict(p)
        except Exception:  # ktpu-lint: disable=KTL002 -- a sweep over live churn sees torn/undecodable API objects by design; the sweep judges what decodes, the next sweep re-sees the rest
            continue
        _charge(_node_name(p), pod.key, pod.resource_requests(), p)
    for key, node_name in ((snap.cache or {}).get("assumed") or {}).items():
        raw = pods_by_key.get(key)
        if raw is None or _is_terminal(raw):
            continue
        try:
            pod = Pod.from_dict(raw)
        except Exception:  # ktpu-lint: disable=KTL002 -- a sweep over live churn sees torn/undecodable API objects by design; the sweep judges what decodes, the next sweep re-sees the rest
            continue
        _charge(node_name, key, pod.resource_requests(), raw)

    out = []
    for name, over in sorted(find_overcommit(alloc, used).items()):
        out.append(Violation(
            "node_overcommit",
            f"node {name}: requested > allocatable for "
            + ", ".join(f"{r} ({v}>{cap})"
                        for r, (v, cap) in sorted(over.items())),
            fingerprint=("node_overcommit", name),
            objects=[{"node": name, "over": {
                r: {"requested": v, "allocatable": cap}
                for r, (v, cap) in over.items()},
                "pods": [_pod_key(h) for h in holders.get(name, [])]}],
            confirm=1))
    return out


# ---- invariant: no double-bind --------------------------------------------

def check_double_bind(snap: AuditSnapshot) -> list[Violation]:
    """The scheduler's view of a pod's node (assumed or cache-bound) must
    agree with the apiserver's. A disagreement means the same pod holds
    capacity on TWO nodes at once — the apiserver's binding is immutable,
    so a persistent mismatch is scheduler-side corruption, never lag."""
    if snap.cache is None:
        return []
    api_node = {}
    for p in snap.api_pods:
        nn = _node_name(p)
        if nn:
            api_node[_pod_key(p)] = nn
    out = []
    for source in ("bound", "assumed"):
        for key, node in (snap.cache.get(source) or {}).items():
            theirs = api_node.get(key)
            if theirs and node and theirs != node:
                out.append(Violation(
                    "double_bind",
                    f"pod {key}: scheduler {source} on {node!r} but the "
                    f"apiserver has it bound to {theirs!r}",
                    fingerprint=("double_bind", key),
                    objects=[{"pod": key, source: node, "api": theirs}],
                    confirm=2))
    return out


# ---- invariant: gang atomicity --------------------------------------------

def check_gang_atomicity(snap: AuditSnapshot) -> list[Violation]:
    """A gang (pods sharing the ``kubernetes-tpu.io/gang`` label) binds
    all-or-nothing; a PARTIALLY bound gang persisting across sweeps means
    the gang step committed half a gang (or half was lost). The confirm
    window is the 'older than one cycle' grace — a gang mid-bind is
    expected to be partial for well under one sweep interval."""
    gangs: dict[str, list] = {}
    for p in snap.api_pods:
        if _is_terminal(p):
            continue
        g = ((p.get("metadata") or {}).get("labels") or {}).get(GANG_LABEL)
        if g:
            gangs.setdefault(g, []).append(p)
    out = []
    for g, members in sorted(gangs.items()):
        bound = [p for p in members if _node_name(p)]
        if bound and len(bound) < len(members):
            out.append(Violation(
                "gang_atomicity",
                f"gang {g!r}: {len(bound)}/{len(members)} members bound",
                fingerprint=("gang_atomicity", g),
                objects=[{"gang": g,
                          "bound": [_pod_key(p) for p in bound],
                          "pending": [_pod_key(p) for p in members
                                      if not _node_name(p)]}],
                confirm=2))
    return out


# ---- invariant: slice contiguity (topology/) -------------------------------

def check_slice_contiguity(snap: AuditSnapshot) -> list[Violation]:
    """A FULLY bound gang that declared a slice shape
    (``kubernetes-tpu.io/slice-shape``) must occupy one CONTIGUOUS torus
    sub-slice of that shape — the whole point of the carver. Judged from
    one consistent API list against the nodes' topology labels
    (topology/slicing.is_contiguous_slice is the truth predicate), so a
    violation cannot flap: confirm=1. Partially bound gangs are
    gang_atomicity's business; members on unlabeled nodes ARE a violation
    here (a slice member off the grid is never contiguous)."""
    from kubernetes_tpu_torch.topology.slicing import (coords_of_labels, grid_dims,
                                                 is_contiguous_slice,
                                                 parse_shape, shape_str)
    node_coords: dict[str, Optional[tuple]] = {}
    for nd in snap.api_nodes:
        md = nd.get("metadata") or {}
        node_coords[md.get("name", "")] = coords_of_labels(md.get("labels"))
    dims = grid_dims([c for c in node_coords.values() if c is not None])
    gangs: dict[str, list] = {}
    shapes: dict[str, tuple] = {}
    for p in snap.api_pods:
        if _is_terminal(p):
            continue
        labels = ((p.get("metadata") or {}).get("labels")) or {}
        shape = parse_shape(labels.get("kubernetes-tpu.io/slice-shape"))
        if shape is None:
            continue
        g = labels.get(GANG_LABEL) or f"pod:{_pod_key(p)}"
        gangs.setdefault(g, []).append(p)
        shapes[g] = shape
    out = []
    for g, members in sorted(gangs.items()):
        if not all(_node_name(p) for p in members):
            continue  # partial gangs belong to gang_atomicity
        shape = shapes[g]
        if len(members) != shape[0] * shape[1] * shape[2]:
            # not a full complement: a gang mid-deletion (members already
            # gone from the API) or mid-creation looks exactly like this
            # from one list — judging it would flap on ordinary churn
            continue
        coords = [node_coords.get(_node_name(p)) for p in members]
        ok = (dims is not None and None not in coords
              and is_contiguous_slice(coords, shape, dims))
        if not ok:
            out.append(Violation(
                "slice_contiguity",
                f"gang {g!r} declares slice {shape_str(shape)} but its "
                f"{len(members)} bound member(s) do not form a contiguous "
                "torus sub-slice",
                fingerprint=("slice_contiguity", g),
                objects=[{"gang": g, "shape": shape_str(shape),
                          "grid": (shape_str(dims) if dims else None),
                          "placements": sorted(
                              {_pod_key(p): [_node_name(p),
                                             node_coords.get(_node_name(p))]
                               for p in members}.items())}],
                confirm=1))
    return out


# ---- invariant: nomination consistency ------------------------------------

def check_nominations(snap: AuditSnapshot) -> list[Violation]:
    """``status.nominatedNodeName`` reserves capacity for a PENDING pod;
    on a bound or terminal pod it is a stale reservation pinning a node
    for nothing. The runner's stale-nomination GC clears these; the
    auditor is the check that the GC (and everyone writing nominations)
    actually converged."""
    out = []
    for p in snap.api_pods:
        nom = (p.get("status") or {}).get("nominatedNodeName")
        if not nom:
            continue
        bound, terminal = bool(_node_name(p)), _is_terminal(p)
        if bound or terminal:
            key = _pod_key(p)
            out.append(Violation(
                "nomination_consistency",
                f"pod {key} is {'terminal' if terminal else 'bound'} but "
                f"still nominates {nom!r}",
                fingerprint=("nomination_consistency", key),
                objects=[{"pod": key, "nominatedNodeName": nom,
                          "nodeName": _node_name(p),
                          "phase": (p.get("status") or {}).get("phase")}],
                confirm=2))
    return out


# ---- invariant: cross-tenant placement ------------------------------------

def _tenant_of(obj: dict) -> Optional[str]:
    from kubernetes_tpu_torch.encode.snapshot import tenant_label_of
    return tenant_label_of((obj.get("metadata") or {}).get("labels"))


def check_cross_tenant(snap: AuditSnapshot) -> list[Violation]:
    """Fleet isolation is a HARD wall: a pod bound (or nominated) onto a
    node carrying a different ``kubernetes-tpu.io/tenant`` label than its
    own is a silent multi-tenancy breach — one tenant's workload consuming
    a sibling's capacity. Judged from one consistent API list (can't
    flap, confirm=1). Untenanted clusters have no tenant labels anywhere
    and the check is a no-op."""
    node_tenant: dict[str, Optional[str]] = {}
    any_tenant = False
    for nd in snap.api_nodes:
        t = _tenant_of(nd)
        node_tenant[(nd.get("metadata") or {}).get("name", "")] = t
        any_tenant = any_tenant or t is not None
    if not any_tenant:
        return []
    out = []
    for p in snap.api_pods:
        if _is_terminal(p):
            continue
        pt = _tenant_of(p)
        key = _pod_key(p)
        for field_, node in (("nodeName", _node_name(p)),
                             ("nominatedNodeName",
                              (p.get("status") or {})
                              .get("nominatedNodeName") or "")):
            if not node or node not in node_tenant:
                continue  # existence is cache_parity's job
            nt = node_tenant[node]
            if nt != pt:
                out.append(Violation(
                    "cross_tenant",
                    f"pod {key} (tenant {pt!r}) {field_}={node!r} "
                    f"belongs to tenant {nt!r}",
                    fingerprint=("cross_tenant", key, field_, node),
                    objects=[{"pod": key, "podTenant": pt, "field": field_,
                              "node": node, "nodeTenant": nt}],
                    confirm=1))
    return out


# ---- invariant: SchedulerCache vs fresh list parity -----------------------

def check_cache_parity(snap: AuditSnapshot) -> list[Violation]:
    """The cache's CONFIRMED state must converge to the apiserver's.
    Assumed pods are excluded (optimism + TTL is their contract); the
    API-ahead direction (a bound pod the informer has not delivered yet)
    gets a longer confirm window since a watch outage legitimately delays
    it — the auditor's caller additionally skips this check while a relist
    is in flight."""
    if snap.cache is None:
        return []
    out = []
    cache_bound = snap.cache.get("bound") or {}
    api_by_key = {_pod_key(p): p for p in snap.api_pods}
    for key, node in cache_bound.items():
        p = api_by_key.get(key)
        if p is None:
            out.append(Violation(
                "cache_parity",
                f"cache-bound pod {key} (on {node!r}) does not exist in "
                "the apiserver",
                fingerprint=("cache_parity", "phantom", key),
                objects=[{"pod": key, "cache": node}], confirm=3))
        # node mismatch is double_bind's job; existence is ours
    cache_nodes = snap.cache.get("nodes") or set()
    api_nodes = {(n.get("metadata") or {}).get("name", "")
                 for n in snap.api_nodes}
    for name in sorted(cache_nodes - api_nodes):
        out.append(Violation(
            "cache_parity",
            f"cache node {name!r} does not exist in the apiserver",
            fingerprint=("cache_parity", "phantom_node", name),
            objects=[{"node": name}], confirm=3))
    for p in snap.api_pods:
        key = _pod_key(p)
        if (_node_name(p) and not _is_terminal(p)
                and key not in cache_bound
                and key not in (snap.cache.get("assumed") or {})):
            out.append(Violation(
                "cache_parity",
                f"apiserver-bound pod {key} (on {_node_name(p)!r}) is "
                "missing from the scheduler cache",
                fingerprint=("cache_parity", "missing", key),
                objects=[{"pod": key, "api": _node_name(p)}],
                confirm=5))
    return out


# ---- invariant: resident drain context vs cache parity --------------------

def check_ctx_parity(snap: AuditSnapshot) -> list[Violation]:
    """The device-resident drain context's host-side fold ledger must be
    explainable as 'the cache, minus the unconsumed delta-log suffix'.
    A folded placement the cache (and the pending log) knows nothing
    about would re-encode differently at the next rebuild — the silent
    divergence the rebuild path can't detect on its own. Tainted
    contexts are exempt: taint IS the declaration that the resident
    state is unaccountable and will rebuild."""
    ctx, cache = snap.ctx, snap.cache
    if ctx is None or cache is None or ctx.get("tainted"):
        return []
    pending = snap.ctx_pending_keys
    if pending is None:
        return []  # log window lost mid-capture: ctx rebuilds anyway
    out = []
    fill_host, fill_bound = ctx.get("fill_host", 0), ctx.get("fill_bound", 0)
    if fill_host < 0 or fill_bound < 0:
        # the fold watermark and the dispatch reservation can never go
        # negative (top, by contrast, is a downward allocation cursor
        # whose relation to the watermark varies across rebuilds — not an
        # invariant observable from here)
        out.append(Violation(
            "ctx_parity",
            f"resident ctx fold accounting negative: fill_host="
            f"{fill_host}, fill_bound={fill_bound}",
            fingerprint=("ctx_parity", "fill", fill_host, fill_bound),
            objects=[{"fill_host": fill_host, "fill_bound": fill_bound}],
            confirm=2))
    known = dict(cache.get("bound") or {})
    known.update(cache.get("assumed") or {})
    for key, node in sorted((ctx.get("folded") or {}).items()):
        if key in pending:
            continue  # the ctx has not consumed this key's deltas yet
        have = known.get(key)
        if have != node:
            out.append(Violation(
                "ctx_parity",
                f"resident ctx folded {key} onto {node!r} but the cache "
                + (f"has it on {have!r}" if have else "does not hold it"),
                fingerprint=("ctx_parity", key, node),
                objects=[{"pod": key, "ctx": node, "cache": have}],
                confirm=2))
    return out


# name -> check; order is report order
ALL_INVARIANTS: list[tuple[str, Callable[[AuditSnapshot], list[Violation]]]] = [
    ("node_overcommit", check_node_overcommit),
    ("double_bind", check_double_bind),
    ("gang_atomicity", check_gang_atomicity),
    ("slice_contiguity", check_slice_contiguity),
    ("nomination_consistency", check_nominations),
    ("cross_tenant", check_cross_tenant),
    ("cache_parity", check_cache_parity),
    ("ctx_parity", check_ctx_parity),
]


def run_invariants(snap: AuditSnapshot,
                   skip: Optional[set] = None) -> list[Violation]:
    """Run every invariant over one snapshot; a check that itself blows up
    is counted as a loud log, never a silent pass-through."""
    out: list[Violation] = []
    for name, fn in ALL_INVARIANTS:
        if skip and name in skip:
            continue
        try:
            out.extend(fn(snap))
        except Exception:
            _LOG.exception("invariant check %r failed", name)
    return out
