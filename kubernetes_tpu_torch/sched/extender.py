"""Scheduler extender — delegate filter/prioritize/bind to external services.

The PyTorch port of ``kubernetes_tpu/sched/extender.py`` (host-only: stdlib
``urllib`` and numpy; unchanged but for its imports). Reference:
``pkg/scheduler/extender.go`` (``HTTPExtender``): the scheduler POSTs JSON
to configured webhook verbs during the scheduling cycle — ``ExtenderArgs``
out, ``ExtenderFilterResult``/``HostPriorityList`` back — letting an
external process veto nodes, add weighted scores, or own the binding for
pods it manages. Wire shapes mirror
``staging/src/k8s.io/kube-scheduler/extender/v1/types.go``.

Device integration: extender calls are host-side HTTP, so their results
enter the device program as a per-batch feasibility mask [P,N] ANDed into
the filter output and a score overlay [P,N] added before selection — the
same position in the cycle as the reference's ``findNodesThatPassExtenders``
/ extender prioritize contributions.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import Optional

from kubernetes_tpu_torch.api.types import Pod

# extender scores are 0..10 (extender/v1 MaxExtenderPriority); the reference
# rescales them by weight before merging with plugin scores
MAX_EXTENDER_PRIORITY = 10


@dataclass
class ExtenderConfig:
    """config Extender (kube-scheduler/config/v1 Extender)."""

    url_prefix: str
    filter_verb: str = ""          # "" = extender does not filter
    prioritize_verb: str = ""
    bind_verb: str = ""
    weight: float = 1.0
    node_cache_capable: bool = False  # send node names instead of full nodes
    ignorable: bool = False        # errors skip the extender vs fail the pod
    timeout_s: float = 5.0
    # only pods requesting at least one of these resources are sent; empty =
    # every pod (ManagedResources semantics)
    managed_resources: list[str] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict) -> "ExtenderConfig":
        return cls(
            url_prefix=d.get("urlPrefix", ""),
            filter_verb=d.get("filterVerb", ""),
            prioritize_verb=d.get("prioritizeVerb", ""),
            bind_verb=d.get("bindVerb", ""),
            weight=float(d.get("weight", 1)),
            node_cache_capable=bool(d.get("nodeCacheCapable", False)),
            ignorable=bool(d.get("ignorable", False)),
            timeout_s=float(d.get("httpTimeout", 5)),
            managed_resources=_parse_managed(d.get("managedResources") or []),
        )


def _parse_managed(entries: list) -> list[str]:
    """managedResources: [{"name": ...}] or bare strings; anything else is a
    config error rejected at parse time, not at scheduling time."""
    out = []
    for r in entries:
        if isinstance(r, dict):
            if "name" not in r:
                raise ValueError(f"managedResources entry missing 'name': {r}")
            out.append(str(r["name"]))
        else:
            out.append(str(r))
    return out


class ExtenderError(RuntimeError):
    pass


class HTTPExtender:
    """One configured extender endpoint (extender.go HTTPExtender)."""

    def __init__(self, cfg: ExtenderConfig):
        self.cfg = cfg

    # -- plumbing ----------------------------------------------------------

    def _post(self, verb: str, payload: dict) -> dict:
        url = self.cfg.url_prefix.rstrip("/") + "/" + verb
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=self.cfg.timeout_s) as r:
                return json.loads(r.read() or b"{}")
        except (urllib.error.URLError, OSError, ValueError) as e:
            raise ExtenderError(f"extender {url}: {e}") from e

    def is_interested(self, pod: Pod) -> bool:
        """IsInterested: pods requesting none of the managed resources skip
        this extender entirely."""
        if not self.cfg.managed_resources:
            return True
        reqs = pod.resource_requests()
        return any(r in reqs for r in self.cfg.managed_resources)

    @staticmethod
    def _name(n) -> str:
        return n if isinstance(n, str) else n.metadata.name

    def _args(self, pod: Pod, nodes: list) -> dict:
        """``nodes``: Node objects (preferred) or bare names. Non-cache-
        capable extenders get FULL node objects — that mode exists for
        extenders without their own node watch (extender.go)."""
        args = {"pod": pod.to_dict()}
        if self.cfg.node_cache_capable:
            args["nodenames"] = [self._name(n) for n in nodes]
        else:
            args["nodes"] = {"items": [
                {"metadata": {"name": n}} if isinstance(n, str) else n.to_dict()
                for n in nodes]}
        return args

    # -- verbs -------------------------------------------------------------

    def filter(self, pod: Pod, nodes: list) -> list[str]:
        """-> surviving node names. Raises ExtenderError on transport failure
        AND on a result-level ``error`` — both are extender failures subject
        to the caller's ``ignorable`` policy (findNodesThatPassExtenders)."""
        result = self._post(self.cfg.filter_verb, self._args(pod, nodes))
        if result.get("error"):
            raise ExtenderError(
                f"extender {self.cfg.url_prefix}: {result['error']}")
        if result.get("nodenames") is not None:
            return list(result["nodenames"])
        items = ((result.get("nodes") or {}).get("items")) or []
        return [(n.get("metadata") or {}).get("name", "") for n in items]

    def prioritize(self, pod: Pod, nodes: list) -> dict[str, float]:
        """-> node name -> weighted score contribution."""
        result = self._post(self.cfg.prioritize_verb, self._args(pod, nodes))
        out = {}
        for hp in (result if isinstance(result, list) else
                   result.get("hostPriorityList") or []):
            out[hp.get("host", "")] = float(hp.get("score", 0)) * self.cfg.weight
        return out

    def bind(self, pod: Pod, node_name: str) -> bool:
        """ExtenderBindingArgs -> ExtenderBindingResult."""
        result = self._post(self.cfg.bind_verb, {
            "podName": pod.metadata.name,
            "podNamespace": pod.metadata.namespace,
            "podUID": pod.metadata.uid,
            "node": node_name})
        return not result.get("error")


def run_extenders(extenders: list[HTTPExtender], pods: list[Pod],
                  nodes: list):
    """Host-side extender pass for one batch. ``nodes``: Node objects (or
    bare names in tests).

    -> (mask [P,N] bool | None, scores [P,N] float32 | None,
        errors set[int]): the feasibility AND-mask and weighted score
    overlay for the device program (None when no extender applied — keeps
    the no-extender trace unchanged), plus the batch indices of pods whose
    NON-ignorable extender call failed. Those are attempt ERRORS, not
    unschedulability — the caller must requeue them without running
    preemption (the reference fails the scheduling cycle for them).
    Prioritize errors are always ignored (prioritizeNodesWithExtenders
    logs and continues). Per-pod extender chains are independent, so pods
    fan out on a thread pool — wall time is bounded by the slowest single
    chain, not the sum.
    """
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor
    if not extenders:
        return None, None, set()
    node_names = [HTTPExtender._name(n) for n in nodes]
    by_name = dict(zip(node_names, nodes))
    P, N = len(pods), len(nodes)
    mask = np.ones((P, N), bool)
    scores = np.zeros((P, N), np.float32)
    idx = {n: i for i, n in enumerate(node_names)}

    def one_pod(pod):
        """-> (surviving names, {node: score}, filtered?, error?)"""
        surviving = list(node_names)
        filtered = False
        contrib: dict[str, float] = {}
        for ext in extenders:
            if not ext.is_interested(pod):
                continue
            if ext.cfg.filter_verb:
                try:
                    returned = ext.filter(pod, [by_name[n] for n in surviving])
                    seen: set = set()
                    surviving = []
                    for n in returned:
                        if n in idx and n not in seen:
                            seen.add(n)
                            surviving.append(n)
                    filtered = True
                except ExtenderError:
                    if ext.cfg.ignorable:
                        continue
                    return [], {}, False, True
            if ext.cfg.prioritize_verb:
                try:
                    got = ext.prioritize(pod, [by_name[n] for n in surviving])
                    for n, s in got.items():
                        if n in idx:
                            contrib[n] = contrib.get(n, 0.0) + s
                except ExtenderError:
                    pass  # prioritize errors never fail the pod
        return surviving, contrib, filtered, False

    with ThreadPoolExecutor(max_workers=min(16, max(P, 1))) as pool:
        results = list(pool.map(one_pod, pods))

    any_mask = any_score = False
    errors: set[int] = set()
    for p_i, (surviving, contrib, filtered, err) in enumerate(results):
        if err:
            errors.add(p_i)
            continue
        if filtered:
            any_mask = True
            row = np.zeros(N, bool)
            row[[idx[n] for n in surviving]] = True
            mask[p_i] = row
        if contrib:
            any_score = True
            for n, s in contrib.items():
                scores[p_i, idx[n]] += s
    return (mask if any_mask else None), (scores if any_score else None), errors


def extender_binder(extenders: list[HTTPExtender]):
    """-> binder(pod, node) -> bool | None: delegates to the first interested
    extender with a bindVerb; None = no extender claims it (use the default
    binder)."""
    binders = [e for e in extenders if e.cfg.bind_verb]

    def maybe_bind(pod: Pod, node_name: str):
        for ext in binders:
            if ext.is_interested(pod):
                try:
                    return ext.bind(pod, node_name)
                except ExtenderError:
                    return False
        return None
    return maybe_bind
