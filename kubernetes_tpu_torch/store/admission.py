"""Admission control — mutating/validating plugin chain + policy rules.

Reference: ``staging/src/k8s.io/apiserver/pkg/admission/`` (two-phase chain:
all mutating plugins, then all validating), built-ins from
``plugin/pkg/admission/``:
  DefaultTolerationSeconds  defaulttolerationseconds/admission.go — add 300s
                            not-ready/unreachable NoExecute tolerations
  PodPriority               priority/admission.go — resolve priorityClassName
                            to spec.priority via PriorityClass objects
  ResourceQuota             resourcequota/admission.go — enforce per-namespace
                            hard limits against live usage
  LimitRanger               limitranger/admission.go — default container
                            requests from LimitRange objects
and ``ValidatingAdmissionPolicy`` (CEL upstream) as a small field-path
expression engine with the same match-conditions shape.

Every plugin is ``fn(verb, kind, obj) -> obj`` raising AdmissionError to
reject — the signature APIServer.admission already dispatches.
"""

from __future__ import annotations

import itertools
import logging
import operator
import threading
import time
from typing import Any, Callable, Optional

from kubernetes_tpu_torch.api.resource import canonical
from kubernetes_tpu_torch.store.apiserver import AdmissionError

from kubernetes_tpu_torch.store.store import ObjectStore

_LOG = logging.getLogger(__name__)

DEFAULT_TOLERATION_SECONDS = 300
_AUTO_TOLERATIONS = ("node.kubernetes.io/not-ready",
                     "node.kubernetes.io/unreachable")


class AdmissionChain:
    """Ordered mutating plugins then validating plugins, as one callable."""

    wants_subresource = True  # threads the subresource to webhook dispatch
    wants_dry_run = True  # and the dry-run flag (webhooks' sideEffects)

    def __init__(self):
        self.mutating: list[Callable] = []
        self.validating: list[Callable] = []

    @staticmethod
    def _invoke(fn, verb, kind, obj, sub, dry_run=False):
        if getattr(fn, "wants_dry_run", False):
            return fn(verb, kind, obj, sub, dry_run=dry_run)
        if getattr(fn, "wants_subresource", False):
            return fn(verb, kind, obj, sub)
        return fn(verb, kind, obj)

    def __call__(self, verb: str, kind: str, obj: dict, sub=None,
                 dry_run: bool = False) -> dict:
        hooks = []
        try:
            for fn in self.mutating:
                r = self._invoke(fn, verb, kind, obj, sub, dry_run)
                if callable(r):
                    hooks.append(r)
                elif r:
                    obj = r
            for fn in self.validating:
                out = self._invoke(fn, verb, kind, obj, sub, dry_run)
                if callable(out):  # two-phase plugin: commit hook (see _admit)
                    hooks.append(out)
                elif out is not None and out is not obj:
                    raise AdmissionError(
                        f"validating plugin {getattr(fn, '__name__', fn)!r} mutated")
        except Exception:
            # a later plugin denied: earlier plugins' reservations must not
            # linger until their TTL (a quota hold would phantom-count 30s)
            for h in hooks:
                try:
                    h(False)
                except Exception:
                    _LOG.debug("admission rollback hook failed",
                               exc_info=True)
            raise
        if hooks:
            obj.setdefault("\x00admission_commits", []).extend(hooks)
        return obj

    def install(self, server) -> "AdmissionChain":
        server.admission.append(self)
        return self


# ---------------------------------------------------------------- mutating

def default_toleration_seconds(verb: str, kind: str, obj: dict):
    """Every pod tolerates not-ready/unreachable for 300s unless it already
    addresses those taints (defaulttolerationseconds/admission.go)."""
    if kind != "Pod" or verb not in ("CREATE",):
        return obj
    spec = obj.setdefault("spec", {})
    tols = list(spec.get("tolerations") or [])
    for key in _AUTO_TOLERATIONS:
        if any(t.get("key") == key or (not t.get("key") and
                                       t.get("operator") == "Exists")
               for t in tols):
            continue
        tols.append({"key": key, "operator": "Exists", "effect": "NoExecute",
                     "tolerationSeconds": DEFAULT_TOLERATION_SECONDS})
    spec["tolerations"] = tols
    return obj


def pod_priority_resolver(store: ObjectStore):
    """priorityClassName -> spec.priority (priority/admission.go)."""
    def resolve(verb: str, kind: str, obj: dict):
        if kind != "Pod" or verb != "CREATE":
            return obj
        spec = obj.setdefault("spec", {})
        name = spec.get("priorityClassName", "")
        if not name:
            return obj
        try:
            pc = store.get("PriorityClass", "", name)
        except Exception:
            raise AdmissionError(f"no PriorityClass with name {name} found") \
                from None
        spec["priority"] = int(pc.get("value", 0))
        return obj
    return resolve


def limit_ranger(store: ObjectStore):
    """Default container requests from the namespace LimitRange
    (limitranger/admission.go, type Container defaultRequest)."""
    def default_requests(verb: str, kind: str, obj: dict):
        if kind != "Pod" or verb != "CREATE":
            return obj
        ns = (obj.get("metadata") or {}).get("namespace", "default")
        items, _ = store.list("LimitRange", namespace=ns)
        defaults: dict[str, Any] = {}
        for lr in items:
            for lim in (lr.get("spec") or {}).get("limits") or []:
                if lim.get("type", "Container") == "Container":
                    defaults.update(lim.get("defaultRequest") or {})
        if not defaults:
            return obj
        for c in (obj.get("spec") or {}).get("containers") or []:
            res = c.setdefault("resources", {})
            req = res.setdefault("requests", {})
            for r, q in defaults.items():
                req.setdefault(r, q)
        return obj
    return default_requests


# --------------------------------------------------------------- validating

QUOTA_TRACKED = ("cpu", "memory", "pods")


def _pod_usage(obj: dict) -> dict[str, int]:
    use = {"pods": 1}
    for c in (obj.get("spec") or {}).get("containers") or []:
        for r, q in ((c.get("resources") or {}).get("requests") or {}).items():
            if r in QUOTA_TRACKED:
                use[r] = use.get(r, 0) + canonical(r, q)
    return use


def resource_quota(store: ObjectStore):
    """Enforce ResourceQuota.spec.hard against live namespace usage
    (resourcequota/admission.go; usage recomputed per decision — the
    controller-cached usage status is an optimization we skip).

    Admission returns before the pod is persisted, so an admitted-but-not-
    yet-visible pod reserves its usage in ``inflight`` under a UNIQUE token
    (names are useless here: generateName pods have none yet) and returns a
    commit hook the apiserver invokes once the create commits or fails —
    releasing the reservation exactly when the pod becomes countable in the
    store listing. Racing creates see each other's reservations and cannot
    jointly exceed the quota; a 30s TTL backstops crashed request paths."""
    lock = threading.Lock()
    seq = itertools.count()
    inflight: dict[tuple, tuple[dict, float]] = {}  # (ns,tok) -> (usage, ts)

    def enforce(verb: str, kind: str, obj: dict):
        if kind != "Pod" or verb != "CREATE":
            return None
        ns = (obj.get("metadata") or {}).get("namespace", "default")
        quotas, _ = store.list("ResourceQuota", namespace=ns)
        if not quotas:
            return None
        with lock:  # serialize check-then-admit so racing creates can't slip past
            pods, _ = store.list("Pod", namespace=ns)
            now = time.time()
            for k in list(inflight):
                if now - inflight[k][1] > 30.0:
                    del inflight[k]
            used: dict[str, int] = {}
            for p in pods:
                if (p.get("status") or {}).get("phase") in ("Succeeded", "Failed"):
                    continue
                for r, v in _pod_usage(p).items():
                    used[r] = used.get(r, 0) + v
            for (res_ns, _tok), (u, _ts) in inflight.items():
                if res_ns == ns:
                    for r, v in u.items():
                        used[r] = used.get(r, 0) + v
            want = _pod_usage(obj)
            for q in quotas:
                hard = (q.get("spec") or {}).get("hard") or {}
                for r, lim in hard.items():
                    key = r.split("requests.", 1)[-1]
                    if key not in want:
                        continue
                    if used.get(key, 0) + want[key] > canonical(key, lim):
                        raise AdmissionError(
                            f"exceeded quota: {q['metadata']['name']}, "
                            f"requested: {key}={want[key]}, "
                            f"used: {key}={used.get(key, 0)}, "
                            f"limited: {key}={canonical(key, lim)}")
            token = (ns, next(seq))
            inflight[token] = (want, now)

        def release(ok: bool):
            with lock:
                inflight.pop(token, None)
        return release
    return enforce


# ----------------------------------------------------- policy engine (CEL-ish)

_OPS = {"==": operator.eq, "!=": operator.ne, ">": operator.gt,
        "<": operator.lt, ">=": operator.ge, "<=": operator.le,
        "in": lambda a, b: a in b, "exists": lambda a, b: a is not None}


def _field(obj: dict, path: str):
    cur: Any = obj
    for part in path.split("."):
        if isinstance(cur, list):
            try:
                cur = cur[int(part)]
                continue
            except (ValueError, IndexError):
                return None
        if not isinstance(cur, dict):
            return None
        cur = cur.get(part)
    return cur


class ValidatingPolicy:
    """ValidatingAdmissionPolicy analog: match kinds + rule list.

    Rules: {"field": "spec.replicas", "op": "<=", "value": 10,
            "message": "..."}. The reference expresses these in CEL; the
    field-path/op/value triple covers the same match shape without an
    expression VM.
    """

    def __init__(self, name: str, kinds: tuple[str, ...],
                 rules: list[dict], verbs: tuple[str, ...] = ("CREATE", "UPDATE")):
        self.name = name
        self.kinds = kinds
        self.rules = rules
        self.verbs = verbs
        self.__name__ = f"policy/{name}"

    def __call__(self, verb: str, kind: str, obj: dict):
        if kind not in self.kinds or verb not in self.verbs:
            return None
        for rule in self.rules:
            got = _field(obj, rule["field"])
            op = _OPS[rule.get("op", "==")]
            try:
                ok = op(got, rule.get("value"))
            except TypeError:
                ok = False
            if not ok:
                raise AdmissionError(
                    rule.get("message",
                             f"policy {self.name}: {rule['field']} "
                             f"{rule.get('op')} {rule.get('value')} violated"))
        return None


def default_chain(store: ObjectStore) -> AdmissionChain:
    """The default plugin set, in upstream enablement order: built-in
    mutators, then MutatingAdmissionWebhook; ValidatingAdmissionWebhook
    before ResourceQuota LAST (the reference's AllOrderedPlugins tail —
    quota must only be charged for objects the webhooks already allowed,
    or a slow/denying webhook pins phantom reservations)."""
    from kubernetes_tpu_torch.store.webhooks import (MutatingWebhooks,
                                               ValidatingWebhooks)
    chain = AdmissionChain()
    chain.mutating += [
        pod_priority_resolver(store),
        default_toleration_seconds,
        limit_ranger(store),
        MutatingWebhooks(store),
    ]
    from kubernetes_tpu_torch.store.podsecurity import pod_security
    # PodSecurity before the webhooks (upstream runs it among the
    # built-ins; a policy-rejected pod must not reach external hooks)
    chain.validating += [pod_security(store), ValidatingWebhooks(store),
                         resource_quota(store)]
    return chain
