"""External admission webhooks — HTTP(S) transport for the admission chain.

Reference: ``staging/src/k8s.io/apiserver/pkg/admission/plugin/webhook/``
(mutating + validating dispatchers) and the admission/v1 wire types
(``staging/src/k8s.io/api/admission/v1/types.go``): the apiserver POSTs an
``AdmissionReview`` carrying the object, the webhook answers
``{response: {uid, allowed, status, patch}}`` where a mutating webhook's
patch is a base64 RFC-6902 JSON Patch. Configuration objects
(``MutatingWebhookConfiguration`` / ``ValidatingWebhookConfiguration``,
admissionregistration.k8s.io/v1) live in the store like any resource; the
dispatchers re-read them on a short poll so registering a webhook takes
effect without an apiserver restart (upstream watches the same configs).

failurePolicy semantics (per webhook, default ``Fail``): a transport error
or timeout DENIES the request under ``Fail`` and is skipped under
``Ignore``. ``timeoutSeconds`` (default 10) bounds each call.

Dry run (``?dryRun=All``) follows upstream's dispatcher: a webhook whose
``sideEffects`` is not ``None`` or ``NoneOnDryRun`` is never called for a
dry-run request, which is refused with 400 whatever the failurePolicy.
"""

from __future__ import annotations

import base64
import json
import threading
import time
import urllib.request
from typing import Callable, Optional

from kubernetes_tpu_torch.store.apiserver import AdmissionError
from kubernetes_tpu_torch.store.store import ObjectStore

_CONFIG_POLL_S = 1.0  # config freshness window (upstream watches; we poll)
_DRY_RUN_SAFE = ("None", "NoneOnDryRun")  # sideEffects a dry run may call


# ------------------------------------------------------------- JSON Patch

def apply_json_patch(obj: dict, patch: list) -> dict:
    """RFC 6902 subset: add / replace / remove with /-escaped pointers
    (``~1`` = ``/``, ``~0`` = ``~``; trailing ``-`` appends to a list).
    The reference applies exactly this to mutating webhook responses."""
    import copy
    out = copy.deepcopy(obj)
    for op in patch:
        kind = op.get("op")
        parts = [p.replace("~1", "/").replace("~0", "~")
                 for p in op.get("path", "").split("/")[1:]]
        parent = out
        for p in parts[:-1]:
            parent = parent[int(p)] if isinstance(parent, list) else parent.setdefault(p, {})
        leaf = parts[-1] if parts else ""
        if kind in ("add", "replace"):
            if isinstance(parent, list):
                if leaf == "-":
                    parent.append(op.get("value"))
                elif kind == "add":
                    parent.insert(int(leaf), op.get("value"))
                else:
                    parent[int(leaf)] = op.get("value")
            else:
                parent[leaf] = op.get("value")
        elif kind == "remove":
            if isinstance(parent, list):
                del parent[int(leaf)]
            else:
                parent.pop(leaf, None)
        else:
            raise AdmissionError(f"unsupported patch op {kind!r}")
    return out


# ------------------------------------------------------------- transport

def _call_webhook(url: str, review: dict, timeout_s: float) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(review).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        return json.loads(resp.read())


def _review(verb: str, kind: str, obj: dict, uid: str) -> dict:
    from kubernetes_tpu_torch.store.apiserver import KIND_TO_GROUP
    md = obj.get("metadata") or {}
    return {
        "apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
        "request": {
            "uid": uid,
            "kind": {"group": KIND_TO_GROUP.get(kind, ""),
                     "version": "v1", "kind": kind},
            "operation": verb,
            "name": md.get("name", ""),
            "namespace": md.get("namespace", ""),
            "object": obj,
        },
    }


class _Dispatcher:
    """Base dispatcher: reads the relevant *WebhookConfiguration objects
    (short poll), matches rules, calls each webhook in name order with
    failurePolicy/timeout semantics."""

    CONFIG_KIND = ""  # subclass

    def __init__(self, store: ObjectStore):
        self.store = store
        self._lock = threading.Lock()
        self._cached: tuple[float, list] = (0.0, [])
        self._uid = 0
        self.__name__ = type(self).__name__

    def _webhooks(self) -> list:
        now = time.monotonic()
        with self._lock:
            ts, hooks = self._cached
            if now - ts < _CONFIG_POLL_S:
                return hooks
        configs, _ = self.store.list(self.CONFIG_KIND)
        hooks = []
        for cfg in configs:
            for wh in cfg.get("webhooks") or []:
                hooks.append(wh)
        hooks.sort(key=lambda w: w.get("name", ""))
        with self._lock:
            self._cached = (now, hooks)
        return hooks

    @staticmethod
    def _matches(wh: dict, verb: str, kind: str,
                 sub: Optional[str] = None) -> bool:
        """Rule matching with upstream's resource/subresource split
        (``plugin/webhook/rules/rules.go`` Matcher.resource): ``pods``
        matches only the main resource, ``pods/status`` that subresource,
        ``pods/*`` any, ``*`` all resources but NO subresources."""
        from kubernetes_tpu_torch.store.apiserver import KIND_TO_PLURAL
        rules = wh.get("rules")
        if not rules:
            return False
        plural = KIND_TO_PLURAL.get(kind, kind.lower() + "s")
        req_sub = sub or ""
        for rule in rules:
            ops = rule.get("operations") or ["*"]
            # upstream validation requires non-empty resources; a rule
            # without them matches NOTHING here rather than everything
            kinds = rule.get("resources") or rule.get("kinds")
            if not kinds:
                continue
            if "*" not in ops and verb not in ops:
                continue
            for entry in kinds:
                res, _, rsub = str(entry).partition("/")
                res_ok = res == "*" or res == plural or res == kind
                sub_ok = rsub == "*" or rsub == req_sub
                if res_ok and sub_ok:
                    return True
        return False

    def _call(self, wh: dict, verb: str, kind: str, obj: dict,
              dry_run: bool = False) -> Optional[dict]:
        """-> webhook response dict, or None when failurePolicy=Ignore ate
        a transport failure. Raises AdmissionError on Fail, and for a dry
        run that the webhook's sideEffects do not allow."""
        url = ((wh.get("clientConfig") or {}).get("url")) or ""
        if dry_run and wh.get("sideEffects") not in _DRY_RUN_SAFE:
            raise AdmissionError(
                f"admission webhook {wh.get('name', url)!r} does not "
                "support dry run")
        policy = wh.get("failurePolicy", "Fail")
        timeout_s = float(wh.get("timeoutSeconds", 10))
        with self._lock:
            self._uid += 1
            uid = f"rev-{self._uid}"
        try:
            out = _call_webhook(url, _review(verb, kind, obj, uid),
                                timeout_s)
        except Exception as e:
            if policy == "Ignore":
                return None
            raise AdmissionError(
                f"webhook {wh.get('name', url)!r} failed "
                f"(failurePolicy=Fail): {e}") from None
        resp = out.get("response") or {}
        if resp.get("uid") not in (uid, "", None):
            if policy == "Ignore":
                return None
            raise AdmissionError(
                f"webhook {wh.get('name', url)!r}: response uid mismatch")
        if not resp.get("allowed", False):
            msg = (resp.get("status") or {}).get(
                "message", f"denied by webhook {wh.get('name', url)!r}")
            raise AdmissionError(msg)
        return resp


class MutatingWebhooks(_Dispatcher):
    """MutatingAdmissionWebhook analog: applies each allowed response's
    JSONPatch in webhook order."""

    CONFIG_KIND = "MutatingWebhookConfiguration"
    wants_subresource = True
    wants_dry_run = True

    def __call__(self, verb: str, kind: str, obj: dict,
                 sub: Optional[str] = None, dry_run: bool = False):
        if kind == self.CONFIG_KIND or kind == "ValidatingWebhookConfiguration":
            return None  # the configs themselves bypass the webhooks
        for wh in self._webhooks():
            if not self._matches(wh, verb, kind, sub):
                continue
            resp = self._call(wh, verb, kind, obj, dry_run)
            if resp is None:
                continue
            patch_b64 = resp.get("patch")
            if patch_b64:
                if resp.get("patchType", "JSONPatch") != "JSONPatch":
                    raise AdmissionError(
                        f"webhook {wh.get('name')!r}: unsupported patchType")
                try:
                    patch = json.loads(base64.b64decode(patch_b64))
                except Exception:
                    raise AdmissionError(
                        f"webhook {wh.get('name')!r}: undecodable patch"
                    ) from None
                obj = apply_json_patch(obj, patch)
        return obj


class ValidatingWebhooks(_Dispatcher):
    """ValidatingAdmissionWebhook analog: any deny rejects; responses
    cannot mutate."""

    CONFIG_KIND = "ValidatingWebhookConfiguration"
    wants_subresource = True
    wants_dry_run = True

    def __call__(self, verb: str, kind: str, obj: dict,
                 sub: Optional[str] = None, dry_run: bool = False):
        if kind in ("MutatingWebhookConfiguration", self.CONFIG_KIND):
            return None
        for wh in self._webhooks():
            if self._matches(wh, verb, kind, sub):
                self._call(wh, verb, kind, obj, dry_run)
        return None


# ------------------------------------------------------------ test server

class WebhookTestServer:
    """A tiny admission webhook endpoint for tests/examples: pass
    ``mutate(review) -> patch list | None`` and/or
    ``validate(review) -> (allowed, message)``."""

    def __init__(self, mutate: Optional[Callable] = None,
                 validate: Optional[Callable] = None,
                 latency_s: float = 0.0):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        outer = self
        self.calls = 0

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                outer.calls += 1
                if latency_s:
                    time.sleep(latency_s)
                n = int(self.headers.get("Content-Length", 0))
                review = json.loads(self.rfile.read(n))
                uid = (review.get("request") or {}).get("uid", "")
                resp = {"uid": uid, "allowed": True}
                if validate is not None:
                    allowed, msg = validate(review)
                    resp["allowed"] = allowed
                    if not allowed:
                        resp["status"] = {"message": msg}
                if resp["allowed"] and mutate is not None:
                    patch = mutate(review)
                    if patch:
                        resp["patchType"] = "JSONPatch"
                        resp["patch"] = base64.b64encode(
                            json.dumps(patch).encode()).decode()
                body = json.dumps({"apiVersion": "admission.k8s.io/v1",
                                   "kind": "AdmissionReview",
                                   "response": resp}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "WebhookTestServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
