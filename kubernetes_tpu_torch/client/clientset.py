"""Clientset — typed CRUD + watch against the API server.

Reference: ``staging/src/k8s.io/client-go/kubernetes/clientset.go`` (typed
clients) and ``rest/request.go``. Two transports share one interface:

  HTTPClient      urllib against a running APIServer (process boundary, like
                  the reference's always-HTTP client)
  DirectClient    in-process against an ObjectStore — the fake-clientset
                  analog (client-go/kubernetes/fake) used by tests and the
                  single-process benchmark harness.

Resource handles: ``client.pods(ns)``, ``client.nodes()``, ... each with
create/get/list/update/update_status/delete/watch/bind/evict.

The port of ``kubernetes_tpu/client/clientset.py``.
msgpack is optional: without it every client speaks JSON. One difference:
``HTTPClient`` keeps its URLs as ``urls``; the reference's ``endpoints``
list hides the ``endpoints(ns)`` handle.
"""

from __future__ import annotations

import http.client
import json
import socket
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Iterator, Optional

import functools

from kubernetes_tpu_torch.api.selectors import compile_list_selector
from kubernetes_tpu_torch.store.apiserver import (ALL_RESOURCES, APPS_RESOURCES,
                                            RBAC_RESOURCES)
from kubernetes_tpu_torch.store.store import (
    AlreadyExists,
    Conflict,
    Event,
    NotFound,
    ObjectStore,
    TooOld,
)


try:  # binary wire format (protobuf-negotiation analog); JSON fallback
    import msgpack as _client_msgpack
except Exception:  # ktpu-lint: disable=KTL002 -- import-time feature probe; the JSON wire format serves when msgpack is absent
    _client_msgpack = None

_MSGPACK_CT = "application/x-msgpack"


def _set_nodelay(sock) -> None:
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except (OSError, AttributeError):
        pass  # non-TCP transport (tests) or already-closed socket


class _NoDelayHTTPConnection(http.client.HTTPConnection):
    """Keep-alive connection with TCP_NODELAY: small JSON request/response
    pairs otherwise stall ~40ms each behind Nagle + delayed ACK, capping one
    connection at ~25 req/s."""

    def connect(self):
        super().connect()
        _set_nodelay(self.sock)


class _NoDelayHTTPSConnection(http.client.HTTPSConnection):
    def connect(self):
        super().connect()
        _set_nodelay(self.sock)


class ApiError(Exception):
    def __init__(self, code: int, message: str, reason: str = "",
                 items: "list[dict] | None" = None):
        super().__init__(f"{code}: {message}")
        self.code = code
        self.reason = reason
        # bulk verbs: per-item outcomes [(index, code, message)] so callers
        # can tell which siblings committed before a partial failure
        self.items = items or []


def _api_errors(fn):
    """Translate store exceptions to ApiError so DirectClient and HTTPClient
    raise identically (the fake clientset returns apierrors upstream too)."""
    @functools.wraps(fn)
    def wrapped(*a, **kw):
        try:
            return fn(*a, **kw)
        except NotFound as e:
            raise ApiError(404, str(e), "NotFound") from None
        except AlreadyExists as e:
            raise ApiError(409, str(e), "AlreadyExists") from None
        except Conflict as e:
            raise ApiError(409, str(e), "Conflict") from None
    return wrapped


class ResourceClient:
    """CRUD for one (plural, namespace) pair."""

    def __init__(self, transport, plural: str, namespace: Optional[str]):
        self._t = transport
        self.plural = plural
        reg = ALL_RESOURCES.get(plural)
        if reg is None:
            reg = transport.custom_lookup(plural)
            if reg is None:
                raise KeyError(
                    f"unknown resource {plural!r}: built-ins are static; "
                    "custom resources need client.register_custom(...) or "
                    "client.discover_custom()")
        self.kind, self.namespaced = reg[0], reg[1]
        self.namespace = namespace if self.namespaced else None

    def create(self, obj: dict, dry_run: bool = False) -> dict:
        """``dry_run``: server-side ?dryRun=All — the full admission +
        validation path runs and the would-be object returns, nothing
        persists."""
        if dry_run:
            fn = getattr(self._t, "create_dry_run", None)
            if fn is None:
                # never silently persist what the caller asked to preview
                raise ApiError(400, "dry-run is not supported by this "
                                    "transport", "BadRequest")
            return fn(self.plural, self.kind, self.namespace, obj)
        return self._t.create(self.plural, self.kind, self.namespace, obj)

    def create_many(self, objs: list[dict]) -> list[dict]:
        """Batch create: one store lock pass on the direct transport, one
        v1 List POST over HTTP. Transports lacking a bulk path fall back to
        sequential creates. Returns created objects (server identity
        stamped; the HTTP transport merges stamped metadata into the
        inputs rather than echoing full objects)."""
        fn = getattr(self._t, "create_many", None)
        if fn is not None:
            return fn(self.plural, self.kind, self.namespace, objs)
        return [self.create(o) for o in objs]

    def get(self, name: str) -> dict:
        return self._t.get(self.plural, self.kind, self.namespace, name)

    def list(self, label_selector: Optional[str] = None,
             field_selector: Optional[str] = None) -> list[dict]:
        return self._t.list(self.plural, self.kind, self.namespace,
                            label_selector, field_selector)[0]

    def list_rv(self, **kw) -> tuple[list[dict], int]:
        return self._t.list(self.plural, self.kind, self.namespace,
                            kw.get("label_selector"), kw.get("field_selector"))

    def update(self, obj: dict) -> dict:
        """Optimistic-concurrency update: the object's metadata.resourceVersion
        is the precondition (409 Conflict on mismatch) — read-modify-write
        races surface instead of silently last-write-winning."""
        return self._t.update(self.plural, self.kind, self.namespace, obj, None)

    def update_status(self, obj: dict) -> dict:
        return self._t.update(self.plural, self.kind, self.namespace, obj, "status")

    def apply(self, obj: dict, field_manager: str = "ktpu",
              force: bool = False) -> dict:
        """Server-side apply (managedFields field ownership; reference
        ``kubectl apply --server-side``): the server merges this applied
        configuration with other managers' fields, removes fields this
        manager previously applied but dropped, and 409s on conflicts
        unless ``force``."""
        return self._t.apply(self.plural, self.kind, self.namespace, obj,
                             field_manager, force)

    def delete(self, name: str,
               propagation_policy: Optional[str] = None) -> dict:
        """``propagation_policy``: Background (default) | Foreground |
        Orphan — DeleteOptions.propagationPolicy; Foreground/Orphan stamp
        the GC finalizer so the garbage collector completes the delete."""
        return self._t.delete(self.plural, self.kind, self.namespace, name,
                              propagation_policy)

    def watch(self, since_rv: int = 0) -> Iterator[Event]:
        return self._t.watch(self.plural, self.kind, self.namespace, since_rv)

    # pod subresources
    def bind(self, name: str, node_name: str) -> dict:
        return self._t.bind(self.namespace, name, node_name)

    def bind_many(self, bindings: list[tuple[str, str, str]]) -> list[Optional[str]]:
        """Bulk bind: ``[(namespace, name, node_name)]`` in one request.
        Returns per-item error message or None (success), request order."""
        return self._t.bind_many(bindings)

    def update_status_many(self, items: list[tuple[str, str, dict]]
                           ) -> list[Optional[str]]:
        """Bulk pod status: ``[(namespace, name, status)]`` in one request
        (the kubemark status batcher's transport). Returns per-item error
        message or None (success), request order."""
        return self._t.update_status_many(items)

    # node subresources (fleet heartbeat fan-in)
    def heartbeat_many(self, items: list[tuple[str, dict]]
                       ) -> list[Optional[str]]:
        """Bulk node heartbeat: ``[(name, status_patch)]`` in one request
        (POST nodes/-/status; conditions merge by type server-side — the
        kubemark heartbeat batcher's transport). Returns per-item error
        message or None (success), request order."""
        return self._t.heartbeat_many(items)

    # lease subresources (fleet liveness fan-in)
    def renew_many(self, items: list[tuple[str, float]]
                   ) -> list[Optional[str]]:
        """Bulk lease renewal: ``[(name, renew_time)]`` in one request
        (POST leases/-/renew against this handle's namespace). Returns
        per-item error message or None (success), request order."""
        return self._t.renew_many(self.namespace, items)

    def evict(self, name: str) -> dict:
        return self._t.evict(self.namespace, name)

    # scale subresource (autoscaling/v1 Scale; Deployment/RS/STS/RC)
    def get_scale(self, name: str) -> dict:
        return self._t.get_scale(self.plural, self.kind, self.namespace,
                                 name)

    def update_scale(self, name: str, replicas: int,
                     expect_rv: Optional[str] = None) -> dict:
        return self._t.update_scale(self.plural, self.kind, self.namespace,
                                    name, replicas, expect_rv)


class _Handles:
    def pods(self, ns: str = "default") -> ResourceClient:
        return ResourceClient(self, "pods", ns)

    def nodes(self) -> ResourceClient:
        return ResourceClient(self, "nodes", None)

    def services(self, ns: str = "default") -> ResourceClient:
        return ResourceClient(self, "services", ns)

    def endpoints(self, ns: str = "default") -> ResourceClient:
        return ResourceClient(self, "endpoints", ns)

    def leases(self, ns: str = "kube-system") -> ResourceClient:
        return ResourceClient(self, "leases", ns)

    def resource(self, plural: str, ns: Optional[str] = "default") -> ResourceClient:
        return ResourceClient(self, plural, ns)

    # ---- custom resources (CRDs) -----------------------------------------

    def register_custom(self, plural: str, kind: str, namespaced: bool = True,
                        group: str = "example.com/v1") -> None:
        """Teach this client a CustomResourceDefinition's served resource
        (dynamic-client analog: plural -> kind/scope/API path)."""
        if not hasattr(self, "_custom"):
            self._custom: dict[str, tuple] = {}
        self._custom[plural] = (kind, namespaced, group)

    def custom_lookup(self, plural: str):
        return getattr(self, "_custom", {}).get(plural)

    def custom_kind_to_plural(self, kind: str) -> Optional[str]:
        """Reverse mapping over registered custom resources."""
        for plural, (k, _ns, _g) in getattr(self, "_custom", {}).items():
            if k == kind:
                return plural
        return None

    def discover_custom(self) -> int:
        """Rebuild the custom-resource table from the server's CRDs (the
        discovery client's group/version sweep) — deleted/renamed CRDs are
        pruned, not just added. -> # registered."""
        table: dict[str, tuple] = {}
        for crd in self.resource("customresourcedefinitions", None).list():
            spec = crd.get("spec") or {}
            names = spec.get("names") or {}
            versions = spec.get("versions") or [{"name": "v1"}]
            version = next((v.get("name") for v in versions
                            if v.get("served", True) and v.get("name")),
                           "v1")
            if names.get("plural") and names.get("kind"):
                table[names["plural"]] = (
                    names["kind"],
                    spec.get("scope", "Namespaced") == "Namespaced",
                    f"{spec.get('group', '')}/{version}")
        self._custom = table
        return len(table)


class DirectClient(_Handles):
    """In-process client over an ObjectStore (fake-clientset analog). Reactor
    hooks: ``prepend_reactor(verb, plural, fn)`` with fn(obj) -> obj | raise."""

    def __init__(self, store: ObjectStore):
        self.store = store
        self._reactors: list[tuple[str, str, Callable]] = []

    def prepend_reactor(self, verb: str, plural: str, fn: Callable):
        self._reactors.insert(0, (verb, plural, fn))

    def _react(self, verb: str, plural: str, obj):
        for v, p, fn in self._reactors:
            if (v == verb or v == "*") and (p == plural or p == "*"):
                obj = fn(obj)
        return obj

    @_api_errors
    def create(self, plural, kind, ns, obj):
        obj = self._react("create", plural, obj)
        obj.setdefault("metadata", {})
        if ns:
            obj["metadata"].setdefault("namespace", ns)
        obj.setdefault("kind", kind)
        return self.store.create(kind, obj)

    @_api_errors
    def create_many(self, plural, kind, ns, objs):
        prepped = []
        for obj in objs:
            obj = self._react("create", plural, obj)
            obj.setdefault("metadata", {})
            if ns:
                obj["metadata"].setdefault("namespace", ns)
            obj.setdefault("kind", kind)
            prepped.append(obj)
        return self.store.create_many(kind, prepped)

    @_api_errors
    def get(self, plural, kind, ns, name):
        return self.store.get(kind, ns or "", name)

    @_api_errors
    def list(self, plural, kind, ns, label_selector, field_selector):
        sel = compile_list_selector(label_selector, field_selector)
        return self.store.list(kind, namespace=ns, selector=sel)

    @_api_errors
    def apply(self, plural, kind, ns, obj, field_manager, force):
        from kubernetes_tpu_torch.store.apply import (ApplyConflict,
                                                      server_side_apply)
        obj = self._react("apply", plural, obj)
        obj.setdefault("metadata", {})
        if ns:
            obj["metadata"].setdefault("namespace", ns)
        obj.setdefault("kind", kind)
        name = obj["metadata"].get("name", "")
        try:
            live = self.store.get(kind, ns or "", name)
        except NotFound:
            live = None
        try:
            merged = server_side_apply(live, obj, field_manager, force=force)
        except ApplyConflict as e:
            raise ApiError(409, str(e), "Conflict") from None
        if live is None:
            return self.store.create(kind, merged)
        return self.store.update(
            kind, merged, expect_rv=live["metadata"]["resourceVersion"])

    @_api_errors
    def update(self, plural, kind, ns, obj, sub):
        obj = self._react("update", plural, obj)
        expect = (obj.get("metadata") or {}).get("resourceVersion") or None
        if sub == "status":
            cur = self.store.get(kind, ns or obj["metadata"].get("namespace", ""),
                                 obj["metadata"]["name"])
            cur["status"] = obj.get("status", {})
            obj = cur
            expect = obj["metadata"].get("resourceVersion") or None
        return self.store.update(kind, obj, expect_rv=expect)

    @_api_errors
    def get_scale(self, plural, kind, ns, name):
        from kubernetes_tpu_torch.store.apiserver import SCALABLE_KINDS, _scale_of
        if kind not in SCALABLE_KINDS:
            raise NotFound(f"{kind} has no scale subresource")
        return _scale_of(kind, self.store.get(kind, ns or "", name))

    @_api_errors
    def update_scale(self, plural, kind, ns, name, replicas, expect_rv):
        from kubernetes_tpu_torch.store.apiserver import SCALABLE_KINDS, _scale_of
        if kind not in SCALABLE_KINDS:
            raise NotFound(f"{kind} has no scale subresource")
        cur = self.store.get(kind, ns or "", name)
        cur.setdefault("spec", {})["replicas"] = int(replicas)
        cur = self._react("update", plural, cur)  # fake-clientset reactors
        if expect_rv is None:
            # GuaranteedUpdate shape: precondition on the read's own rv
            expect_rv = (cur.get("metadata") or {}).get("resourceVersion")
        return _scale_of(kind, self.store.update(kind, cur,
                                                 expect_rv=expect_rv))

    @_api_errors
    def delete(self, plural, kind, ns, name, propagation_policy=None):
        self._react("delete", plural, {"metadata": {"name": name, "namespace": ns}})
        if propagation_policy in ("Foreground", "Orphan"):
            fin = ("foregroundDeletion" if propagation_policy == "Foreground"
                   else "orphan")
            cur = self.store.get(kind, ns or "", name)
            fins = (cur.get("metadata") or {}).get("finalizers") or []
            if fin not in fins:
                cur.setdefault("metadata", {})["finalizers"] = \
                    list(fins) + [fin]
                self.store.update(kind, cur)
        return self.store.delete(kind, ns or "", name)

    def watch(self, plural, kind, ns, since_rv):
        # Store events share the authoritative object (zero-copy fan-out);
        # HTTP consumers get fresh dicts from JSON decode, but in-process
        # consumers could alias store internals — detach here to keep the
        # fake-clientset contract (handlers may scribble on what they get).
        w = _CopyingWatch(self.store.watch(kind, since_rv=since_rv))
        if ns is None:
            return w
        return _NamespaceFilteredWatch(w, ns)

    @_api_errors
    def bind(self, ns, name, node_name):
        pod = self.store.get("Pod", ns or "", name)
        if pod.get("spec", {}).get("nodeName"):
            raise ApiError(409, "pod already bound", "Conflict")
        pod["spec"]["nodeName"] = node_name
        # rv precondition closes the check-then-set race between two binders
        return self.store.update("Pod", pod,
                                 expect_rv=pod["metadata"]["resourceVersion"])

    def bind_many(self, bindings):
        return self.store.bind_many(bindings)

    def update_status_many(self, items):
        return self.store.update_status_many("Pod", items)

    def heartbeat_many(self, items):
        return self.store.heartbeat_many(items)

    def renew_many(self, ns, items):
        return self.store.renew_leases(ns or "kube-node-lease", items)

    @_api_errors
    def evict(self, ns, name):
        return self.store.delete("Pod", ns or "", name)


class _CopyingWatch:
    """Delivers store events with detached payload copies (DirectClient)."""

    def __init__(self, inner):
        self._inner = inner

    @property
    def closed(self) -> bool:
        return self._inner.closed

    def get(self, timeout: float = 0.2):
        from kubernetes_tpu_torch.store.store import Event, fastcopy
        ev = self._inner.get(timeout)
        if ev is None:
            return None
        return Event(ev.type, fastcopy(ev.object), ev.resource_version)

    def __iter__(self):
        return self

    def __next__(self):
        from kubernetes_tpu_torch.store.store import Event, fastcopy
        ev = next(self._inner)
        return Event(ev.type, fastcopy(ev.object), ev.resource_version)

    def stop(self):
        self._inner.stop()


class _NamespaceFilteredWatch:
    def __init__(self, inner, ns):
        self._inner = inner
        self._ns = ns

    @property
    def closed(self) -> bool:
        # Delegate: the inner stream closes on store-side invalidation
        # (checkpoint restore) and the informer checks THIS object's flag.
        return self._inner.closed

    def get(self, timeout: float = 0.2):
        ev = self._inner.get(timeout)
        if ev is None:
            return None
        if (ev.object.get("metadata") or {}).get("namespace", "") != self._ns:
            return None
        return ev

    def __iter__(self):
        return self

    def __next__(self):
        for ev in self._inner:
            if (ev.object.get("metadata") or {}).get("namespace", "") == self._ns:
                return ev
        raise StopIteration

    def stop(self):
        self._inner.stop()


class HTTPClient(_Handles):
    """urllib transport against an APIServer URL. ``token``: bearer token
    presented on every request (the service-identity credential —
    rest.Config.BearerToken); ``impersonate``: acts-as user name sent via
    Impersonate-User (requires the real user to hold ``impersonate``).

    Endpoint spreading (the read-replica serving plane): ``base_url`` may
    be a list of URLs or one comma-separated string. Reads and watches
    spread across all endpoints (sticky per thread / per watch, rotating
    with full-jitter failover on transport errors); writes go to the
    tracked leader, re-routing on a 421 NotLeader's X-KTPU-Leader hint.
    With a single endpoint nothing changes."""

    def __init__(self, base_url, timeout: float = 10.0,
                 token: Optional[str] = None,
                 impersonate: Optional[str] = None,
                 wire: str = "msgpack", user_agent: str = "",
                 retry_attempts: int = 3, retry_base_s: float = 0.05,
                 retry_cap_s: float = 2.0):
        if isinstance(base_url, (list, tuple)):
            eps = [str(u).strip().rstrip("/") for u in base_url]
        else:
            eps = [u.strip().rstrip("/") for u in str(base_url).split(",")]
        # ``urls``, not the reference's ``endpoints``: an attribute of that
        # name hides ``_Handles.endpoints(ns)``, and every Endpoints call
        # over HTTP (the endpoints controller's) raised TypeError
        self.urls: list[str] = [e for e in eps if e]
        if not self.urls:
            raise ValueError("HTTPClient needs at least one endpoint")
        self.base = self.urls[0]
        # where writes go: starts at the first endpoint, follows 421
        # X-KTPU-Leader hints thereafter (benign cross-thread race: every
        # thread converges on whatever hint landed last)
        self._leader = self.base
        self.timeout = timeout
        self.token = token
        self.impersonate = impersonate
        # Outage discipline: transport-level failures (connection refused/
        # reset storms while the apiserver restarts) retry up to
        # ``retry_attempts`` times with capped FULL-JITTER exponential
        # backoff — a thousand clients re-converging on the second the
        # server comes back is its own outage. The budget is deliberately
        # small: the client absorbs blips; callers' own loops (informer
        # relist backoff, batcher shard backoff) own multi-second outages.
        self.retry_attempts = max(0, int(retry_attempts))
        self.retry_base_s = retry_base_s
        self.retry_cap_s = retry_cap_s
        # identifies the component to the server (upstream clients always
        # send one); APF flow schemas match on it for unauthenticated flows
        self.user_agent = user_agent
        # Wire format: msgpack by default (the protobuf-negotiation analog;
        # ~4x cheaper encode / ~2x decode than JSON on pod-sized objects —
        # the connected path moves every object several times, so the
        # serializer is a first-order cost). ``wire="json"`` forces the
        # text protocol; either way the server negotiates per request, so
        # mixed-format clients interoperate freely.
        self._mp = _client_msgpack if wire == "msgpack" else None
        # per-thread persistent connection (keep-alive): the server speaks
        # HTTP/1.1 with Content-Length, so reusing the socket removes the
        # TCP handshake every request paid under urllib — the dominant cost
        # of the connected scheduling path's bind/status chatter
        self._local = threading.local()

    def default_user_agent(self, name: str) -> None:
        """Set the agent unless the caller already chose one — components
        call this so their flows classify under the right APF schema."""
        if not self.user_agent:
            self.user_agent = name

    def _conns(self) -> dict:
        conns = getattr(self._local, "conns", None)
        if conns is None:
            conns = self._local.conns = {}
        return conns

    def _conn(self, base: Optional[str] = None):
        base = base or self.base
        conns = self._conns()
        conn = conns.get(base)
        if conn is None:
            from urllib.parse import urlsplit
            parts = urlsplit(base)
            cls = (_NoDelayHTTPSConnection if parts.scheme == "https"
                   else _NoDelayHTTPConnection)
            conn = cls(parts.hostname, parts.port, timeout=self.timeout)
            conns[base] = conn
        return conn

    def _drop_conn(self, base: Optional[str] = None):
        conn = self._conns().pop(base or self.base, None)
        if conn is not None:
            try:
                conn.close()
            except Exception:  # ktpu-lint: disable=KTL002 -- closing an already-broken pooled connection; the caller opens a fresh one
                pass

    # ---- endpoint spreading ----------------------------------------------

    def _read_endpoint(self) -> str:
        """Sticky per-thread read endpoint, spread uniformly at first use —
        list+watch from one thread land on the same replica, and the fleet
        of client threads spreads across the whole serving plane."""
        if len(self.urls) == 1:
            return self.urls[0]
        base = getattr(self._local, "read_base", None)
        if base is None or base not in self.urls:
            import random
            base = random.choice(self.urls)
            self._local.read_base = base
        return base

    def _rotate_read_endpoint(self, dead: str) -> str:
        """Failover: move this thread's stickiness off a dead endpoint."""
        if len(self.urls) > 1:
            others = [e for e in self.urls if e != dead]
            import random
            self._local.read_base = random.choice(others)
            return self._local.read_base
        return dead

    def _rotate_leader(self, dead: str) -> str:
        """The tracked leader is unreachable: try the next endpoint — any
        follower answers the retried write with 421 + the real leader."""
        if dead in self.urls and len(self.urls) > 1:
            i = self.urls.index(dead)
            self._leader = self.urls[(i + 1) % len(self.urls)]
        elif dead not in self.urls:
            self._leader = self.urls[0]
        return self._leader

    def _auth_headers(self) -> dict:
        h = {}
        if self.token:
            h["Authorization"] = f"Bearer {self.token}"
        if self.impersonate:
            h["Impersonate-User"] = self.impersonate
        if self.user_agent:
            h["User-Agent"] = self.user_agent
        return h

    def _path(self, plural, ns, name=None, sub=None, query=""):
        custom = self.custom_lookup(plural)
        if custom is not None and plural not in ALL_RESOURCES:
            return self._path_for(f"/apis/{custom[2]}", plural, ns, name, sub,
                                  query)
        group = "/apis/apps/v1" if plural in APPS_RESOURCES else (
            "/apis/coordination.k8s.io/v1" if plural == "leases" else
            "/apis/storage.k8s.io/v1" if plural == "storageclasses" else
            "/apis/scheduling.k8s.io/v1" if plural == "priorityclasses" else
            "/apis/policy/v1" if plural == "poddisruptionbudgets" else
            "/apis/batch/v1" if plural == "cronjobs" else
            "/apis/autoscaling/v2" if plural == "horizontalpodautoscalers" else
            "/apis/discovery.k8s.io/v1" if plural == "endpointslices" else
            "/apis/resource.k8s.io/v1" if plural in (
                "resourceclaims", "resourceclaimtemplates", "deviceclasses",
                "resourceslices") else
            "/apis/apiextensions.k8s.io/v1"
            if plural == "customresourcedefinitions" else
            "/apis/rbac.authorization.k8s.io/v1" if plural in RBAC_RESOURCES
            else "/apis/admissionregistration.k8s.io/v1"
            if plural in ("mutatingwebhookconfigurations",
                          "validatingwebhookconfigurations")
            else "/apis/apiregistration.k8s.io/v1"
            if plural == "apiservices"
            else "/apis/certificates.k8s.io/v1"
            if plural == "certificatesigningrequests"
            else "/api/v1")
        return self._path_for(group, plural, ns, name, sub, query)

    def _path_for(self, group, plural, ns, name, sub, query):
        p = group
        if ns:
            p += f"/namespaces/{ns}"
        p += f"/{plural}"
        if name:
            p += f"/{name}"
        if sub:
            p += f"/{sub}"
        if query:
            p += "?" + query
        return self.base + p

    def _req(self, method, url, body=None, headers=None):
        import http.client
        mp = self._mp
        if mp is not None:
            data = mp.packb(body) if body is not None else None
            ctype = _MSGPACK_CT
        else:
            data = json.dumps(body).encode() if body is not None else None
            ctype = "application/json"
        path = url[len(self.base):] or "/"
        all_headers = {"Content-Type": ctype, "Accept": ctype,
                       **self._auth_headers(), **(headers or {})}
        # Transport-level failures (reset/refused under load bursts or a
        # restarting apiserver, or a keep-alive socket the server closed
        # between requests) retry with capped full-jitter backoff.
        # A retried NAMED write that actually committed surfaces as
        # 409/AlreadyExists — the expected optimistic-concurrency outcome.
        # generateName creates are NOT idempotent (the server mints a fresh
        # name each time, so a lost-response retry would duplicate the
        # object); those run on a FRESH connection (no stale-keep-alive
        # hazard) and fail fast, relying on the controller's resync.
        retriable = not (method == "POST" and isinstance(body, dict)
                         and (body.get("metadata") or {}).get("generateName")
                         and not (body.get("metadata") or {}).get("name"))
        # endpoint routing: reads spread (sticky per thread), writes chase
        # the leader. A 421 NotLeader re-routes without burning the
        # transport-retry budget (the write never started server-side).
        target = (self._read_endpoint() if method == "GET"
                  else self._leader)
        leader_hops = 0
        if not retriable:
            self._drop_conn(target)
        stale_retry_used = False
        attempt = 0
        while True:
            reused = target in self._conns()
            conn = self._conn(target)
            try:
                conn.request(method, path, body=data, headers=all_headers)
                resp = conn.getresponse()
                payload = resp.read()
                if resp.will_close:
                    self._drop_conn(target)
                is_mp = _MSGPACK_CT in (resp.getheader("Content-Type") or "")
                if resp.status >= 400:
                    try:
                        status = (_client_msgpack.unpackb(payload) if is_mp
                                  else json.loads(payload))
                    except Exception:  # ktpu-lint: disable=KTL002 -- error-body parse fallback; msg defaults to the HTTP status code below
                        status = {}
                    msg = status.get("message", f"HTTP {resp.status}")
                    if resp.status == 421 and leader_hops < 3:
                        # follower answered a write: chase the leader hint,
                        # or rotate (+ a short jittered pause) when there is
                        # none yet (election in flight)
                        leader_hops += 1
                        hint = (resp.getheader("X-KTPU-Leader")
                                or "").rstrip("/")
                        if hint and hint != target:
                            self._leader = target = hint
                        else:
                            import random
                            time.sleep(random.uniform(0.01, 0.1))
                            target = self._rotate_leader(target)
                        continue
                    if (resp.status == 400 and mp is not None
                            and "invalid JSON body" in msg):
                        # Server can't speak msgpack (no module there): it
                        # read our binary body as JSON. Downgrade this client
                        # to the text wire permanently and replay the
                        # request — negotiation is Accept-driven for
                        # responses but bodies need this one-shot probe.
                        self._mp = mp = None
                        data = (json.dumps(body).encode()
                                if body is not None else None)
                        # PATCH is server-side apply here; its JSON media
                        # type is apply-patch+json (plain JSON is 415'd)
                        ctype_dg = ("application/apply-patch+json"
                                    if method == "PATCH"
                                    else "application/json")
                        all_headers = {**all_headers,
                                       "Content-Type": ctype_dg,
                                       "Accept": "application/json"}
                        continue
                    raise ApiError(resp.status, msg,
                                   status.get("reason", ""))
                if not payload:
                    return {}
                return (_client_msgpack.unpackb(payload) if is_mp
                        else json.loads(payload))
            except ApiError:
                raise
            except (http.client.HTTPException, ConnectionError, OSError,
                    TimeoutError):
                self._drop_conn(target)
                # A failure on a REUSED socket is almost always a stale
                # keep-alive the server closed between requests: retry on a
                # fresh connection WITHOUT burning the transport-retry
                # budget (which exists for genuine transient failures).
                if reused and not stale_retry_used:
                    stale_retry_used = True
                    continue
                if attempt < self.retry_attempts and retriable:
                    # full jitter in (0, base * 2^attempt] capped: during a
                    # refused/reset storm every waiter picks an independent
                    # uniform delay, so the reconnect wave spreads instead
                    # of thundering the restarted server
                    import random
                    delay = min(self.retry_cap_s,
                                self.retry_base_s * (2 ** attempt))
                    time.sleep(random.uniform(0.0, delay)
                               or self.retry_base_s / 2)
                    # a dead endpoint shouldn't eat the whole retry budget:
                    # reads hop to a sibling replica, writes rotate toward
                    # (eventually) the live leader
                    if method == "GET":
                        target = self._rotate_read_endpoint(target)
                    else:
                        target = self._rotate_leader(target)
                    attempt += 1
                    continue
                raise

    def create(self, plural, kind, ns, obj):
        return self._req("POST", self._path(plural, ns), obj)

    def create_many(self, plural, kind, ns, objs):
        """POST a v1 List manifest: one request creates every item. Returns
        the inputs with server-stamped metadata (resourceVersion/uid/...)
        merged in — the wire carries metadata only, not full echo objects."""
        out = self._req("POST", self._path(plural, ns),
                        {"kind": "List", "items": objs})
        results = out.get("results", [])
        failures = [(i, int(r.get("code", 500)), r.get("message", "error"))
                    for i, r in enumerate(results)
                    if r.get("code") not in (200, 201)]
        created = []
        for obj, r in zip(objs, results):
            if r.get("code") in (200, 201) and r.get("metadata"):
                obj = dict(obj)
                obj["metadata"] = r["metadata"]
            created.append(obj)
        if failures:
            # Surface the ACTUAL per-item codes (an admission 400 must not
            # masquerade as a 409) and which siblings committed: successful
            # items are already persisted server-side, unlike the sequential
            # fallback which stops at the first failure.
            codes = {c for _, c, _ in failures}
            code = failures[0][1] if len(codes) == 1 else 422
            raise ApiError(
                code,
                "; ".join(f"items[{i}]: {m}" for i, _, m in failures),
                "BulkCreateFailed",
                items=[{"index": i, "code": c, "message": m}
                       for i, c, m in failures])
        return created

    def get(self, plural, kind, ns, name):
        return self._req("GET", self._path(plural, ns, name))

    def list(self, plural, kind, ns, label_selector, field_selector):
        import urllib.parse
        q = {}
        if label_selector:
            q["labelSelector"] = label_selector
        if field_selector:
            q["fieldSelector"] = field_selector
        out = self._req("GET", self._path(plural, ns, query=urllib.parse.urlencode(q)))
        return out.get("items", []), int(out.get("metadata", {})
                                         .get("resourceVersion", "0"))

    def update(self, plural, kind, ns, obj, sub):
        name = obj["metadata"]["name"]
        rv = (obj.get("metadata") or {}).get("resourceVersion")
        headers = {"If-Match": rv} if rv else {}
        return self._req("PUT", self._path(plural, ns, name, sub), obj,
                         headers=headers)

    def delete(self, plural, kind, ns, name, propagation_policy=None):
        q = (f"propagationPolicy={propagation_policy}"
             if propagation_policy else "")
        return self._req("DELETE", self._path(plural, ns, name, query=q))

    def create_dry_run(self, plural, kind, ns, obj):
        return self._req("POST", self._path(plural, ns,
                                            query="dryRun=All"), obj)

    def get_scale(self, plural, kind, ns, name):
        return self._req("GET", self._path(plural, ns, name, "scale"))

    def update_scale(self, plural, kind, ns, name, replicas, expect_rv):
        body = {"kind": "Scale", "apiVersion": "autoscaling/v1",
                "metadata": {"name": name,
                             **({"resourceVersion": expect_rv}
                                if expect_rv else {})},
                "spec": {"replicas": int(replicas)}}
        return self._req("PUT", self._path(plural, ns, name, "scale"),
                         body)

    def bind(self, ns, name, node_name):
        return self._req("POST", self._path("pods", ns, name, "binding"),
                         {"target": {"kind": "Node", "name": node_name}})

    def apply(self, plural, kind, ns, obj, field_manager, force):
        import urllib.parse
        name = (obj.get("metadata") or {}).get("name", "")
        q = urllib.parse.urlencode(
            {"fieldManager": field_manager,
             **({"force": "true"} if force else {})})
        # msgpack clients ride the negotiated binary type; JSON clients must
        # declare the apply-patch media type (plain JSON PATCH is rejected,
        # as upstream rejects non-SSA patches it doesn't support)
        headers = (None if self._mp is not None
                   else {"Content-Type": "application/apply-patch+json"})
        return self._req("PATCH", self._path(plural, ns, name, query=q),
                         obj, headers=headers)

    def bind_many(self, bindings):
        out = self._req("POST", self._path("pods", None, "-", "binding"),
                        {"bindings": [
                            {"namespace": ns, "name": name,
                             "target": {"kind": "Node", "name": node}}
                            for ns, name, node in bindings]})
        return [None if r.get("code") == 200 else r.get("message", "error")
                for r in out.get("results", [])]

    def update_status_many(self, items):
        out = self._req("POST", self._path("pods", None, "-", "status"),
                        {"statuses": [
                            {"namespace": ns, "name": name, "status": status}
                            for ns, name, status in items]})
        return [None if r.get("code") == 200 else r.get("message", "error")
                for r in out.get("results", [])]

    def heartbeat_many(self, items):
        out = self._req("POST", self._path("nodes", None, "-", "status"),
                        {"statuses": [
                            {"name": name, "status": status}
                            for name, status in items]})
        return [None if r.get("code") == 200 else r.get("message", "error")
                for r in out.get("results", [])]

    def renew_many(self, ns, items):
        out = self._req("POST",
                        self._path("leases", ns or "kube-node-lease",
                                   "-", "renew"),
                        {"renews": [
                            {"name": name, "renewTime": rt}
                            for name, rt in items]})
        return [None if r.get("code") == 200 else r.get("message", "error")
                for r in out.get("results", [])]

    def evict(self, ns, name):
        return self._req("POST", self._path("pods", ns, name, "eviction"), {})

    def watch(self, plural, kind, ns, since_rv):
        return _HTTPWatch(self, plural, ns, since_rv)

    # ---- kubelet-proxied pod subresources (kubectl logs / exec) ----------

    def pod_logs(self, ns: str, name: str, container: str = "") -> str:
        """GET pods/<p>/log — the apiserver proxies to the pod's kubelet."""
        q = f"container={container}" if container else ""
        url = self._path("pods", ns, name, "log", query=q)
        req = urllib.request.Request(url, headers=self._auth_headers())
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return resp.read().decode()

    def pod_exec(self, ns: str, name: str, command: list,
                 container: str = "") -> dict:
        """POST pods/<p>/exec -> {exit_code, output} via the kubelet."""
        q = f"container={container}" if container else ""
        url = self._path("pods", ns, name, "exec", query=q)
        req = urllib.request.Request(
            url, data=json.dumps({"command": command}).encode(),
            headers={"Content-Type": "application/json",
                     **self._auth_headers()}, method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read())


class _HTTPWatch:
    """Streaming watch: chunked msgpack frames (negotiated via Accept,
    heartbeat = nil) or newline-JSON lines (heartbeat = bare newline)."""

    HEARTBEAT_GRACE = 5.0  # server heartbeats ~1s; silence beyond this = dead

    def __init__(self, client: HTTPClient, plural: str, ns, since_rv: int):
        path = client._path(
            plural, ns,
            query=f"watch=true&resourceVersion={since_rv}")[len(client.base):]
        self.closed = False
        headers = client._auth_headers()
        if client._mp is not None:
            headers["Accept"] = _MSGPACK_CT
        # Watches spread like reads: try the thread's sticky endpoint first,
        # fail over through the remaining replicas on transport errors. A
        # 410 anywhere is authoritative (rv compaction is replicated state,
        # identical on every node) so it is NOT retried elsewhere.
        bases = [client._read_endpoint()]
        bases += [b for b in client.urls if b not in bases]
        # read timeout doubles as the liveness window: the server heartbeats
        # every ~1s, so a blocking read that times out means a dead peer.
        last_err: Exception = OSError("no endpoints")
        for base in bases:
            self._url = base + path
            try:
                self._resp = urllib.request.urlopen(
                    urllib.request.Request(self._url, headers=headers),
                    timeout=self.HEARTBEAT_GRACE)
                break
            except urllib.error.HTTPError as e:
                if e.code == 410:
                    # DirectClient parity: a compacted-away resourceVersion
                    # (typical right after an apiserver restart: the restore
                    # floor advanced past every pre-restart rv) raises TooOld
                    # so the informer relists IMMEDIATELY instead of riding
                    # the generic-error backoff through a healing window
                    raise TooOld(f"watch rv compacted: {e.reason}") from None
                raise
            except (urllib.error.URLError, ConnectionError, OSError,
                    TimeoutError) as e:
                client._rotate_read_endpoint(base)
                last_err = e
        else:
            raise last_err
        got_ct = self._resp.headers.get("Content-Type") or ""
        self._unpacker = (_client_msgpack.Unpacker()
                          if _MSGPACK_CT in got_ct else None)
        self._lock = threading.Lock()

    def get(self, timeout: float = 0.2) -> Optional[Event]:
        if self.closed:
            return None
        if self._unpacker is not None:
            return self._get_msgpack()
        try:
            line = self._resp.readline()
        except Exception:  # ktpu-lint: disable=KTL002 -- socket timeout/closed stream sets closed=True; the informer's relist-and-resync path counts it via watch_relists_total
            self.closed = True
            return None
        if not line:
            self.closed = True
            return None
        if line == b"\n":
            return None  # heartbeat
        try:
            d = json.loads(line)
        except json.JSONDecodeError:
            return None
        rv = int(d["object"].get("metadata", {}).get("resourceVersion", "0"))
        return Event(d["type"], d["object"], rv)

    def _get_msgpack(self) -> Optional[Event]:
        while True:
            try:
                d = next(self._unpacker)
            except StopIteration:
                # buffer dry: pull more bytes off the socket (read1 returns
                # whatever the current chunk has without waiting for a full
                # buffer; blocking beyond HEARTBEAT_GRACE means a dead peer)
                try:
                    data = self._resp.read1(1 << 16)
                except Exception:  # ktpu-lint: disable=KTL002 -- socket timeout/closed stream sets closed=True; the informer's relist-and-resync path counts it via watch_relists_total
                    self.closed = True
                    return None
                if not data:
                    self.closed = True
                    return None
                self._unpacker.feed(data)
                continue
            if d is None:
                return None  # heartbeat (nil frame)
            rv = int(d["object"].get("metadata", {})
                     .get("resourceVersion", "0"))
            return Event(d["type"], d["object"], rv)

    def __iter__(self):
        return self

    def __next__(self):
        while not self.closed:
            ev = self.get(timeout=1.0)
            if ev is not None:
                return ev
        raise StopIteration

    def stop(self):
        self.closed = True
        try:
            self._resp.close()
        except Exception:  # ktpu-lint: disable=KTL002 -- closing a response that may already be dead; teardown only
            pass
