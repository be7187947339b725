"""HTTP API server — REST + watch streams over the object store.

Reference shape: ``apiserver/pkg/endpoints/handlers/{create,get,update,delete,
watch}.go`` behind ``DefaultBuildHandlerChain``; the pod ``binding``
subresource mirrors ``pkg/registry/core/pod/storage/storage.go``
(``BindingREST.Create`` -> sets spec.nodeName). Watch is chunked
newline-delimited JSON exactly like ``?watch=true`` upstream; msgpack is
negotiated per request when the module is installed.

Paths:
  /api/v1/nodes[/{name}]
  /api/v1/namespaces/{ns}/{plural}[/{name}]          pods, services, ...
  /api/v1/namespaces/{ns}/pods/{name}/binding        POST (bind)
  /api/v1/namespaces/{ns}/pods/{name}/status         PUT
  /api/v1/namespaces/{ns}/pods/-/{binding,status}    POST (bulk)
  /api/v1/nodes/-/status, .../leases/-/renew         POST (bulk)
  /apis/apps/v1/namespaces/{ns}/{plural}[/{name}]    deployments, replicasets
  /healthz /readyz /metrics /frontdoor/status

Admission: ordered list of ``fn(verb, kind, obj) -> obj`` callables; raising
AdmissionError rejects the request with 400 (webhook-chain analog).

The port of ``kubernetes_tpu/store/apiserver.py``: the handler chain
(authentication, audit, impersonation, API Priority and Fairness, RBAC),
admission with webhooks and PodSecurity, server-side apply on PATCH, and
the read-replica front door over a ``ReplicatedStore``. A dry-run request
matched by a webhook with side effects is refused with 400 before the
webhook is called (``store/webhooks.py``). The pod ``log``, ``exec`` and
``portforward`` subresources proxy to the pod's kubelet through
``node.status.daemonEndpoints``. ``serve(conn, ...)`` is the entry a
spawned server process runs.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

try:  # binary wire format (protobuf-negotiation analog); JSON remains default
    import msgpack as _msgpack
except Exception:  # ktpu-lint: disable=KTL002 -- import-time feature probe; the JSON wire format serves when msgpack is absent
    _msgpack = None

MSGPACK_CT = "application/x-msgpack"

_LOG = logging.getLogger(__name__)

from kubernetes_tpu_torch.api.selectors import compile_list_selector
from kubernetes_tpu_torch.metrics.registry import READ_REQUESTS, REGISTRY, REPLICA_LAG
from kubernetes_tpu_torch.store.flowcontrol import RejectedError
from kubernetes_tpu_torch.store.replication import NotLeader, QuorumLost
from kubernetes_tpu_torch.store.store import (
    AlreadyExists,
    Conflict,
    Event,
    NotFound,
    ObjectStore,
    TooOld,
)

# kind registries: plural -> (kind, namespaced)
CORE_RESOURCES = {
    "pods": ("Pod", True),
    "nodes": ("Node", False),
    "services": ("Service", True),
    "endpoints": ("Endpoints", True),
    "events": ("Event", True),
    "configmaps": ("ConfigMap", True),
    "namespaces": ("Namespace", False),
    "persistentvolumes": ("PersistentVolume", False),
    "persistentvolumeclaims": ("PersistentVolumeClaim", True),
    "resourcequotas": ("ResourceQuota", True),
    "limitranges": ("LimitRange", True),
    "secrets": ("Secret", True),
    "replicationcontrollers": ("ReplicationController", True),
    "serviceaccounts": ("ServiceAccount", True),
}
STORAGE_RESOURCES = {"storageclasses": ("StorageClass", False),
                     "volumeattachments": ("VolumeAttachment", False)}
SCHEDULING_RESOURCES = {"priorityclasses": ("PriorityClass", False)}
APPS_RESOURCES = {
    "deployments": ("Deployment", True),
    "replicasets": ("ReplicaSet", True),
    "statefulsets": ("StatefulSet", True),
    "daemonsets": ("DaemonSet", True),
    "jobs": ("Job", True),
}
BATCH_RESOURCES = {"cronjobs": ("CronJob", True)}
APIEXT_RESOURCES = {
    "customresourcedefinitions": ("CustomResourceDefinition", False)}
DRA_RESOURCES = {
    "resourceclaims": ("ResourceClaim", True),
    "resourceclaimtemplates": ("ResourceClaimTemplate", True),
    "deviceclasses": ("DeviceClass", False),
    "resourceslices": ("ResourceSlice", False),
}
AUTOSCALING_RESOURCES = {
    "horizontalpodautoscalers": ("HorizontalPodAutoscaler", True)}
DISCOVERY_RESOURCES = {"endpointslices": ("EndpointSlice", True)}
COORD_RESOURCES = {"leases": ("Lease", True)}
POLICY_RESOURCES = {"poddisruptionbudgets": ("PodDisruptionBudget", True)}
RBAC_RESOURCES = {
    "roles": ("Role", True),
    "rolebindings": ("RoleBinding", True),
    "clusterroles": ("ClusterRole", False),
    "clusterrolebindings": ("ClusterRoleBinding", False),
}
ADMISSIONREG_RESOURCES = {
    "mutatingwebhookconfigurations": ("MutatingWebhookConfiguration", False),
    "validatingwebhookconfigurations": ("ValidatingWebhookConfiguration",
                                        False),
}
APIREG_RESOURCES = {"apiservices": ("APIService", False)}
CERT_RESOURCES = {
    "certificatesigningrequests": ("CertificateSigningRequest", False)}

ALL_RESOURCES = {**CORE_RESOURCES, **APPS_RESOURCES, **COORD_RESOURCES,
                 **STORAGE_RESOURCES, **SCHEDULING_RESOURCES,
                 **RBAC_RESOURCES, **POLICY_RESOURCES, **BATCH_RESOURCES,
                 **AUTOSCALING_RESOURCES, **DISCOVERY_RESOURCES,
                 **DRA_RESOURCES, **APIEXT_RESOURCES,
                 **ADMISSIONREG_RESOURCES, **APIREG_RESOURCES,
                 **CERT_RESOURCES}
KIND_TO_PLURAL = {k: p for p, (k, _) in ALL_RESOURCES.items()}

# API group per kind (core = ""), for GroupVersionKind-bearing payloads
# (admission webhooks' AdmissionReview.request.kind)
KIND_TO_GROUP = {}
for _table, _group in ((CORE_RESOURCES, ""), (APPS_RESOURCES, "apps"),
                       (COORD_RESOURCES, "coordination.k8s.io"),
                       (STORAGE_RESOURCES, "storage.k8s.io"),
                       (SCHEDULING_RESOURCES, "scheduling.k8s.io"),
                       (RBAC_RESOURCES, "rbac.authorization.k8s.io"),
                       (POLICY_RESOURCES, "policy"),
                       (BATCH_RESOURCES, "batch"),
                       (AUTOSCALING_RESOURCES, "autoscaling"),
                       (DISCOVERY_RESOURCES, "discovery.k8s.io"),
                       (DRA_RESOURCES, "resource.k8s.io"),
                       (APIEXT_RESOURCES, "apiextensions.k8s.io"),
                       (ADMISSIONREG_RESOURCES,
                        "admissionregistration.k8s.io"),
                       (APIREG_RESOURCES, "apiregistration.k8s.io"),
                       (CERT_RESOURCES, "certificates.k8s.io")):
    for _k, _ns in _table.values():
        KIND_TO_GROUP[_k] = _group


class AdmissionError(Exception):
    pass


class _BadRequest(Exception):
    pass


class _HTTPServer(ThreadingHTTPServer):
    # Generous listen backlog: clients hold per-thread keep-alive
    # connections now, so backlog pressure comes from many components
    # CONNECTING at once (startup, reconnect storms after a restart)
    # rather than per-request churn — but a burst of fresh connections
    # would still overflow http.server's default backlog of 5 instantly.
    request_queue_size = 128

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        # live connections, so stop() can sever keep-alive sockets whose
        # handler threads would otherwise keep serving after shutdown()
        self._conns: set = set()
        self._conns_lock = threading.Lock()

    def close_all_connections(self):
        import socket as _socket
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass

    def handle_error(self, request, client_address):
        import sys
        exc = sys.exc_info()[1]
        if isinstance(exc, (ConnectionResetError, BrokenPipeError)):
            return  # severed keep-alive (stop() or client teardown)
        super().handle_error(request, client_address)


# ``ktpu status`` reads the apiserver's durability block (WAL growth,
# snapshot age, replay cost, readyz state) from this ConfigMap — published
# by durable-mode servers only (in-memory stores have nothing to report)
APISERVER_CONFIGMAP = "kubernetes-tpu-apiserver-status"


class APIServer:
    def __init__(self, store: Optional[ObjectStore] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 data_dir: Optional[str] = None,
                 async_restore: bool = False):
        """``data_dir``: durable mode — the store journals every write and
        restores state on construction (store.py WAL + snapshot).
        ``async_restore``: defer the WAL replay to a background thread
        started by ``start()`` — the server binds and serves immediately,
        answering 503 on ``/readyz`` and every resource path until replay
        completes (upstream's not-yet-ready startup window)."""
        self._ready = threading.Event()
        self._async_restore = async_restore and store is None and bool(data_dir)
        if store is not None:
            self.store = store
        else:
            self.store = ObjectStore(data_dir=data_dir,
                                     defer_restore=self._async_restore)
        if not self._async_restore:
            # readiness is a property of the RESTORE, not of start():
            # a synchronously-constructed store is already replayed, and
            # embedders that serve this handler without start() (the
            # aggregator's in-process delegate) must not 503
            self._ready.set()
        from kubernetes_tpu_torch.api.scheme import default_scheme
        # multi-version serving: (kind, served version) -> conversion pair
        # (runtime.Scheme analog, api/scheme.py); storage stays at the hub
        self.scheme = default_scheme()
        self.admission: list[Callable] = []
        self.flow = None  # FlowController when APF is enabled
        self.authenticator = None  # set by enable_auth
        self.authorizer = None
        self.audit = None
        # dynamic resources served for stored CustomResourceDefinitions
        # (apiextensions-apiserver analog): plural -> (Kind, namespaced).
        # The lock serializes validate+write: collision checks are
        # check-then-act and handler threads race (ThreadingHTTPServer).
        self.custom_resources: dict[str, tuple[str, bool]] = {}
        # Read-replica serving plane ("front door"): when the store is a
        # ReplicatedStore, this server may be fronting a FOLLOWER — reads
        # and watches serve locally (with an X-KTPU-Replay-Lag header),
        # writes surface NotLeader as 421 + X-KTPU-Leader so clients
        # re-route. api_urls maps raft node ids -> apiserver base URLs
        # (NotLeader.leader_hint carries the raft PEER url, which no API
        # client can use); max_replay_lag_s bounds staleness for /readyz.
        self.api_urls: dict[str, str] = {}
        self.max_replay_lag_s = 2.0
        # reads served and writes answered 421 by THIS server (the
        # READ_REQUESTS metric is per role, shared by the servers of one
        # process): /frontdoor/status reports them
        self._served = {"reads": 0, "notLeader": 0}
        self._served_lock = threading.Lock()
        self._crd_lock = threading.RLock()
        self._rebuild_custom()  # durable restore may already hold CRDs
        self._httpd = _HTTPServer((host, port), self._make_handler())
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None
        self._restore_thread: Optional[threading.Thread] = None
        self._publish_thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()

    # ---- CRDs (apiextensions.k8s.io) -------------------------------------

    def _rebuild_custom(self) -> None:
        crds, _ = self.store.list("CustomResourceDefinition")
        table: dict[str, tuple[str, bool]] = {}
        for crd in crds:
            spec = crd.get("spec") or {}
            names = spec.get("names") or {}
            plural, kind = names.get("plural", ""), names.get("kind", "")
            if plural and kind and plural not in ALL_RESOURCES:
                table[plural] = (kind, spec.get("scope", "Namespaced")
                                 == "Namespaced")
        self.custom_resources = table

    def validate_crd(self, body: dict) -> Optional[str]:
        """-> error message or None (apiextensions validation essentials).
        Both plural AND kind must be collision-free against built-ins and
        every other stored CRD — the store is keyed by kind and the delete
        cascade removes by kind, so a shared kind would let one CRD serve
        (or wipe) another's objects."""
        spec = body.get("spec") or {}
        names = spec.get("names") or {}
        if not spec.get("group"):
            return "spec.group is required"
        plural, kind = names.get("plural"), names.get("kind")
        if not plural or not kind:
            return "spec.names.plural and spec.names.kind are required"
        if plural in ALL_RESOURCES:
            return f"plural {plural!r} shadows a built-in resource"
        builtin_kinds = {k for (k, _ns) in ALL_RESOURCES.values()}
        if kind in builtin_kinds:
            return f"kind {kind!r} shadows a built-in kind"
        my_name = (body.get("metadata") or {}).get("name", "")
        others, _ = self.store.list("CustomResourceDefinition")
        for other in others:
            omd = other.get("metadata") or {}
            onames = (other.get("spec") or {}).get("names") or {}
            if omd.get("name") == my_name:
                # updating self: plural/kind are immutable — the store keys
                # objects by kind, so changing either would orphan every
                # existing instance (unroutable AND missed by the cascade)
                if onames.get("plural") != plural or onames.get("kind") != kind:
                    return "spec.names.plural and spec.names.kind are immutable"
                continue
            if onames.get("plural") == plural:
                return f"plural {plural!r} already served by CRD " \
                       f"{omd.get('name')!r}"
            if onames.get("kind") == kind:
                return f"kind {kind!r} already served by CRD " \
                       f"{omd.get('name')!r}"
        return None

    def _crd_guard(self, kind: str):
        """Serialize CRD validate+write+table-rebuild; no-op otherwise."""
        import contextlib
        return (self._crd_lock if kind == "CustomResourceDefinition"
                else contextlib.nullcontext())

    def _on_crd_change(self, crd: dict, deleted: bool) -> None:
        """Refresh the serving table; deleting a CRD deletes its instances
        (the apiextensions finalizer's cascade)."""
        if deleted:
            kind = ((crd.get("spec") or {}).get("names") or {}).get("kind", "")
            if kind:
                objs, _ = self.store.list(kind)
                for o in objs:
                    md = o.get("metadata") or {}
                    try:
                        self.store.delete(kind, md.get("namespace", ""),
                                          md.get("name", ""))
                    except NotFound:
                        pass
        self._rebuild_custom()

    # ---- lifecycle -------------------------------------------------------

    SYSTEM_NAMESPACES = ("default", "kube-system", "kube-public",
                         "kube-node-lease")

    def _finish_startup(self):
        """Restore (async mode), seed system namespaces, flip ready. In
        async mode this runs on a background thread while the HTTP server
        already answers 503s; synchronous starts run it inline BEFORE the
        serve thread, preserving the original ordering."""
        if self._stopping.is_set():
            return  # stop() won the race: stay not-ready, touch nothing
        self.store.finish_restore()
        if self._stopping.is_set():
            return
        # the system namespaces always exist (pkg/controlplane's
        # SystemNamespaces controller creates them on startup): namespaced
        # controllers like the root-CA publisher key off Namespace objects
        for ns in self.SYSTEM_NAMESPACES:
            try:
                self.store.create("Namespace", {
                    "kind": "Namespace", "metadata": {"name": ns},
                    "status": {"phase": "Active"}})
            except AlreadyExists:
                pass
            except NotLeader:
                # a front-door REPLICA must not seed: bootstrap writes are
                # the leader's, and replication delivers them here
                break
        # durable restore may already hold CRDs the empty pre-restore
        # rebuild missed
        self._rebuild_custom()
        self._ready.set()
        self.publish_durability()

    def start(self):
        if not self._async_restore:
            self._finish_startup()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        if self._async_restore:
            self._restore_thread = threading.Thread(
                target=self._finish_startup, daemon=True,
                name="apiserver-restore")
            self._restore_thread.start()
        if getattr(self.store, "_data_dir", None):
            self._publish_thread = threading.Thread(
                target=self._publish_loop, daemon=True,
                name="apiserver-status-publish")
            self._publish_thread.start()
        return self

    def stop(self):
        self._stopping.set()
        if self._restore_thread is not None:
            # an in-flight deferred restore must settle before the store
            # closes: store._closed keeps a late finish_restore from
            # reopening the WAL, but joining avoids even transient reads
            # against a directory a successor may be replaying
            self._restore_thread.join(timeout=10.0)
        if self._thread is not None:
            # shutdown() waits on an event only serve_forever() sets —
            # calling it on a never-started server deadlocks forever
            self._httpd.shutdown()
        # sever established keep-alive connections: shutdown() only stops
        # the ACCEPT loop — handler threads would keep serving (and
        # mutating the store) on pooled client sockets after stop
        self._httpd.close_all_connections()
        self._httpd.server_close()
        self.store.close()

    @property
    def ready(self) -> bool:
        return self._ready.is_set()

    def wait_ready(self, timeout: float = 30.0) -> bool:
        return self._ready.wait(timeout)

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    # ---- front door (read-replica serving plane) -------------------------

    @property
    def raft(self):
        """The RaftNode when the store is a ReplicatedStore, else None."""
        return getattr(self.store, "node", None)

    @property
    def role(self) -> str:
        node = self.raft
        return "replica" if node is not None and not node.is_leader() \
            else "leader"

    def replay_lag_s(self) -> Optional[float]:
        """Replica staleness in seconds; None when this server is the
        leader (or unreplicated) — the X-KTPU-Replay-Lag header and the
        lag-gated /readyz both key on this."""
        node = self.raft
        if node is None or node.is_leader():
            return None
        lag = node.replica_lag()
        REPLICA_LAG.set(lag)
        return lag

    def frontdoor_status(self) -> dict:
        """One replica's slice of the front-door picture: role, replay
        lag, and the store's watch fan-out stats (served at GET
        /frontdoor/status; the leader's publisher aggregates these into
        the kubernetes-tpu-frontdoor-status ConfigMap)."""
        node = self.raft
        lag = self.replay_lag_s()
        with self._served_lock:
            served = dict(self._served)
        out = {"role": self.role,
               "node": getattr(node, "node_id", None),
               "replayLagMs": (None if lag is None
                               else round(lag * 1000.0, 3)),
               "ready": self.ready,
               "watch": self.store.watch_stats(), **served}
        if node is not None:
            out["commitWait"] = self.store.commit_wait_stats()
        return out

    def _count_served(self, what: str) -> None:
        with self._served_lock:
            self._served[what] += 1

    # ---- durability status (data_dir mode) -------------------------------

    def durability_status(self) -> dict:
        st = self.store.durability_stats()
        st["ready"] = self._ready.is_set()
        return st

    def publish_durability(self) -> None:
        """Best-effort write of the durability ConfigMap ``ktpu status``
        reads (durable mode only — an in-memory store has no WAL to
        report). Publishing must never take the server down."""
        if not getattr(self.store, "_data_dir", None) or not self.ready:
            return
        body = {"apiVersion": "v1", "kind": "ConfigMap",
                "metadata": {"name": APISERVER_CONFIGMAP,
                             "namespace": "default"},
                "data": {"durability": json.dumps(self.durability_status())}}
        try:
            try:
                cur = self.store.get("ConfigMap", "default",
                                     APISERVER_CONFIGMAP)
                cur["data"] = body["data"]
                self.store.update("ConfigMap", cur)
            except NotFound:
                self.store.create("ConfigMap", body)
        except Exception:  # ktpu-lint: disable=KTL002 -- a racing writer or a closing store; the durability publisher retries next tick
            pass  # a racing writer or a closing store; next tick retries

    def _publish_loop(self) -> None:
        while not self._stopping.wait(5.0):
            self.publish_durability()

    def enable_flow_control(self, controller=None):
        """Turn on API Priority and Fairness (store/flowcontrol.py)."""
        from kubernetes_tpu_torch.store.flowcontrol import FlowController
        self.flow = controller or FlowController()
        return self

    def enable_auth(self, authenticator=None, authorizer=None, audit=None,
                    bootstrap: bool = True):
        """Install the authn -> audit -> impersonation -> (APF) -> authz
        filter chain (DefaultBuildHandlerChain order — store/auth.py).
        ``bootstrap`` seeds the default system: roles/bindings."""
        from kubernetes_tpu_torch.store.auth import (
            AuditLog, RBACAuthorizer, TokenAuthenticator, bootstrap_policy)
        self.authenticator = authenticator or TokenAuthenticator(
            secret_source=self.store)
        self.authorizer = authorizer or RBACAuthorizer(self.store)
        self.audit = audit if audit is not None else AuditLog()
        if bootstrap:
            for obj in bootstrap_policy():
                try:
                    self.store.create(obj["kind"], obj)
                except AlreadyExists:
                    pass
        return self

    def enable_admission(self, chain=None):
        """Install the default admission plugin set (store/admission.py)."""
        from kubernetes_tpu_torch.store.admission import default_chain
        (chain or default_chain(self.store)).install(self)
        return self

    # ---- request handling ------------------------------------------------

    def _admit(self, verb: str, kind: str, obj: dict,
               sub: Optional[str] = None, dry_run: bool = False) -> dict:
        """Run the admission chain. A plugin may return a mutated object, or a
        callable commit hook ``hook(ok: bool)`` invoked after the storage
        operation completes (two-phase: lets e.g. quota release its in-flight
        reservation exactly when the object becomes visible, instead of
        guessing by name — generateName objects have none at admission time).
        Collected hooks are stashed on the returned object under a private
        key the storage path pops before persisting. ``dry_run`` reaches the
        plugins that take it (the webhook dispatchers' sideEffects gate)."""
        from kubernetes_tpu_torch.store.admission import AdmissionChain
        hooks = []
        try:
            for fn in self.admission:
                # webhook dispatchers match rules against the subresource
                # (a hook registered for "pods" must NOT fire on every
                # status heartbeat; "pods/status" opts in) — built-in
                # plugins keep the 3-arg shape
                r = AdmissionChain._invoke(fn, verb, kind, obj, sub, dry_run)
                if callable(r):
                    hooks.append(r)
                elif r:
                    obj = r
                if isinstance(obj, dict):
                    hooks.extend(obj.pop("\x00admission_commits", []))
        except Exception:
            self._commit(hooks, False)  # release earlier plugins' holds
            raise
        if hooks:
            obj["\x00admission_commits"] = hooks
        return obj

    @staticmethod
    def _pop_commits(obj: dict) -> list:
        return obj.pop("\x00admission_commits", [])

    @staticmethod
    def _commit(hooks: list, ok: bool):
        for h in hooks:
            try:
                h(ok)
            except Exception:
                # commit hooks are best-effort, but a throwing hook is a
                # plugin bug worth surfacing
                _LOG.debug("admission commit hook failed", exc_info=True)

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # TCP_NODELAY: headers and body go out as separate writes; with
            # Nagle on, the body write waits for the client's delayed ACK —
            # a flat ~40ms stall per request capping ANY one keep-alive
            # connection at ~25 req/s no matter how fast the store is
            disable_nagle_algorithm = True

            def setup(self):
                super().setup()
                with self.server._conns_lock:
                    self.server._conns.add(self.connection)

            def finish(self):
                with self.server._conns_lock:
                    self.server._conns.discard(self.connection)
                super().finish()

            def log_message(self, *a):
                pass

            def _not_ready(self):
                """503 until WAL replay completes (async_restore): clients
                must not read an empty pre-restore store as truth, and
                /readyz is how orchestrators (and the chaos harness) know
                the replay finished."""
                self._drain_body()
                self._last_code = 503
                body = json.dumps({
                    "kind": "Status", "status": "Failure",
                    "message": "apiserver is not ready: WAL replay in "
                               "progress", "reason": "ServiceUnavailable",
                    "code": 503}).encode()
                self.send_response(503)
                self.send_header("Content-Type", "application/json")
                self.send_header("Retry-After", "1")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _quorum_routed(self, fn):
                """Replication-aware error mapping, wrapped around every
                handler when the store is replicated: a FOLLOWER answers
                mutations with 421 + an X-KTPU-Leader hint (the spread
                client re-routes and retries; reads never get here), and
                a leader that cannot establish quorum answers 503."""
                def run():
                    try:
                        return fn()
                    except NotLeader:
                        node = server.raft
                        hint = server.api_urls.get(
                            getattr(node, "leader_id", None) or "")
                        self._drain_body()
                        self._last_code = 421
                        server._count_served("notLeader")
                        body = json.dumps({
                            "kind": "Status", "status": "Failure",
                            "message": "not the leader"
                                       + (f"; try {hint}" if hint else ""),
                            "reason": "NotLeader", "code": 421}).encode()
                        self.send_response(421)
                        self.send_header("Content-Type", "application/json")
                        if hint:
                            self.send_header("X-KTPU-Leader", hint)
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    except QuorumLost as e:
                        return self._error(503, str(e), "ServiceUnavailable")
                return run

            def _shaped(self, verb: str, fn):
                # per-REQUEST state: one handler instance serves every
                # request on a keep-alive connection
                self._body_consumed = False
                self._last_code = 200
                if server.raft is not None:
                    fn = self._quorum_routed(fn)
                if not server._ready.is_set():
                    # only liveness + metrics answer during replay;
                    # /readyz reports the replay itself as 503
                    path = urlparse(self.path).path
                    if path not in ("/healthz", "/livez", "/metrics"):
                        return self._not_ready()
                """The filter chain, in DefaultBuildHandlerChain order:
                authn (401) -> audit -> impersonation (403) -> APF (429) ->
                authz (403) -> handler. Watches are long-running and exempt
                from APF seat accounting (upstream excludes them from the
                queueset after initial admission)."""
                self._user = None
                self._impersonated = None
                if server.authenticator is not None:
                    from kubernetes_tpu_torch.store.auth import AuthError
                    try:
                        self._user = server.authenticator.authenticate(
                            self.headers.get("Authorization", ""))
                    except AuthError as e:
                        return self._audited(401, lambda: self._error(
                            401, str(e), "Unauthorized"))
                    imp = self.headers.get("Impersonate-User")
                    if imp:
                        groups = tuple(
                            g for g in self.headers.get(
                                "Impersonate-Group", "").split(",") if g)
                        if not server.authorizer.can_impersonate(
                                self._user, groups):
                            return self._audited(403, lambda: self._error(
                                403, f"user {self._user.name!r} cannot "
                                     "impersonate", "Forbidden"))
                        from kubernetes_tpu_torch.store.auth import UserInfo
                        self._impersonated = self._user.name
                        self._user = UserInfo(imp, groups)
                if server.flow is None or "watch=true" in self.path:
                    return self._run_authorized(verb, fn)
                agent = self.headers.get("User-Agent", "")
                level = server.flow.classify(
                    verb, urlparse(self.path).path, agent)
                try:
                    # flow distinguisher: the authenticated user, falling
                    # back to the client agent (upstream: FlowSchema's
                    # distinguisherMethod over user/namespace)
                    server.flow.acquire(
                        level,
                        flow=(self._user.name if self._user else agent))
                except RejectedError as e:
                    self._drain_body()
                    body = json.dumps({"kind": "Status", "status": "Failure",
                                       "message": "too many requests",
                                       "reason": "TooManyRequests",
                                       "code": 429}).encode()
                    self.send_response(429)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Retry-After", str(int(e.retry_after)))
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    self._audit(429)
                    return None
                try:
                    return self._run_authorized(verb, fn)
                finally:
                    server.flow.release(level)

            def _run_authorized(self, http_verb: str, fn):
                """Authorize against the parsed route, then run + audit."""
                if server.authorizer is None or self._user is None:
                    return fn()
                from kubernetes_tpu_torch.store.auth import (
                    request_verb, resource_for)
                r = self._route()
                if r is not None:
                    plural, _kind, ns, name, sub = r
                    verb = request_verb(self.command, name,
                                        sub, urlparse(self.path).query)
                    resource = resource_for(plural, sub)
                    if not server.authorizer.authorize(
                            self._user, verb, resource, ns or "", name or ""):
                        return self._audited(403, lambda: self._error(
                            403, f"user {self._user.name!r} cannot {verb} "
                                 f"{resource}"
                                 + (f" in namespace {ns!r}" if ns else ""),
                            "Forbidden"))
                # non-resource paths (/metrics, /healthz, ...): any
                # authenticated (or anonymous-allowed) user may read
                return self._audited(None, fn)

            def _audit(self, code: int):
                if server.audit is None:
                    return
                user = self._user
                if user is None:  # failed authn is audited too
                    from kubernetes_tpu_torch.store.auth import ANONYMOUS, UserInfo
                    user = UserInfo(ANONYMOUS)
                server.audit.log(user=user, verb=self.command,
                                 path=self.path, code=code,
                                 impersonated=self._impersonated)

            def _audited(self, code, fn):
                try:
                    return fn()
                finally:
                    self._audit(code if code is not None
                                else getattr(self, "_last_code", 200))

            def _drain_body(self):
                """Consume an unread request body before responding: with
                keep-alive (HTTP/1.1), leftover body bytes would be parsed
                as the NEXT request line, 400ing every later request on the
                connection. Error/authz paths respond without ever calling
                _read_body, so this runs in front of every response."""
                if getattr(self, "_body_consumed", False):
                    return
                self._body_consumed = True
                n = int(self.headers.get("Content-Length") or 0)
                if n > 1 << 20:
                    # don't buffer attacker-sized bodies on pre-auth error
                    # paths: give up keep-alive for this connection instead
                    self.close_connection = True
                    return
                if n:
                    try:
                        self.rfile.read(n)
                    except Exception:  # ktpu-lint: disable=KTL002 -- client vanished mid-body; closing the connection IS the handling
                        self.close_connection = True

            def _wants_msgpack(self) -> bool:
                return (_msgpack is not None
                        and MSGPACK_CT in self.headers.get("Accept", ""))

            def _conv_in(self, kind: str, body: dict) -> dict:
                """Spoke-version request body -> the stored hub shape."""
                conv = server.scheme.converter(
                    kind, getattr(self, "_req_version", "v1"))
                return conv[0](body) if conv else body

            def _conv_out(self, kind: str, obj: dict) -> dict:
                """Stored hub shape -> the requested spoke version."""
                conv = server.scheme.converter(
                    kind, getattr(self, "_req_version", "v1"))
                return conv[1](obj) if conv else obj

            def _send_json(self, code: int, obj):
                """Respond in the NEGOTIATED format (the name is historic):
                msgpack when the client's Accept asks for it, JSON otherwise —
                the serializer-negotiation analog of the reference's
                JSON/protobuf content types."""
                self._drain_body()
                self._last_code = code
                if self._wants_msgpack():
                    body, ctype = _msgpack.packb(obj), MSGPACK_CT
                else:
                    body, ctype = json.dumps(obj).encode(), "application/json"
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                lag = server.replay_lag_s()
                if lag is not None:
                    # staleness is part of the response contract on a
                    # replica: every consumer can see how far behind the
                    # data it just read might be
                    self.send_header("X-KTPU-Replay-Lag",
                                     f"{lag * 1000.0:.3f}")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _error(self, code: int, msg: str, reason: str = ""):
                self._send_json(code, {"kind": "Status", "status": "Failure",
                                       "message": msg, "reason": reason,
                                       "code": code})

            def _read_body(self) -> dict:
                self._body_consumed = True
                n = int(self.headers.get("Content-Length", 0))
                if not n:
                    return {}
                raw = self.rfile.read(n)
                if (_msgpack is not None and MSGPACK_CT
                        in self.headers.get("Content-Type", "")):
                    try:
                        out = _msgpack.unpackb(raw)
                    except Exception as e:
                        raise _BadRequest(
                            f"invalid msgpack body: {e}") from None
                else:
                    try:
                        out = json.loads(raw)
                    except (json.JSONDecodeError, UnicodeDecodeError,
                            ValueError) as e:
                        # UnicodeDecodeError covers binary bodies reaching a
                        # JSON-only server — the 400 text is what a msgpack
                        # client's downgrade probe keys on, so it must be
                        # produced, not a dead handler thread
                        raise _BadRequest(f"invalid JSON body: {e}") from None
                if not isinstance(out, dict):
                    raise _BadRequest("body must be a JSON object")
                return out

            def _route(self):
                """-> (plural, kind, namespace|None, name|None, subresource|None)"""
                parts = [p for p in urlparse(self.path).path.split("/") if p]
                # /api/v1/... or /apis/<group>/<version>/...
                self._req_version = "v1"
                if parts[:2] == ["api", "v1"]:
                    rest = parts[2:]
                elif len(parts) >= 3 and parts[0] == "apis":
                    self._req_version = parts[2]
                    rest = parts[3:]
                else:
                    return None
                ns = None
                if rest and rest[0] == "namespaces" and len(rest) >= 3:
                    ns, rest = rest[1], rest[2:]
                elif rest and rest[0] == "namespaces":
                    rest = ["namespaces"] + rest[1:]
                if not rest:
                    return None
                plural = rest[0]
                if plural in ALL_RESOURCES:
                    kind, namespaced = ALL_RESOURCES[plural]
                elif plural in server.custom_resources:
                    kind, namespaced = server.custom_resources[plural]
                else:
                    return None
                name = rest[1] if len(rest) > 1 else None
                sub = rest[2] if len(rest) > 2 else None
                return plural, kind, ns, name, sub

            # ---- verbs ---------------------------------------------------

            def do_GET(self):
                return self._shaped("get", self._do_GET)

            def _do_GET(self):
                path = urlparse(self.path).path
                if path in ("/healthz", "/readyz", "/livez"):
                    if path == "/readyz":
                        # a replica whose replay lag exceeds the staleness
                        # budget is NOT ready: load balancers and the
                        # spread client must stop routing reads to it
                        # until it catches back up (healthz/livez stay
                        # 200 — the process is alive, just stale)
                        lag = server.replay_lag_s()
                        if lag is not None and lag > server.max_replay_lag_s:
                            return self._error(
                                503, f"replica replay lag {lag:.2f}s "
                                     f"exceeds {server.max_replay_lag_s}s",
                                "ServiceUnavailable")
                    body = b"ok"
                    self.send_response(200)
                    self.send_header("Content-Length", "2")
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if path == "/frontdoor/status":
                    return self._send_json(200, server.frontdoor_status())
                if path == "/debug/traces":
                    # OTLP/JSON export of the process tracer's spans;
                    # ?format=chrome serves Chrome trace-event JSON instead
                    # (flight-recorder pod tracks included) — curl it
                    # straight into ui.perfetto.dev
                    from kubernetes_tpu_torch.utils.tracing import (TRACER,
                                                              export_otlp_json)
                    q = parse_qs(urlparse(self.path).query)
                    if q.get("format", [""])[0] == "chrome":
                        return self._send_json(200, TRACER.export_chrome())
                    return self._send_json(200, export_otlp_json(TRACER))
                if path == "/debug/stacks":
                    # /debug/pprof goroutine-dump analog
                    from kubernetes_tpu_torch.utils.tracing import dump_stacks
                    body = dump_stacks().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if path == "/metrics":
                    body = REGISTRY.expose_text().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                r = self._route()
                if r is None:
                    return self._error(404, f"unknown path {path}")
                plural, kind, ns, name, sub = r
                READ_REQUESTS.inc({"role": server.role})
                server._count_served("reads")
                qs = parse_qs(urlparse(self.path).query)
                if sub == "scale" and name:
                    if kind not in SCALABLE_KINDS:
                        # upstream 404s unregistered scale subresources —
                        # falling through would leak the full object
                        return self._error(
                            404, f"{kind} has no scale subresource",
                            "NotFound")
                    try:
                        obj = server.store.get(kind, ns or "", name)
                    except NotFound as e:
                        return self._error(404, str(e), "NotFound")
                    return self._send_json(200, _scale_of(kind, obj))
                if sub == "log" and kind == "Pod" and name:
                    # kubectl logs: proxy to the pod's kubelet
                    # (kubelet server /containerLogs, reached via
                    # node.status.daemonEndpoints — upstream's pod log
                    # subresource does exactly this hop)
                    return self._proxy_kubelet_get(
                        ns or "default", name,
                        qs.get("container", [""])[0])
                if name:
                    try:
                        obj = server.store.get(kind, ns or "", name)
                    except NotFound as e:
                        return self._error(404, str(e), "NotFound")
                    return self._send_json(200, self._conv_out(kind, obj))
                if qs.get("watch", ["false"])[0] in ("true", "1"):
                    return self._watch(kind, ns, qs)
                sel = _field_label_selector(qs)
                items, rv = server.store.list(kind, namespace=ns, selector=sel)
                if server.scheme.converter(kind, self._req_version):
                    items = [self._conv_out(kind, o) for o in items]
                return self._send_json(200, {
                    "kind": f"{kind}List", "apiVersion": "v1",
                    "metadata": {"resourceVersion": str(rv)}, "items": items})

            def _proxy_portforward(self, ns: str, pod_name: str):
                """Upgrade the client connection and splice it through to
                the pod's kubelet /portForward stream — the apiserver leg of
                kubectl port-forward (upstream: SPDY through the same two
                hops)."""
                ep = self._kubelet_endpoint(ns, pod_name)
                if ep is None:
                    return None
                base, _pod = ep
                from urllib.parse import urlsplit
                from kubernetes_tpu_torch.kubelet.server import (
                    connect_upgrade, splice_upgraded)
                parts = urlsplit(base)
                try:
                    # dial the kubelet FIRST: an unreachable/stale endpoint
                    # must surface as 502, not a silent post-101 close
                    upstream, leftover = connect_upgrade(
                        (parts.hostname, parts.port),
                        f"/portForward/{ns}/{pod_name}")
                except OSError as e:
                    return self._error(502, f"kubelet proxy: {e}",
                                       "BadGateway")
                self.send_response(101)
                self.send_header("Upgrade", "tcp")
                self.send_header("Connection", "Upgrade")
                self.end_headers()
                self.wfile.flush()
                splice_upgraded(self.connection, upstream, leftover)
                self.close_connection = True
                return None

            def _dry_run(self) -> bool:
                qs = parse_qs(urlparse(self.path).query)
                return bool(qs.get("dryRun"))

            def _kubelet_endpoint(self, ns: str, pod_name: str):
                """-> (base_url, pod) or an error response already sent."""
                try:
                    pod = server.store.get("Pod", ns, pod_name)
                except NotFound as e:
                    self._error(404, str(e), "NotFound")
                    return None
                node_name = (pod.get("spec") or {}).get("nodeName", "")
                if not node_name:
                    self._error(400, "pod is not scheduled", "BadRequest")
                    return None
                try:
                    node = server.store.get("Node", "", node_name)
                except NotFound:
                    self._error(502, f"node {node_name!r} not found",
                                "BadGateway")
                    return None
                st = node.get("status") or {}
                ep = ((st.get("daemonEndpoints") or {})
                      .get("kubeletEndpoint") or {})
                port = ep.get("Port")
                addr = next((a.get("address") for a in
                             st.get("addresses") or []
                             if a.get("type") == "InternalIP"), "127.0.0.1")
                if not port:
                    self._error(502, "kubelet endpoint not registered",
                                "BadGateway")
                    return None
                return f"http://{addr}:{port}", pod

            def _proxy_kubelet_get(self, ns, pod_name, container):
                ep = self._kubelet_endpoint(ns, pod_name)
                if ep is None:
                    return None
                base, pod = ep
                if not container:
                    ctrs = (pod.get("spec") or {}).get("containers") or []
                    container = (ctrs[0].get("name", "") if ctrs else "")
                import urllib.request as _rq
                try:
                    with _rq.urlopen(
                            f"{base}/containerLogs/{ns}/{pod_name}/"
                            f"{container}", timeout=10.0) as resp:
                        body = resp.read()
                except Exception as e:
                    return self._error(502, f"kubelet proxy: {e}",
                                       "BadGateway")
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _watch(self, kind: str, ns, qs):
                # Namespace filtering happens here (matching DirectClient's
                # _NamespaceFilteredWatch); label/field selector filtering is
                # deliberately left to the informer layer, which needs to see
                # matched -> unmatched MODIFIEDs to synthesize DELETEDs.
                since = int(qs.get("resourceVersion", ["0"])[0] or 0)
                try:
                    w = server.store.watch(kind, since_rv=since)
                except TooOld:
                    return self._error(410, "resourceVersion too old", "Expired")
                # Stream format rides the Accept header: msgpack frames
                # (heartbeat = single nil byte 0xc0) or newline-JSON lines
                # (heartbeat = bare newline). Event payload bytes are
                # serialized once per event PER FORMAT and shared across
                # every watcher of that format.
                use_mp = self._wants_msgpack()
                if use_mp:
                    payload = Event.wire_msgpack
                    heartbeat = b"1\r\n\xc0\r\n"
                    ctype = MSGPACK_CT
                else:
                    payload = Event.wire
                    heartbeat = b"1\r\n\n\r\n"
                    ctype = "application/json"
                conv = server.scheme.converter(kind, self._req_version)
                if conv is not None:
                    # spoke-version watch: per-watcher serialization (the
                    # zero-copy shared wire bytes carry the hub shape)
                    from_hub = conv[1]
                    if use_mp:
                        payload = lambda e: _msgpack.packb(
                            {"type": e.type, "object": from_hub(e.object)})
                    else:
                        payload = lambda e: json.dumps(
                            {"type": e.type,
                             "object": from_hub(e.object)}).encode() + b"\n"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                lag = server.replay_lag_s()
                if lag is not None:
                    self.send_header("X-KTPU-Replay-Lag",
                                     f"{lag * 1000.0:.3f}")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                try:
                    idle = 0
                    while True:
                        ev = w.get(timeout=0.5)
                        if w.closed:
                            # stream invalidated (restore): terminate the
                            # chunked response so the client sees EOF at once
                            # instead of waiting out its heartbeat grace
                            self.wfile.write(b"0\r\n\r\n")
                            self.wfile.flush()
                            self.close_connection = True
                            break
                        if ev is None:
                            idle += 1
                            if idle >= 2:  # ~1s heartbeat
                                self.wfile.write(heartbeat)
                                self.wfile.flush()
                                idle = 0
                            continue
                        idle = 0
                        # Batch: everything already queued goes out in ONE
                        # socket write (one chunk per event keeps the client
                        # protocol unchanged) — per-event write+flush was a
                        # measurable slice of a binding storm's host time.
                        evs = [ev]
                        while len(evs) < 256:
                            nxt = w.get(timeout=0)
                            if nxt is None:
                                break
                            evs.append(nxt)
                        chunks = []
                        for e in evs:
                            if ns is not None and (e.object.get("metadata") or
                                                   {}).get("namespace", "") != ns:
                                continue
                            # serialized once per event, shared across watchers
                            line = payload(e)
                            chunks.append(hex(len(line))[2:].encode() + b"\r\n"
                                          + line + b"\r\n")
                        if chunks:
                            self.wfile.write(b"".join(chunks))
                            self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass
                finally:
                    w.stop()

            def do_POST(self):
                return self._shaped("post", self._do_POST)

            def _do_POST(self):
                r = self._route()
                if r is None:
                    return self._error(404, "unknown path")
                plural, kind, ns, name, sub = r
                try:
                    body = self._read_body()
                except _BadRequest as e:
                    return self._error(400, str(e), "BadRequest")
                if sub is None:
                    body = self._conv_in(kind, body)
                if sub == "exec" and kind == "Pod" and name:
                    ep = self._kubelet_endpoint(ns or "default", name)
                    if ep is None:
                        return None
                    base, _pod = ep
                    qs2 = parse_qs(urlparse(self.path).query)
                    container = qs2.get("container", [""])[0]
                    if not container:
                        ctrs = (_pod.get("spec") or {}).get("containers") or []
                        container = (ctrs[0].get("name", "") if ctrs else "")
                    import urllib.request as _rq
                    try:
                        req2 = _rq.Request(
                            f"{base}/exec/{ns or 'default'}/{name}/"
                            f"{container}",
                            data=json.dumps(body).encode(),
                            headers={"Content-Type": "application/json"},
                            method="POST")
                        with _rq.urlopen(req2, timeout=15.0) as resp:
                            out_body = resp.read()
                    except Exception as e:
                        return self._error(502, f"kubelet proxy: {e}",
                                           "BadGateway")
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(out_body)))
                    self.end_headers()
                    self.wfile.write(out_body)
                    return None
                if sub == "portforward" and kind == "Pod" and name:
                    return self._proxy_portforward(ns or "default", name)
                if sub == "binding" and kind == "Pod" and name == "-":
                    # Bulk binding: one POST applies many bindings in a single
                    # store lock pass (the scheduler's gang step binds a whole
                    # batch at once — per-pod POSTs were the connected path's
                    # dominant cost). Body: {"bindings": [{"namespace":...,
                    # "name":..., "target": {"name": node}}]}; response is a
                    # per-item status array in request order.
                    items = body.get("bindings")
                    if not isinstance(items, list):
                        return self._error(400, "bindings must be a list",
                                           "BadRequest")
                    reqs = []
                    for it in items:
                        tgt = (it.get("target") or {}).get("name", "")
                        reqs.append((it.get("namespace", ns or "default"),
                                     it.get("name", ""), tgt))
                    errors = server.store.bind_many(reqs)
                    results = [
                        {"code": 200} if e is None else
                        {"code": 404 if "not found" in e else 409,
                         "message": e,
                         "reason": ("NotFound" if "not found" in e
                                    else "Conflict")}
                        for e in errors]
                    return self._send_json(200, {"kind": "Status",
                                                 "results": results})
                if sub == "status" and kind == "Pod" and name == "-":
                    # Bulk status: one POST applies many kubelet status
                    # writes in a single store lock pass (a hollow-kubelet
                    # fleet emits thousands of Pending->Running transitions
                    # in seconds; per-pod PUTs were the kubemark
                    # bottleneck). Body: {"statuses": [{"namespace":...,
                    # "name":..., "status": {...}}]}; response is a
                    # per-item status array in request order.
                    items = body.get("statuses")
                    if not isinstance(items, list):
                        return self._error(400, "statuses must be a list",
                                           "BadRequest")
                    reqs = [(it.get("namespace", ns or "default"),
                             it.get("name", ""), it.get("status") or {})
                            for it in items]
                    errors = server.store.update_status_many("Pod", reqs)
                    results = [
                        {"code": 200} if e is None else
                        {"code": 404, "message": e, "reason": "NotFound"}
                        for e in errors]
                    return self._send_json(200, {"kind": "Status",
                                                 "results": results})
                if sub == "status" and kind == "Node" and name == "-":
                    # Bulk heartbeat: one POST refreshes many nodes' status
                    # conditions in a single store lock pass with ONE watch
                    # fan-out pass per batch (a 10k hollow-node fleet's
                    # per-node GET+PUT heartbeat chatter was the control-
                    # plane bottleneck once the device program got cheap).
                    # Body: {"statuses": [{"name":..., "status": {...}}]};
                    # conditions merge by type server-side; response is a
                    # per-item status array in request order.
                    items = body.get("statuses")
                    if not isinstance(items, list):
                        return self._error(400, "statuses must be a list",
                                           "BadRequest")
                    reqs = [(it.get("name", ""), it.get("status") or {})
                            for it in items]
                    errors = server.store.heartbeat_many(reqs)
                    results = [
                        {"code": 200} if e is None else
                        {"code": 404, "message": e, "reason": "NotFound"}
                        for e in errors]
                    return self._send_json(200, {"kind": "Status",
                                                 "results": results})
                if sub == "renew" and kind == "Lease" and name == "-":
                    # Bulk lease renewal: one POST bumps many Leases'
                    # spec.renewTime in a single store lock pass (the
                    # kube-node-lease analog of the bulk heartbeat — the
                    # kubelet's cheap liveness signal, batched fleet-wide).
                    # Body: {"renews": [{"name":..., "renewTime": <epoch>}]};
                    # missing leases report per-item 404s without failing
                    # siblings (the fleet batcher creates them in bulk).
                    items = body.get("renews")
                    if not isinstance(items, list):
                        return self._error(400, "renews must be a list",
                                           "BadRequest")
                    import time as _time
                    reqs = [(it.get("name", ""),
                             float(it.get("renewTime") or _time.time()))
                            for it in items]
                    errors = server.store.renew_leases(
                        ns or "kube-node-lease", reqs)
                    results = [
                        {"code": 200} if e is None else
                        {"code": 404, "message": e, "reason": "NotFound"}
                        for e in errors]
                    return self._send_json(200, {"kind": "Status",
                                                 "results": results})
                if sub == "binding" and kind == "Pod":
                    # BindingREST.Create: set spec.nodeName if not already set.
                    target = body.get("target", {}).get("name", "")
                    try:
                        pod = server.store.get("Pod", ns or "", name)
                    except NotFound as e:
                        return self._error(404, str(e), "NotFound")
                    if pod.get("spec", {}).get("nodeName"):
                        return self._error(409, "pod already bound", "Conflict")
                    pod["spec"]["nodeName"] = target
                    pod.setdefault("status", {})["phase"] = "Pending"
                    try:
                        # rv precondition: two racing binders -> second gets 409
                        out = server.store.update(
                            "Pod", pod,
                            expect_rv=pod["metadata"]["resourceVersion"])
                    except Conflict as e:
                        return self._error(409, str(e), "Conflict")
                    return self._send_json(201, out)
                if sub == "eviction" and kind == "Pod":
                    # Eviction API honors PodDisruptionBudgets
                    # (registry/core/pod/storage/eviction.go): 429 when the
                    # governing budget has no disruptions left. Preemption
                    # deletes pods directly and is allowed to violate PDBs as
                    # a last resort, exactly as upstream.
                    from kubernetes_tpu_torch.api.policy import disruptions_allowed_for
                    try:
                        pod_obj = server.store.get("Pod", ns or "", name)
                    except NotFound as e:
                        return self._error(404, str(e), "NotFound")
                    pdbs, _ = server.store.list("PodDisruptionBudget",
                                                namespace=ns or "")
                    if pdbs:
                        pods_ns, _ = server.store.list("Pod", namespace=ns or "")
                        allowed, governing = disruptions_allowed_for(
                            pod_obj, pdbs, pods_ns)
                        if allowed <= 0:
                            g = (governing or {}).get("metadata", {}).get(
                                "name", "")
                            return self._error(
                                429, f"Cannot evict pod as it would violate "
                                     f"the pod's disruption budget {g!r}",
                                "TooManyRequests")
                    try:
                        out = server.store.delete("Pod", ns or "", name)
                    except NotFound as e:
                        return self._error(404, str(e), "NotFound")
                    return self._send_json(200, out)
                if self._dry_run() and (
                        body.get("kind") == "List"
                        and isinstance(body.get("items"), list)):
                    # honest over silent: the batch path has per-item
                    # store semantics a preview can't faithfully simulate
                    return self._error(
                        400, "dryRun is not supported for bulk creates",
                        "BadRequest")
                if body.get("kind") == "List" and isinstance(
                        body.get("items"), list) and kind != "CustomResourceDefinition":
                    # Bulk create: POST a v1 List manifest to a collection
                    # path creates every item in one store lock pass (the
                    # write-side analog of chunked LIST reads; kubectl's
                    # ``apply -f`` emits exactly this shape for multi-doc
                    # manifests). Admission runs per item; per-item failures
                    # report in order without aborting siblings.
                    results = []
                    to_create = []
                    for item in body["items"]:
                        md = item.setdefault("metadata", {})
                        if ns:
                            md["namespace"] = ns
                        try:
                            item = server._admit("CREATE", kind, item)
                        except AdmissionError as e:
                            results.append({"code": 400, "message": str(e),
                                            "reason": "AdmissionDenied"})
                            continue
                        hooks = server._pop_commits(item)
                        to_create.append((len(results), item, hooks))
                        results.append({"code": 201})
                    for idx, item, hooks in to_create:
                        try:
                            out = server.store.create(kind, item, owned=True)
                            # server-stamped identity back to the client
                            # (full objects would double the response size
                            # of a 10k-item storm for fields callers rarely
                            # read beyond metadata)
                            results[idx]["metadata"] = out["metadata"]
                            server._commit(hooks, True)
                        except AlreadyExists as e:
                            results[idx] = {"code": 409, "message": str(e),
                                            "reason": "AlreadyExists"}
                            server._commit(hooks, False)
                    return self._send_json(200, {"kind": "Status",
                                                 "results": results})
                with server._crd_guard(kind):
                    if kind == "CustomResourceDefinition":
                        err = server.validate_crd(body)
                        if err:
                            return self._error(400, err, "Invalid")
                    md = body.setdefault("metadata", {})
                    if ns:
                        # stamp the request-URL namespace BEFORE admission:
                        # namespace-scoped policy (PodSecurity, quota)
                        # reads it off the object
                        md["namespace"] = ns
                    try:
                        body = server._admit("CREATE", kind, body,
                                             dry_run=self._dry_run())
                    except AdmissionError as e:
                        return self._error(400, str(e), "AdmissionDenied")
                    commits = server._pop_commits(body)
                    # a mutating webhook's JSON patch deep-copies the
                    # object: re-resolve metadata and re-stamp the request
                    # namespace on the post-admission dict
                    md = body.setdefault("metadata", {})
                    if ns:
                        md["namespace"] = ns
                    if self._dry_run():
                        # server-side dry run (?dryRun=All, endpoints/
                        # handlers/create.go): the FULL path — admission
                        # mutations included — except persistence; quota
                        # holds release as failed commits
                        server._commit(commits, False)
                        name_prev = md.get("name", "")
                        if not name_prev and md.get("generateName"):
                            # name generation runs in real creates; the
                            # preview synthesizes the same shape without
                            # consuming the suffix counter
                            name_prev = md["name"] =                                 f"{md['generateName']}xxxxx"
                        if name_prev:
                            try:
                                server.store.get(kind, ns or "", name_prev)
                                if not md.get("generateName"):
                                    return self._error(
                                        409, f"{kind} {name_prev!r} "
                                             "already exists",
                                        "AlreadyExists")
                            except NotFound:
                                pass
                        return self._send_json(
                            201, self._conv_out(kind, body))
                    try:
                        # body is this request's freshly-parsed JSON: hand
                        # ownership to the store (skips its defensive copy)
                        out = server.store.create(kind, body, owned=True)
                    except AlreadyExists as e:
                        server._commit(commits, False)
                        return self._error(409, str(e), "AlreadyExists")
                    except Exception:
                        server._commit(commits, False)
                        raise
                    server._commit(commits, True)
                    if kind == "CustomResourceDefinition":
                        server._on_crd_change(out, deleted=False)
                    return self._send_json(201, self._conv_out(kind, out))

            def do_PUT(self):
                return self._shaped("put", self._do_PUT)

            def _do_PUT(self):
                r = self._route()
                if r is None:
                    return self._error(404, "unknown path")
                plural, kind, ns, name, sub = r
                try:
                    body = self._read_body()
                except _BadRequest as e:
                    return self._error(400, str(e), "BadRequest")
                if sub == "scale" and name:
                    if kind not in SCALABLE_KINDS:
                        # the full-object update path would store the Scale
                        # body AS the object — 404 like upstream
                        return self._error(
                            404, f"{kind} has no scale subresource",
                            "NotFound")
                    if self._dry_run():
                        # preview: current object with replicas applied
                        try:
                            cur = server.store.get(kind, ns or "", name)
                        except NotFound as e:
                            return self._error(404, str(e), "NotFound")
                        raw0 = (body.get("spec") or {}).get("replicas")
                        if raw0 is None:
                            return self._error(
                                400, "spec.replicas is required",
                                "BadRequest")
                        cur.setdefault("spec", {})["replicas"] = int(raw0)
                        return self._send_json(200, _scale_of(kind, cur))
                    # ScaleREST.Update: only spec.replicas moves. A caller
                    # rv is the strict precondition; with none, this is a
                    # GuaranteedUpdate-style retry against each read's own
                    # rv so a concurrent writer is never silently reverted
                    raw = (body.get("spec") or {}).get("replicas")
                    if raw is None:
                        return self._error(
                            400, "spec.replicas is required", "BadRequest")
                    want = int(raw)
                    caller_rv = ((body.get("metadata") or {})
                                 .get("resourceVersion") or None)
                    for attempt in range(5):
                        try:
                            cur = server.store.get(kind, ns or "", name)
                        except NotFound as e:
                            return self._error(404, str(e), "NotFound")
                        cur.setdefault("spec", {})["replicas"] = want
                        try:
                            cur = server._admit("UPDATE", kind, cur,
                                                "scale")
                        except AdmissionError as e:
                            return self._error(400, str(e),
                                               "AdmissionDenied")
                        commits = server._pop_commits(cur)
                        expect = caller_rv or (cur.get("metadata") or {})\
                            .get("resourceVersion")
                        try:
                            out = server.store.update(kind, cur,
                                                      expect_rv=expect)
                            server._commit(commits, True)
                            return self._send_json(200,
                                                   _scale_of(kind, out))
                        except Conflict as e:
                            server._commit(commits, False)
                            if caller_rv is not None or attempt == 4:
                                return self._error(409, str(e), "Conflict")
                        except NotFound as e:
                            server._commit(commits, False)
                            return self._error(404, str(e), "NotFound")
                if sub in (None, "status"):
                    # status fragments convert too (a v1 controller PUTs
                    # v1-shaped status; the store must only hold hub shape)
                    body = self._conv_in(kind, body)
                with server._crd_guard(kind):
                    if kind == "CustomResourceDefinition" and sub != "status":
                        err = server.validate_crd(body)
                        if err:
                            return self._error(400, err, "Invalid")
                    try:
                        body = server._admit("UPDATE", kind, body, sub,
                                             dry_run=self._dry_run())
                    except AdmissionError as e:
                        return self._error(400, str(e), "AdmissionDenied")
                    commits = server._pop_commits(body)
                    if self._dry_run():
                        server._commit(commits, False)
                        try:
                            cur = server.store.get(kind, ns or "", name)
                        except NotFound as e:
                            return self._error(404, str(e), "NotFound")
                        if sub == "status":
                            # preview the REAL status merge: stored object
                            # with only status replaced
                            cur["status"] = body.get("status", body)
                            return self._send_json(
                                200, self._conv_out(kind, cur))
                        return self._send_json(
                            200, self._conv_out(kind, body))
                    if sub == "status":
                        try:
                            cur = server.store.get(kind, ns or "", name)
                        except NotFound as e:
                            return self._error(404, str(e), "NotFound")
                        cur["status"] = body.get("status", body)
                        body = cur
                    expect = self.headers.get("If-Match") or None
                    try:
                        out = server.store.update(kind, body, expect_rv=expect,
                                                  owned=True)
                    except NotFound as e:
                        server._commit(commits, False)
                        return self._error(404, str(e), "NotFound")
                    except Conflict as e:
                        server._commit(commits, False)
                        return self._error(409, str(e), "Conflict")
                    server._commit(commits, True)
                    if kind == "CustomResourceDefinition":
                        server._on_crd_change(out, deleted=False)
                    return self._send_json(200, self._conv_out(kind, out))

            def do_PATCH(self):
                return self._shaped("patch", self._do_PATCH)

            def _do_PATCH(self):
                """Server-side apply: PATCH with
                ``Content-Type: application/apply-patch+yaml`` (or +json /
                the negotiated binary format) and ``?fieldManager=...``.
                Reference: ``apiserver/pkg/endpoints/handlers/patch.go``
                (applyPatcher) + managedfields. Conflicts -> 409 with the
                owning managers listed; ``force=true`` transfers ownership
                (kubectl --force-conflicts)."""
                from kubernetes_tpu_torch.store.apply import (ApplyConflict,
                                                        server_side_apply)
                from kubernetes_tpu_torch.store.apply import \
                    path_str as apply_path_str
                r = self._route()
                if r is None:
                    return self._error(404, "unknown path")
                plural, kind, ns, name, sub = r
                ctype = self.headers.get("Content-Type", "")
                if "apply-patch" not in ctype and MSGPACK_CT not in ctype:
                    return self._error(
                        415, "only apply-patch (server-side apply) is "
                             "supported", "UnsupportedMediaType")
                if name is None:
                    return self._error(405, "apply needs a resource name")
                if self._dry_run():
                    return self._error(
                        400, "dryRun is not supported for server-side "
                             "apply here", "BadRequest")
                if sub is not None:
                    # subresource-scoped apply (status) is not implemented;
                    # silently merging against the whole object would let a
                    # status request rewrite spec
                    return self._error(
                        405, f"apply to subresource {sub!r} unsupported")
                qs = parse_qs(urlparse(self.path).query)
                manager = qs.get("fieldManager", ["unknown"])[0]
                force = qs.get("force", ["false"])[0] in ("true", "1")
                try:
                    body = self._read_body()
                except _BadRequest as e:
                    return self._error(400, str(e), "BadRequest")
                body = self._conv_in(kind, body)
                md = body.setdefault("metadata", {})
                if md.setdefault("name", name) != name:
                    return self._error(
                        400, f"metadata.name {md['name']!r} does not match "
                             f"the request URL name {name!r}", "BadRequest")
                if ns:
                    md["namespace"] = ns
                with server._crd_guard(kind):
                    try:
                        live = server.store.get(kind, ns or "", name)
                    except NotFound:
                        live = None
                    try:
                        merged = server_side_apply(live, body, manager,
                                                   force=force)
                    except ApplyConflict as e:
                        return self._send_json(409, {
                            "kind": "Status", "status": "Failure",
                            "message": str(e), "reason": "Conflict",
                            "code": 409,
                            "details": {"causes": [
                                {"field": apply_path_str(p),
                                 "message": f"conflict with {m!r}"}
                                for p, m in e.conflicts]}})
                    if kind == "CustomResourceDefinition":
                        err = server.validate_crd(merged)
                        if err:
                            return self._error(400, err, "Invalid")
                    verb = "UPDATE" if live is not None else "CREATE"
                    try:
                        merged = server._admit(verb, kind, merged)
                    except AdmissionError as e:
                        return self._error(400, str(e), "AdmissionDenied")
                    commits = server._pop_commits(merged)
                    try:
                        if live is None:
                            out = server.store.create(kind, merged,
                                                      owned=True)
                            code = 201
                        else:
                            out = server.store.update(
                                kind, merged, owned=True,
                                expect_rv=live["metadata"]
                                ["resourceVersion"])
                            code = 200
                    except (AlreadyExists, Conflict) as e:
                        server._commit(commits, False)
                        return self._error(409, str(e), "Conflict")
                    except NotFound as e:
                        # deleted between the live read and the write
                        server._commit(commits, False)
                        return self._error(409, str(e), "Conflict")
                    except Exception:
                        server._commit(commits, False)
                        raise
                    server._commit(commits, True)
                    if kind == "CustomResourceDefinition":
                        server._on_crd_change(out, deleted=False)
                    return self._send_json(code, self._conv_out(kind, out))

            def do_DELETE(self):
                return self._shaped("delete", self._do_DELETE)

            def _do_DELETE(self):
                r = self._route()
                if r is None:
                    return self._error(404, "unknown path")
                plural, kind, ns, name, _ = r
                if name is None:
                    return self._error(405, "collection delete unsupported")
                if self._dry_run():
                    # delete preview: the object that WOULD be deleted
                    try:
                        cur = server.store.get(kind, ns or "", name)
                    except NotFound as e:
                        return self._error(404, str(e), "NotFound")
                    return self._send_json(200, self._conv_out(kind, cur))
                # DeleteOptions.propagationPolicy (query param or body):
                # Foreground/Orphan stamp the matching GC finalizer BEFORE
                # the delete, so the object terminates and the garbage
                # collector finishes the job (delete dependents first /
                # strip ownerReferences) exactly like
                # registry.Store.Delete + gc_admission upstream
                qs = parse_qs(urlparse(self.path).query)
                policy = qs.get("propagationPolicy", [""])[0]
                if not policy:
                    try:
                        body = self._read_body()
                        policy = (body or {}).get("propagationPolicy", "")
                    except Exception:  # ktpu-lint: disable=KTL002 -- malformed delete-options body: default propagation policy applies
                        policy = ""
                fin = {"Foreground": "foregroundDeletion",
                       "Orphan": "orphan"}.get(policy)
                with server._crd_guard(kind):
                    if fin is not None:
                        try:
                            cur = server.store.get(kind, ns or "", name)
                            fins = (cur.get("metadata") or {})                                 .get("finalizers") or []
                            if fin not in fins:
                                cur.setdefault("metadata", {})[
                                    "finalizers"] = list(fins) + [fin]
                                server.store.update(kind, cur)
                        except NotFound as e:
                            return self._error(404, str(e), "NotFound")
                        except Conflict:
                            pass  # racing writer; delete still proceeds
                    try:
                        out = server.store.delete(kind, ns or "", name)
                    except NotFound as e:
                        return self._error(404, str(e), "NotFound")
                    if kind == "CustomResourceDefinition":
                        server._on_crd_change(out, deleted=True)
                    return self._send_json(200, self._conv_out(kind, out))

        return Handler


SCALABLE_KINDS = {"Deployment", "ReplicaSet", "StatefulSet",
                  "ReplicationController"}


def _scale_of(kind: str, obj: dict) -> dict:
    """autoscaling/v1 Scale wire shape for a workload object
    (``pkg/registry/apps/deployment/storage`` ScaleREST.Get analog)."""
    md = obj.get("metadata") or {}
    spec = obj.get("spec") or {}
    sel = spec.get("selector") or {}
    parts = []
    if isinstance(sel, dict):
        labels = sel.get("matchLabels")
        if labels is None and "matchExpressions" not in sel:
            labels = {k: v for k, v in sel.items()
                      if not isinstance(v, (list, dict))}
        for k, v in (labels or {}).items():
            parts.append(f"{k}={v}")
        for e in sel.get("matchExpressions") or []:
            op = (e.get("operator") or "").lower()
            vals = ",".join(e.get("values") or [])
            key = e.get("key", "")
            if op == "in":
                parts.append(f"{key} in ({vals})")
            elif op == "notin":
                parts.append(f"{key} notin ({vals})")
            elif op == "exists":
                parts.append(key)
            elif op == "doesnotexist":
                parts.append(f"!{key}")
    sel_str = ",".join(parts)
    return {
        "kind": "Scale", "apiVersion": "autoscaling/v1",
        "metadata": {"name": md.get("name", ""),
                     "namespace": md.get("namespace", ""),
                     "resourceVersion": md.get("resourceVersion", "")},
        "spec": {"replicas": int(spec.get("replicas", 1) or 0)},
        "status": {"replicas": int((obj.get("status") or {})
                                   .get("replicas", 0) or 0),
                   "selector": sel_str},
    }


def _field_label_selector(qs) -> Optional[Callable[[dict], bool]]:
    """labelSelector=k=v,k2=v2 and fieldSelector=spec.nodeName=x supported."""
    return compile_list_selector(qs.get("labelSelector", [None])[0],
                                 qs.get("fieldSelector", [None])[0])


def serve(conn, data_dir: Optional[str] = None, *,
          tokens: Optional[dict] = None, anonymous: bool = True,
          audit_keep: int = 4096, flow_control: bool = False,
          admission: bool = False) -> None:
    """Server-process entry: an ``APIServer`` (in memory, or durable under
    ``data_dir``) until told to stop, with the planes a cluster turns on
    (``cli/cluster.py`` LocalCluster): ``tokens`` (token -> (user, groups))
    turns on authentication (``anonymous``: a request without a token is
    the anonymous user, else 401), the bootstrap RBAC policy and an audit
    log keeping ``audit_keep`` events; ``flow_control`` API Priority and
    Fairness; ``admission`` the default admission chain. Sends the bound
    port on ``conn``; then the message ``"report"`` is answered with
    ``server_report``, and any other message stops it. Start it with
    ``multiprocessing.get_context("spawn").Process(target=serve,
    args=(child_conn,), kwargs=...)``: a parent holding a CUDA context must
    not fork."""
    server = APIServer(data_dir=data_dir)
    if tokens is not None:
        from kubernetes_tpu_torch.store.auth import (AuditLog,
                                                     TokenAuthenticator)
        server.enable_auth(
            authenticator=TokenAuthenticator(
                {t: (user, tuple(groups))
                 for t, (user, groups) in tokens.items()},
                allow_anonymous=anonymous, secret_source=server.store),
            audit=AuditLog(keep=audit_keep))
    if flow_control:
        server.enable_flow_control()
    if admission:
        server.enable_admission()
    server.start()
    conn.send(server.port)
    try:
        while conn.recv() == "report":
            conn.send(server_report(server))
    except EOFError:
        pass  # the parent went away: stop all the same
    server.stop()


def server_report(server: "APIServer") -> dict:
    """What the planes of ``server`` saw: its audit events, its flow
    controller's stats and its dispatches by level and flow (each None when
    that plane is off)."""
    flow = server.flow
    return {"audit": (None if server.audit is None
                      else list(server.audit.events)),
            "flow": None if flow is None else flow.stats(),
            "dispatched": None if flow is None else flow.dispatched_by_flow(),
            "rejected": None if flow is None else flow.rejected_total}
