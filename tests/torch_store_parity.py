"""Run the JAX package's store tests on both packages, and record what each
run saw.

``load(name, pkg)`` compiles ``tests/<name>.py`` with its
``kubernetes_tpu.`` imports pointed at ``pkg`` (``"kubernetes_tpu"`` or
``"kubernetes_tpu_torch"``). The wrappers that build its pods and nodes stay
the JAX package's, so both runs start from the same dicts. The port's entry
points that run on the card unless told otherwise (``ON_CPU``) are bound to
the CPU in the compiled module's namespace, and the file's own imports of
them resolve there: a class gets ``device="cpu"``, a function its tensor
containers moved onto the CPU (the encoder hands out numpy arrays, which
the reference's functions take as they are). ``run_case`` runs one of its
test functions, with its fixtures (``tmp_path`` and ``monkeypatch`` are
pytest's), and returns its record:

- ``raised``: None, or the exception the case ended in (a failed assertion
  included), by type and message;
- ``requests``: every request its ``HTTPClient``s made on the case's own
  thread, in order: method, path and query, and the masked answer or the
  error's code and reason. Consecutive repeats of one request (a poll)
  collapse to the last;
- ``servers``: for every APIServer its fixtures built, the masked contents
  of its store, its audit events (sorted: each is logged after its response
  went out) and its flow controller's stats;
- ``raft``: the masked contents of the store of the furthest-ahead
  ``RaftNode`` the case built, up to the group's commit index (raft and
  the front door are compared by what they end with, not by their
  timing);
- ``stores``: in the controller modules (``RECONCILED``), the masked
  contents of every ``ObjectStore`` the case built for itself, in the
  order it built them. There a controller's ``stop`` first waits for its
  store to be quiet (``converged``), so a record holds the state the
  controllers converge to, not the moment the case's last assertion
  passed.

Masked: uids, wall-clock stamps, the ports of local servers and how long
a WAL replay took; in the raft and front-door modules also
resourceVersions and the system namespaces (``TIMED``), as in the cases
whose runner writes beside the case (``RV_BY_CHANCE``); in the modules
whose cases run a SchedulerRunner (``SCHEDULED``) the ConfigMaps it
publishes about itself are left out; in the controller modules
(``RECONCILED``) also
resourceVersions, generated names, the minute a CronJob's job is named
after, event names' millisecond, every ``...Time`` and ``...Timestamp``
field and key material drawn at random; there metadata's ``uid``,
``creationTimestamp`` and ``deletionTimestamp`` are dropped (whether a
controller's last write was a create or an update is chance), and every
other masked key is kept as ``<masked>``, so its presence is compared.
In ``STAMPED`` modules (the descheduler's) the ``...Time`` stamps of the
status ConfigMaps are masked too. In the case that polls a static pod's
mirror while its kubelet recreates
it (``MIRROR_STATUS_BY_CHANCE``) every Pod an answer holds is recorded
without its ``status``.
"""

from __future__ import annotations

import contextlib
import inspect
import itertools
import json
import re
import sys
import threading
import time
import types
from pathlib import Path

TESTS = Path(__file__).resolve().parent
PACKAGES = ("kubernetes_tpu", "kubernetes_tpu_torch")
# the JAX package's wrappers build every pod and node in both runs
_IMPORT = re.compile(r"\bkubernetes_tpu\.(?!testing\.wrappers\b)")
_PORT = re.compile(r"(127\.0\.0\.1|localhost):\d+")
# chance: the raft node that won the election ("node"), the watch
# streams of earlier cases that a replica has not yet torn down, and how
# long a restarted store's WAL replay took ("replayMs")
MASKED = ("uid", "creationTimestamp", "deletionTimestamp", "time", "ts",
          "replayLagMs", "maxReplayLagMs", "commitWait", "node",
          "watchers", "watchersTotal", "Port", "replayMs")

# raft and the front door start by electing a leader, and an APIServer
# seeds the system namespaces only if its node leads by then: whether they
# were committed, and so every resourceVersion after them, is chance in
# these modules' records
TIMED = ("test_frontdoor", "test_replication")
SYSTEM_NAMESPACES = ("default", "kube-system", "kube-public",
                     "kube-node-lease")
_TIMED = threading.Event()  # set while a TIMED module's case runs

# the controller modules run reconcile loops on threads of their own, whose
# interleaving decides the resourceVersions, the names the store generates
# from them (generateName + the next resourceVersion in hex) and the float
# epoch stamps of conditions, heartbeats and leases: their records mask
# those, and keep the stores that a case builds for itself. So do the
# kubelet modules: kubelets heartbeat, renew leases and write pod status
# on threads of their own, and a fleet's batchers flush in an order that
# is chance; and cluster-up, whose LocalCluster runs the manager and the
# kubelets beside its scheduler
RECONCILED = ("test_controllers", "test_controllers_breadth",
              "test_controllers_quota_ttl_agg", "test_attachdetach_nodeipam",
              "test_protection_csr", "test_certificates", "test_volumes",
              "test_kubelet", "test_kubelet_managers", "test_cri_managers",
              "test_cni_csi", "test_kubemark", "test_bulk_fanin",
              "test_kubectl_breadth", "test_connected_pipeline",
              "test_autoscaler", "test_cluster_up")
_RECONCILED = threading.Event()  # set while a RECONCILED module's case runs
# cases that poll until another thread has done its part: a planner
# (``ClusterAutoscaler.run_once``) until the runner has bound the pods, a
# read of a static pod's mirror until the kubelet recreated it (whether
# its status is written yet is chance), a scenario replay's pod lists
# until the runner has bound the trace's pods (its status ConfigMap
# carries the dispatch skew and the pods bound at each publish), a
# cluster-up case's node and pod lists until its kubelets registered and
# ran what its scheduler bound. What
# each poll reads and writes depends on how far the other thread got, so
# the record keeps the case's writes only (not a ConfigMap, which each
# poll rewrites), of a poll's writes to one path the last, and masks
# resourceVersions (the other thread's binds interleave with the writes)
POLLED = ("test_autoscaler", "test_connected_pipeline", "test_scenario",
          "test_cluster_up")
_POLLED = threading.Event()
# what a SchedulerRunner publishes about itself (status, explanations,
# trace): timings, and fields that differ by design (the port's device,
# the reference's incident traces), not what a controller case compares
PUBLISHED = ("kubernetes-tpu-scheduler-status", "scheduler-explanations",
             "kubernetes-tpu-scheduler-trace")
# modules whose cases run a SchedulerRunner beside the case's own clients
# (its stop() publishes on the case's thread): their records leave out
# the PUBLISHED ConfigMaps too
SCHEDULED = ("test_chaos", "test_disaster", "test_scenario")
_SCHEDULED = threading.Event()
# cases whose runner writes (its events, its binds) while the case writes
# over HTTP: every resourceVersion after the first interleaving is chance
RV_BY_CHANCE = {("test_disaster", "test_scheduler_survives_apiserver_restart")}
_RV_CHANCE = threading.Event()
# modules whose records carry wall-clock stamps in published status (the
# descheduler's ConfigMap): their ``_STAMP`` keys are masked, as in a
# RECONCILED module, and nothing else is
STAMPED = ("test_descheduler",)
_STAMPED = threading.Event()
_GENERATED = re.compile(r"-[0-9a-f]{5}\b")
# a CronJob's job is named after its scheduled minute since the epoch
_MINUTE = re.compile(r"-\d{8}\b")
# (so are a taint's ``timeAdded``, ``ktpu rollout restart``'s
# ``restartedAt`` annotation and the autoscaler's last scale-up ``at``)
_STAMP = re.compile(r".(Time|Timestamp|restartedAt)$|^(timeAdded|at)$")
# the keys of an object's metadata whose presence is chance in a
# controller module: whether a controller's last write was a create (the
# store stamps them) or an update with a fresh object (whose metadata it
# rebuilt) depends on the threads' interleaving; they are dropped from
# metadata, and every other masked key is kept as "<masked>", so that both
# packages must still write it
_CHANCE = ("uid", "creationTimestamp", "deletionTimestamp")
# key material a case or a controller draws at random: CSRs and
# certificates (PEM, or PEM in base64) and service-account tokens
_DRAWN = re.compile(r"LS0tLS1CRUdJT[A-Za-z0-9+/=]*|-----BEGIN [A-Z ]+-----"
                    r"[^-]*-----END [A-Z ]+-----\n?|ktpu-sa-[0-9a-f]+")
# cases whose live scheduler spreads a Deployment's replicas over
# identical nodes: which node takes which replica, and so the addresses
# the kubelets give them, follows how the loop's pops fell, which is the
# threads' timing on either package. Their records mask the node names
# and addresses in the stores and every event's name, and sort each
# kind's objects; what each object holds is still compared
PLACED_BY_CHANCE = {("test_kubelet", "test_full_cluster_deployment_to_running")}
_PLACEMENT = re.compile(r"\bw\d+\b|\b(10|192)\.\d+\.\d+\.\d+\b")
# cases that poll a static pod's mirror while the kubelet deletes and
# recreates it: the kubelet writes a recreated mirror's status on a
# thread of its own after the create, so whether a poll's last answer
# carries that status yet is chance on either package. Their records
# drop ``status`` from every Pod an answer holds; the requests, their
# order and codes, and each Pod's metadata and spec are still compared
MIRROR_STATUS_BY_CHANCE = {
    ("test_kubectl_breadth",
     "test_static_pod_survives_mirror_deletion_and_manifest_edit")}


# modules whose cases run a HollowNode kubelet beside the case: the
# kubelet's first heartbeat tick (``heartbeat_period``, 2 s after it
# started, on either package) creates the node's Lease in
# kube-node-lease, so whether a record's store holds that Lease is how
# long the case ran. On an idle host a case ends before the tick; under
# a loaded run one leg can pass it (C14: the traces case's exports of a
# worker's full tracer ring). Their records drop the kubelet's Lease;
# every other object, the Node's heartbeat included, is still compared
LEASE_BY_CHANCE = ("test_kubectl_breadth",)
_LEASE_CHANCE = threading.Event()


def _status_free(entry: tuple) -> tuple:
    """A recorded request whose answer, if a Pod, has no ``status``."""
    if entry[3] != "ok":
        return entry
    out = json.loads(entry[4])
    if isinstance(out, dict) and out.get("kind") == "Pod":
        out.pop("status", None)
    return entry[:4] + (json.dumps(out, sort_keys=True),)


def _placement_free(data: dict) -> dict:
    """A store's masked contents with ``_PLACEMENT`` and event names
    masked, each kind's objects sorted."""
    out = {}
    for kind, objs in data.items():
        objs = json.loads(_PLACEMENT.sub("<placed>", json.dumps(objs)))
        if kind == "Event":
            for ev in objs:
                ev["metadata"]["name"] = "<event>"
        out[kind] = sorted(objs, key=lambda o: json.dumps(o, sort_keys=True))
    return out


# a controller's stop first waits for its store to be quiet this long, so
# that the record holds the state the controllers converge to; a
# controller that also works on a timer (``tick_interval``) of at most
# TICK_WAIT_S is waited out for one more tick: a sync that read an
# informer behind another's event writes its last change on the next tick
QUIET_S = 0.25
TICK_WAIT_S = 2.0

# (module, name) of the port's entry points that a reference test calls
# with no device: a class whose ``device`` None means the card, a function
# that takes tensor containers where the reference's takes numpy arrays
# (given ``device="cpu"`` where it takes a device)
ON_CPU = (("sched.runner", "SchedulerRunner"), ("ops.filters", "run_filters"),
          ("autoscaler", "ClusterAutoscaler"), ("sched.scheduler", "Scheduler"),
          ("chaos.scheduler", "SchedulerProcess"),
          ("cli.cluster", "LocalCluster"), ("models.schedule_step", "evaluate"),
          ("utils.sanity", "checked_evaluate"),
          ("descheduler", "Descheduler"), ("descheduler", "plan_evictions"),
          ("descheduler", "plan_evictions_naive"),
          ("descheduler", "plan_gang_defrag"),
          ("autoscaler.simulator", "simulate_scale_up"),
          ("autoscaler.simulator", "simulate_scale_down"))

_MODULES: dict = {}
_RECORD = threading.local()


def _on_cpu(pkg: str, src: str, namespace: dict) -> str:
    """``src`` with its imports of ``ON_CPU`` names taken out, and each
    name put into ``namespace`` bound to the CPU."""
    import importlib
    for module, name in ON_CPU:
        # one name, or a parenthesized list of them
        line = re.compile(rf"^(\s*)from {pkg}\.{re.escape(module)} import "
                          rf"(\([^)]*\)|[^\n(]*)$", re.M)

        def drop(m, name=name):
            names = m.group(2)
            rest = re.sub(rf"\b{name}\b\s*,?", "", names)
            if rest == names:
                return m.group(0)
            if not re.search(r"\w", rest):  # keep the line count
                return m.group(1) + "pass" + "\n" * names.count("\n")
            return m.group(0).replace(names, rest)

        changed = line.sub(drop, src)
        if changed == src:
            continue
        src = changed
        base = getattr(importlib.import_module(f"{pkg}.{module}"), name)
        if isinstance(base, type):
            def __init__(self, *a, _base=base, device="cpu", **kw):
                _base.__init__(self, *a, device=device, **kw)

            namespace[name] = type(name, (base,), {"__init__": __init__})
        else:
            takes_device = "device" in inspect.signature(base).parameters

            def on_cpu(*a, _fn=base, _dev=takes_device, **kw):
                if _dev:
                    kw.setdefault("device", "cpu")
                return _fn(*(x.to("cpu") if hasattr(x, "to") else x
                             for x in a), **kw)

            namespace[name] = on_cpu
    return src


def load(name: str, pkg: str) -> types.ModuleType:
    """``tests/<name>.py`` compiled against ``pkg`` (cached)."""
    key = (name, pkg)
    if key not in _MODULES:
        path = TESTS / f"{name}.py"
        src = path.read_text()
        mod = types.ModuleType(f"_parity_{name}_{pkg}")
        mod.__file__ = str(path)
        if pkg != "kubernetes_tpu":
            src = _on_cpu(pkg, _IMPORT.sub(f"{pkg}.", src), mod.__dict__)
        sys.modules[mod.__name__] = mod
        exec(compile(src, str(path), "exec"), mod.__dict__)
        _MODULES[key] = mod
    return _MODULES[key]


def cases(name: str) -> list:
    """``(case id, function name, parameters)`` for every test function of
    ``tests/<name>.py``, one for each parametrized value."""
    mod = load(name, "kubernetes_tpu")
    out = []
    for fname, fn in vars(mod).items():
        if not fname.startswith("test_") or not inspect.isfunction(fn):
            continue
        params = [{}]
        for mark in getattr(fn, "pytestmark", []):
            if mark.name != "parametrize":
                continue
            argnames, values = mark.args[0], mark.args[1]
            names = [a.strip() for a in argnames.split(",")] \
                if isinstance(argnames, str) else list(argnames)
            params = [dict(p, **dict(zip(names, v if len(names) > 1
                                         else (v,))))
                      for p in params for v in values]
        for p in params:
            cid = fname + ("" if not p else "[" + "-".join(
                str(v) for v in p.values()) + "]")
            out.append((cid, fname, p))
    return out


def mask(obj):
    """A JSON-shaped value with uids, stamps and local ports masked."""
    if isinstance(obj, dict):
        if _RECONCILED.is_set() and obj.get("kind") == "Event":
            # an event's name ends in the millisecond it was recorded
            md = obj.get("metadata") or {}
            obj = {**obj, "metadata": {**md, "name": md.get(
                "name", "").rpartition(".")[0] + ".<ms>"}}
        masked = {k for k in obj if k in MASKED or (
            _unordered() and k == "resourceVersion") or (
            (_RECONCILED.is_set() or _STAMPED.is_set())
            and _STAMP.search(k))}
        if _RECONCILED.is_set() and isinstance(obj.get("metadata"), dict):
            obj = {**obj, "metadata": {k: v for k, v in obj["metadata"].items()
                                       if k not in _CHANCE}}
        return {k: "<masked>" if k in masked else mask(v)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [mask(v) for v in obj]
    if isinstance(obj, str):
        if obj[:1] in "[{":  # JSON inside a ConfigMap value
            try:
                inner = mask(json.loads(obj))
            except ValueError:
                pass
            else:
                if isinstance(inner, list):  # in the order of masked urls
                    inner.sort(key=lambda v: json.dumps(v, sort_keys=True))
                return json.dumps(inner, sort_keys=True)
        if _RECONCILED.is_set():
            obj = _MINUTE.sub("-<minute>", _GENERATED.sub(
                "-<gen>", _DRAWN.sub("<drawn>", obj)))
        return _PORT.sub(r"\1:<port>", obj)
    return obj


@contextlib.contextmanager
def converged(pkg: str):
    """While it is open, ``Controller.stop`` first waits until its client's
    store has not moved, and its queue held nothing (queued, in a sync or
    waiting out a retry's backoff), for ``QUIET_S`` and a tick (at most 5 s
    more); ``ControllerManager.stop`` waits so once for all its
    controllers."""
    import importlib
    ctrl = importlib.import_module(f"{pkg}.controllers.base").Controller
    mgr = importlib.import_module(f"{pkg}.controllers.manager"
                                  ).ControllerManager
    origs = (ctrl.stop, mgr.stop)

    def busy(q) -> int:
        return len(q) + len(q._processing) + len(getattr(q, "_delayed", ()))

    def quiet(client, ctrls) -> None:
        store = getattr(client, "store", None)
        if store is None:
            return
        hold = QUIET_S + max([c.tick_interval for c in ctrls
                              if 0 < (c.tick_interval or 0) <= TICK_WAIT_S]
                             or [0.0])
        end = time.monotonic() + 5.0 + hold
        last, since = None, time.monotonic()
        while time.monotonic() < end:
            now = (store.snapshot_rv(), sum(busy(c.queue) for c in ctrls))
            if now != last or now[1]:
                last, since = now, time.monotonic()
            elif time.monotonic() - since >= hold:
                return
            time.sleep(0.05)

    def stop_controller(self):
        if not self._stop.is_set() and not getattr(self, "_parity_quiet",
                                                   False):
            quiet(self.client, [self])
        return origs[0](self)

    def stop_manager(self):
        if not self._stop.is_set():
            quiet(self.client, self.controllers)
        for c in self.controllers:
            c._parity_quiet = True
        return origs[1](self)

    ctrl.stop, mgr.stop = stop_controller, stop_manager
    try:
        yield
    finally:
        ctrl.stop, mgr.stop = origs


def _unordered() -> bool:
    """True while a case runs whose resourceVersions are chance."""
    return (_TIMED.is_set() or _RECONCILED.is_set() or _POLLED.is_set()
            or _RV_CHANCE.is_set())


def _path(url: str) -> str:
    return _PORT.sub(r"\1:<port>", url)


def _record(entry) -> None:
    rec = getattr(_RECORD, "requests", None)
    if rec is None or not _compared(entry):
        return
    # a poll: keep the last answer (in a POLLED module the last write of a
    # poll to one path, whatever each poll wrote)
    n = 2 if _POLLED.is_set() else 3
    if rec and rec[-1][:n] == entry[:n]:
        rec[-1] = entry
    else:
        rec.append(entry)


def _compared(entry) -> bool:
    """False for a request that a RECONCILED or SCHEDULED module's record
    leaves out: one about a scheduler's published ConfigMaps, and in a
    POLLED module a read or a write of a ConfigMap (the planner's
    status)."""
    if not (_RECONCILED.is_set() or _SCHEDULED.is_set()):
        return True
    if any(n in entry[1] or f'"name": "{n}"' in entry[2] for n in PUBLISHED):
        return False
    return not (_POLLED.is_set() and (entry[0] == "GET"
                                      or "/configmaps" in entry[1]))


@contextlib.contextmanager
def recording(pkg: str, before_get=None):
    """Record the requests of ``pkg``'s HTTPClients made on the case's own
    thread; ``before_get()`` runs before each GET."""
    import importlib
    cs = importlib.import_module(f"{pkg}.client.clientset")
    store = importlib.import_module(f"{pkg}.store.store")
    orig = cs.HTTPClient._req

    def _req(self, method, url, body=None, headers=None):
        key = (method, _path(url), json.dumps(mask(body), sort_keys=True,
                                              default=str))
        if method == "GET" and before_get is not None:
            before_get()
        try:
            out = orig(self, method, url, body, headers)
        except cs.ApiError as e:
            _record(key + ("error", e.code, e.reason))
            raise
        except store.TooOld:
            _record(key + ("TooOld",))
            raise
        _record(key + ("ok", json.dumps(mask(out), sort_keys=True,
                                        default=str)))
        return out

    cs.HTTPClient._req = _req
    _RECORD.requests = []
    try:
        yield _RECORD.requests
    finally:
        cs.HTTPClient._req = orig
        _RECORD.requests = None


def _settle(count, quiet_s: float = 0.3, limit_s: float = 5.0) -> None:
    """Wait until ``count()`` has not moved for ``quiet_s`` (at most
    ``limit_s``): an audit event is logged after its response went out."""
    end = time.monotonic() + limit_s
    last, since = count(), time.monotonic()
    while time.monotonic() < end:
        time.sleep(0.05)
        now = count()
        if now != last:
            last, since = now, time.monotonic()
        elif time.monotonic() - since >= quiet_s:
            return


def _server_state(server) -> dict:
    """The masked store contents, audit events and flow stats of an
    APIServer (or of the core of an aggregator)."""
    server = getattr(server, "core", server)
    audit = getattr(server, "audit", None)
    if audit is not None:
        _settle(lambda: len(audit.events))
    blob = server.store.snapshot_blob()
    data = {kind: sorted((mask(o) for o in objs if _kept(o)),
                         key=lambda o: json.dumps(o, sort_keys=True))
            for kind, objs in blob["data"].items()}
    data = {kind: objs for kind, objs in data.items() if objs}
    flow = getattr(server, "flow", None)
    return {"rv": "<masked>" if _unordered() else blob["rv"],
            "data": {k: v for k, v in data.items() if v},
            "audit": None if audit is None else sorted(
                json.dumps(mask(e), sort_keys=True) for e in audit.events),
            "flow": None if flow is None else {
                "stats": flow.stats(), "rejected": flow.rejected_total}}


def _raft_state(nodes) -> "dict | None":
    """The furthest-ahead node's store, cut at the group's commit index: a
    write a leader applied but no quorum took (a minority leader's, whose
    step-down may come first or second) is chance, not an outcome."""
    live = [nd for nd in nodes if nd is not None]
    if not live:
        return None
    best = max(live, key=lambda nd: nd.store.snapshot_rv())
    committed = max(int(nd.commit_rv) for nd in live)
    blob = best.store.snapshot_blob()
    data = {kind: sorted(json.dumps(mask(o), sort_keys=True) for o in objs
                         if int(o["metadata"]["resourceVersion"])
                         <= committed and _kept(o))
            for kind, objs in blob["data"].items()}
    return {k: v for k, v in data.items() if v}


def _kept(obj: dict) -> bool:
    """False for a system namespace in a TIMED module's record, and for a
    scheduler's published ConfigMaps in a RECONCILED or SCHEDULED one."""
    name = obj.get("metadata", {}).get("name")
    if (_LEASE_CHANCE.is_set() and obj.get("kind") == "Lease"
            and obj.get("metadata", {}).get("namespace")
            == "kube-node-lease"):
        return False
    if ((_RECONCILED.is_set() or _SCHEDULED.is_set())
            and obj.get("kind") == "ConfigMap"):
        return name not in PUBLISHED
    return not (_TIMED.is_set() and obj.get("kind") == "Namespace"
                and name in SYSTEM_NAMESPACES)


def _tracked(mod) -> list:
    """Point the module's RaftNode and FrontDoorCluster at subclasses that
    keep what they build in the returned list (emptied for each case); a
    cluster keeps its raft nodes when it stops."""
    built = mod.__dict__.setdefault("_parity_built", [])
    built.clear()
    for cls_name in ("RaftNode", "FrontDoorCluster"):
        base = mod.__dict__.get(cls_name)
        if base is None or "_parity_built" in vars(base):
            continue

        def __init__(self, *a, _base=base, **kw):
            _base.__init__(self, *a, **kw)
            built.append(self)

        def stop(self, _base=base):
            self._parity_nodes = list(getattr(self, "nodes", ()))
            return _base.stop(self)

        mod.__dict__[cls_name] = type(cls_name, (base,), {
            "__init__": __init__, "stop": stop, "_parity_built": True})
    return built


def _built_stores(mod) -> list:
    """Point the module's ObjectStore at a subclass that keeps the stores
    it builds in the returned list (emptied for each case)."""
    stores = mod.__dict__.setdefault("_parity_stores", [])
    stores.clear()
    base = mod.__dict__.get("ObjectStore")
    if base is not None and "_parity_built" not in vars(base):
        def __init__(self, *a, _base=base, **kw):
            _base.__init__(self, *a, **kw)
            stores.append(self)

        mod.__dict__["ObjectStore"] = type("ObjectStore", (base,), {
            "__init__": __init__, "_parity_built": True})
    return stores


class Fixtures:
    """The fixtures of one loaded test module, set up on demand. Module
    fixtures are kept in ``shared`` (the caller closes them) and
    function fixtures are closed by ``close``."""

    def __init__(self, mod, tmp_path, shared: dict):
        self.mod = mod
        self.tmp_path = tmp_path
        self.shared = shared
        self._teardown: list = []
        self.values: dict = {}

    def get(self, name: str):
        if name == "tmp_path":
            return self.tmp_path
        if name == "monkeypatch" and name not in self.values:
            self.values[name] = _monkeypatch(self._teardown)
        if name in self.shared:
            return self.shared[name][0]
        if name in self.values:
            return self.values[name]
        fixture = self.mod.__dict__[name]
        fn = fixture._get_wrapped_function()
        args = [self.get(a) for a in inspect.signature(fn).parameters]
        out = fn(*args)
        value = next(out) if inspect.isgenerator(out) else out
        if fixture._fixture_function_marker.scope == "module":
            self.shared[name] = (value, out)
        else:
            self.values[name] = value
            if inspect.isgenerator(out):
                self._teardown.append(out)
        return value

    def close(self) -> None:
        while self._teardown:
            gen = self._teardown.pop()
            with contextlib.suppress(StopIteration):
                next(gen)


def _monkeypatch(teardown: list):
    """pytest's ``monkeypatch`` for one case: undone at ``close``."""
    import pytest

    mp = pytest.MonkeyPatch()

    def undo():
        yield
        mp.undo()

    gen = undo()
    next(gen)
    teardown.append(gen)
    return mp


def close_shared(shared: dict) -> None:
    for _value, gen in shared.values():
        if inspect.isgenerator(gen):
            with contextlib.suppress(StopIteration):
                next(gen)
    shared.clear()


def run_case(name: str, fname: str, params: dict, pkg: str, tmp_path,
             shared: "dict | None" = None) -> dict:
    """Run one case of ``tests/<name>.py`` on ``pkg`` -> its record."""
    for flag, names in ((_TIMED, TIMED), (_RECONCILED, RECONCILED),
                        (_POLLED, POLLED), (_SCHEDULED, SCHEDULED),
                        (_STAMPED, STAMPED)):
        if name in names:
            flag.set()
        else:
            flag.clear()
    if (name, fname) in RV_BY_CHANCE:
        _RV_CHANCE.set()
    else:
        _RV_CHANCE.clear()
    if name in LEASE_BY_CHANCE:
        _LEASE_CHANCE.set()
    else:
        _LEASE_CHANCE.clear()
    mod = load(name, pkg)
    # a kubelet's host and pod IPs count from a process-global node index:
    # every case starts it at 1 on both packages, whatever kubelets earlier
    # tests of the process made
    kubelet = sys.modules.get(f"{pkg}.kubelet.kubelet")
    if kubelet is not None:
        kubelet._node_ip_counter = itertools.count(1)
    built = _tracked(mod)
    stores = _built_stores(mod) if name in RECONCILED else []
    fn = mod.__dict__[fname]
    fx = Fixtures(mod, tmp_path, {} if shared is None else shared)
    raised = None
    servers = {}

    def replayed() -> None:
        """Every raft group of the case caught up with its furthest node:
        a read a replica serves then sees every write made before it, as
        the reference's single server would (bounded staleness is the
        plane's contract, and its timing is not what is compared)."""
        groups = [[b] if not hasattr(b, "nodes") else b.nodes for b in built]
        groups += [v[0].nodes for v in fx.shared.values()
                   if hasattr(v[0], "nodes")]
        groups += [v.nodes for v in fx.values.values() if hasattr(v, "nodes")]
        end = time.monotonic() + 15.0
        for group in groups:
            live = [nd for nd in group if not nd._stop.is_set()]
            while live and time.monotonic() < end:
                rvs = {nd.store.snapshot_rv() for nd in live}
                if len(rvs) == 1:
                    break
                time.sleep(0.01)

    settled = converged(pkg) if name in RECONCILED \
        else contextlib.nullcontext()
    with settled, recording(pkg, replayed) as requests:
        try:
            kwargs = {a: (params[a] if a in params else fx.get(a))
                      for a in inspect.signature(fn).parameters}
            fn(**kwargs)
        except BaseException as e:  # the record says how the case ended
            raised = (type(e).__name__, mask(str(e)))
        finally:
            values = dict(fx.values)
            values.update({k: v[0] for k, v in fx.shared.items()})
            for k, v in values.items():
                if hasattr(v, "store") or hasattr(v, "core"):
                    servers[k] = _server_state(v)
                elif isinstance(v, tuple):  # servers, or a client and more
                    servers[k] = [_server_state(x) for x in v
                                  if hasattr(x, "store") or hasattr(x, "core")]
                elif hasattr(v, "leader_api"):
                    servers[k] = _raft_state(v.nodes)
            served = [getattr(v, "store", None) for v in values.values()]
            own = [_server_state(types.SimpleNamespace(store=st))
                   for st in stores if not any(st is x for x in served)]
            fx.close()
            nodes = [n for b in built if not hasattr(b, "nodes")
                     for n in (b,)]
            raft = _raft_state(nodes + [
                n for b in built if hasattr(b, "nodes")
                for n in (b.nodes or getattr(b, "_parity_nodes", []))])
            for nd in nodes:  # a case's own raft nodes (clusters: theirs)
                nd.stop()
    if (name, fname) in PLACED_BY_CHANCE:
        servers = {k: {**v, "data": _placement_free(v["data"])}
                   if isinstance(v, dict) and "data" in v else v
                   for k, v in servers.items()}
    requests = list(requests)
    if (name, fname) in MIRROR_STATUS_BY_CHANCE:
        requests = [_status_free(r) for r in requests]
    return {"raised": raised, "requests": requests,
            "servers": servers, "raft": raft, "stores": own}


def both(name: str, fname: str, params: dict, tmp_path, shared: dict
         ) -> tuple:
    """Run one case on the JAX package, then on the port -> (reference
    record, port record), each asserted to have passed."""
    out = []
    for pkg in PACKAGES:
        d = tmp_path / pkg
        d.mkdir()
        rec = run_case(name, fname, params, pkg, d, shared[pkg])
        assert rec["raised"] is None, (pkg, rec["raised"])
        out.append(rec)
    return tuple(out)


def shared_fixtures():
    """A module fixture's body: each package's module-scope fixtures,
    closed at the end."""
    shared = {pkg: {} for pkg in PACKAGES}
    yield shared
    for d in shared.values():
        close_shared(d)
