"""The port's object store, clientset and HTTP apiserver against the JAX
package's, on the CPU.

One seeded sequence of operations runs through a client: create and bulk
create, update (and a stale one), status update, binding (single, repeated
and bulk), delete, list with label, field and namespace selectors, a watch
from a mid-sequence resourceVersion, bulk node heartbeats, bulk lease
renewals, bulk pod statuses, and ``TooOld`` once the replay window has
moved past an old resourceVersion. Its record — every returned object,
resourceVersion, error code and watched event, creation and deletion
timestamps masked — must equal the record of the JAX package's
``DirectClient`` over its ``ObjectStore``, whatever the transport:

- the port's ``DirectClient`` over the port's ``ObjectStore``;
- the port's ``HTTPClient`` against the port's ``APIServer`` (port 0, in a
  thread), JSON and msgpack wires;
- the JAX package's ``HTTPClient`` against the port's ``APIServer`` (and the
  port's ``HTTPClient`` against the JAX package's ``APIServer``).

The apiserver seeds four system namespaces on start; the direct stores get
the same four first, so the resourceVersions line up.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from kubernetes_tpu.client import clientset as ref_clientset
from kubernetes_tpu.store import apiserver as ref_apiserver
from kubernetes_tpu.store import store as ref_store
from kubernetes_tpu_torch.client import clientset as port_clientset
from kubernetes_tpu_torch.store import apiserver as port_apiserver
from kubernetes_tpu_torch.store import store as port_store
from kubernetes_tpu_torch.testing.wrappers import make_node, make_pod

ROOT = Path(__file__).resolve().parent.parent
SYSTEM_NAMESPACES = ("default", "kube-system", "kube-public",
                     "kube-node-lease")
# replay window for the TooOld step: small, in both store modules
WINDOW = 16
# wall-clock stamps; "time" is a managedFields entry's, to the second: the
# reference's record is taken a second run later and may cross one
MASKED = ("creationTimestamp", "deletionTimestamp", "time")


@pytest.fixture(autouse=True)
def _small_replay_window(monkeypatch):
    for mod in (ref_store, port_store):
        monkeypatch.setattr(mod, "REPLAY_WINDOW", WINDOW)


def _masked(obj):
    """A JSON-shaped value with the store's wall-clock stamps masked."""
    if isinstance(obj, dict):
        return {k: ("<ts>" if k in MASKED else _masked(v))
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_masked(v) for v in obj]
    return obj


def _fresh(obj: dict) -> dict:
    """A wrapper-built object without its process-global uid: the store
    stamps one from the resourceVersion."""
    obj["metadata"].pop("uid", None)
    return obj


def _error_code(fn) -> "int | str":
    """Run ``fn`` for its error: the ApiError code, or the TooOld name."""
    try:
        fn()
    except (ref_clientset.ApiError, port_clientset.ApiError) as e:
        return e.code
    except (ref_store.TooOld, port_store.TooOld):
        return "TooOld"
    return "no error"


def _events(w, until_rv: int, deadline_s: float = 20.0) -> list:
    out = []
    end = time.time() + deadline_s
    try:
        while time.time() < end:
            ev = w.get(timeout=0.2)
            if ev is None:
                continue
            out.append((ev.type, ev.resource_version, _masked(ev.object)))
            if ev.resource_version >= until_rv:
                break
    finally:
        w.stop()
    return out


def run_sequence(client, seed: int = 0) -> list:
    """The seeded sequence through ``client``; -> its record."""
    rng = np.random.RandomState(seed)
    rec: list = []
    names = [f"n{i}" for i in range(6)]
    nodes = [make_node(n).capacity({"cpu": str(int(rng.choice([2, 4, 8]))),
                                    "memory": "8Gi", "pods": "16"})
             .label("zone", f"z{int(rng.randint(3))}").obj().to_dict()
             for n in names]
    nodes = [_fresh(n) for n in nodes]
    rec.append(("nodes", _masked(client.nodes().create_many(nodes))))
    pods = []
    for i in range(10):
        ns = "default" if i % 3 else "team-a"
        app = str(rng.choice(["web", "db", "cache"]))
        pods.append(_fresh(make_pod(f"p{i}", ns).label("app", app)
                           .req({"cpu": "100m"}).obj().to_dict()))
    for p in pods[:4]:
        rec.append(("create", _masked(
            client.pods(p["metadata"]["namespace"]).create(p))))
    bulk = {}
    for p in pods[4:]:
        bulk.setdefault(p["metadata"]["namespace"], []).append(p)
    for ns in sorted(bulk):
        out = client.pods(ns).create_many(bulk[ns])
        rec.append(("create_many", [_masked(o["metadata"]) for o in out]))
    rec.append(("dup", _error_code(
        lambda: client.pods("default").create(pods[1]))))
    _, rv_mid = client.pods(None).list_rv()
    rec.append(("rv_mid", rv_mid))

    cur = client.pods("default").get("p1")
    stale = dict(cur, metadata=dict(cur["metadata"]))
    cur["metadata"]["labels"]["tier"] = str(rng.randint(100))
    rec.append(("update", _masked(client.pods("default").update(cur))))
    stale["metadata"]["labels"]["tier"] = "stale"
    rec.append(("stale", _error_code(
        lambda: client.pods("default").update(stale))))
    st = client.pods("default").get("p2")
    st["status"] = {"phase": "Pending",
                    "nominatedNodeName": names[int(rng.randint(6))]}
    rec.append(("status", _masked(client.pods("default").update_status(st))))

    rec.append(("bind", _masked(client.pods("default").bind("p1", "n0"))))
    rec.append(("rebind", _error_code(
        lambda: client.pods("default").bind("p1", "n1"))))
    pairs = [(p["metadata"]["namespace"], p["metadata"]["name"],
              names[int(rng.randint(6))]) for p in pods[2:8]]
    pairs.append(("default", "ghost", "n0"))
    rec.append(("bind_many", client.pods("default").bind_many(pairs)))
    rec.append(("delete", _masked(client.pods("default").delete("p4"))))
    rec.append(("get_deleted", _error_code(
        lambda: client.pods("default").get("p4"))))

    rec.append(("list_label", _masked(client.pods(None).list(
        label_selector="app=web"))))
    rec.append(("list_field", _masked(client.pods(None).list(
        field_selector="spec.nodeName=n0"))))
    rec.append(("list_ns", _masked(client.pods("team-a").list())))
    rec.append(("list_nodes_label", sorted(
        n["metadata"]["name"]
        for n in client.nodes().list(label_selector="zone=z1"))))

    rec.append(("heartbeat", client.nodes().heartbeat_many(
        [(n, {"conditions": [{"type": "Ready", "status": "True",
                              "lastHeartbeatTime": float(i)}]})
         for i, n in enumerate(names[:3])] + [("nx", {})])))
    leases = [{"kind": "Lease", "metadata": {"name": n},
               "spec": {"holderIdentity": n, "renewTime": 1.0}}
              for n in names[:4]]
    rec.append(("leases", _masked(
        client.leases("kube-node-lease").create_many(leases))))
    rec.append(("renew", client.leases("kube-node-lease").renew_many(
        [(n, 100.0 + i) for i, n in enumerate(names[:4])] + [("nx", 1.0)])))
    rec.append(("status_many", client.pods("default").update_status_many(
        [("default", "p5", {"phase": "Running"}),
         ("team-a", "p6", {"phase": "Running"}),
         ("default", "gone", {"phase": "Running"})])))
    _, rv_end = client.pods(None).list_rv()
    rec.append(("rv_end", rv_end))
    rec.append(("nodes_end", _masked(client.nodes().list())))
    rec.append(("leases_end", _masked(
        client.leases("kube-node-lease").list())))

    # a watch from the middle of the sequence replays every later event
    rec.append(("watch", _events(client.pods(None).watch(since_rv=rv_mid),
                                 until_rv=rv_end)))
    # ...and once more than WINDOW pod events followed an rv, it is gone
    for i in range(WINDOW + 2):
        client.pods("default").create(
            _fresh(make_pod(f"w{i}").obj().to_dict()))
    rec.append(("too_old", _error_code(
        lambda: client.pods(None).watch(since_rv=rv_mid))))
    return rec


def _seed_namespaces(client) -> None:
    """What an apiserver's start does to its store, for a direct client."""
    for ns in SYSTEM_NAMESPACES:
        client.resource("namespaces", None).create(
            {"kind": "Namespace", "metadata": {"name": ns},
             "status": {"phase": "Active"}})


def _direct(pkg_store, pkg_client):
    client = pkg_client.DirectClient(pkg_store.ObjectStore())
    _seed_namespaces(client)
    return run_sequence(client)


def _over_http(server_mod, client_mod, wire: str):
    server = server_mod.APIServer().start()
    try:
        return run_sequence(client_mod.HTTPClient(server.url, wire=wire))
    finally:
        server.stop()


@pytest.fixture
def reference_record(_small_replay_window):
    return _direct(ref_store, ref_clientset)


TRANSPORTS = {
    "port-direct": lambda: _direct(port_store, port_clientset),
    "port-http-json": lambda: _over_http(port_apiserver, port_clientset,
                                         "json"),
    "port-http-msgpack": lambda: _over_http(port_apiserver, port_clientset,
                                            "msgpack"),
    "ref-client-port-server": lambda: _over_http(port_apiserver,
                                                 ref_clientset, "msgpack"),
    "port-client-ref-server": lambda: _over_http(ref_apiserver,
                                                 port_clientset, "json"),
}


@pytest.mark.parametrize("transport", sorted(TRANSPORTS))
def test_sequence_matches_reference(transport, reference_record):
    got = TRANSPORTS[transport]()
    assert [step for step, _ in got] == [step for step, _ in
                                         reference_record]
    for (step, want), (_, have) in zip(reference_record, got):
        assert have == want, step


def test_reference_record_covers_every_step(reference_record):
    """The record the others are held to took every branch it names."""
    rec = dict(reference_record)
    assert rec["dup"] == 409 and rec["stale"] == 409
    assert rec["rebind"] == 409 and rec["get_deleted"] == 404
    assert rec["bind_many"][-1] is not None
    assert rec["bind_many"][:-1] == [None] * 6
    assert rec["heartbeat"] == [None, None, None, "Node nx not found"]
    assert rec["renew"][-1] is not None and rec["status_many"][-1] is not None
    assert rec["too_old"] == "TooOld"
    types = {t for t, _rv, _o in rec["watch"]}
    assert types == {"MODIFIED", "DELETED"}
    assert rec["watch"][-1][1] == rec["rv_end"]


# ---- the planes a cluster turns on -----------------------------------------

def _planes_record(apiserver, clientset, store) -> list:
    """Flow control, authentication and admission on one server: what an
    admin, a stranger and a scheduler get; then a DirectClient's apply."""
    server = apiserver.APIServer().enable_flow_control().enable_auth()
    server.authenticator.add("admin", ("root", ("system:masters",)))
    server.authenticator.add("sched", ("system:kube-scheduler", ()))
    server.enable_admission().start()
    rec = []
    try:
        admin = clientset.HTTPClient(server.url, token="admin", wire="json")
        pod = _fresh(make_pod("a").req({"cpu": "100m"}).obj().to_dict())
        rec.append(_masked(admin.pods("default").create(pod)))
        for token in (None, "nope", "sched"):
            c = clientset.HTTPClient(server.url, token=token, wire="json")
            rec.append(_error_code(lambda: c.pods("default").create(
                _fresh(make_pod("b").obj().to_dict()))))
        rec.append(sorted(server.flow.stats()))
    finally:
        server.stop()
    direct = clientset.DirectClient(store.ObjectStore())
    cms = direct.resource("configmaps", "default")
    cm = {"kind": "ConfigMap", "metadata": {"name": "c"}, "data": {"k": "1"}}
    rec.append(_masked(cms.apply(dict(cm), field_manager="one")))
    rec.append(_error_code(lambda: cms.apply(
        dict(cm, data={"k": "2"}), field_manager="two")))
    return rec


def test_planes_and_direct_apply_match_reference():
    """The planes the port refused before item 13 (APF, authentication and
    RBAC, admission) and ``DirectClient.apply`` answer as the
    reference's."""
    port = _planes_record(port_apiserver, port_clientset, port_store)
    assert port == _planes_record(ref_apiserver, ref_clientset, ref_store)
    assert port[1:4] == [403, 401, 403]  # anonymous, bad token, scheduler
    assert port[-1] == 409


def test_plain_json_patch_answers_415_as_reference():
    """PATCH is server-side apply: a plain JSON body is refused with 415
    on both packages' servers."""
    import http.client
    codes = []
    for apiserver in (port_apiserver, ref_apiserver):
        server = apiserver.APIServer().start()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                              timeout=10)
            conn.request("PATCH", "/api/v1/namespaces/default/pods/a",
                         body=b"{}",
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            codes.append((resp.status, resp.read() and None))
            conn.close()
        finally:
            server.stop()
    assert codes == [(415, None), (415, None)]


@pytest.mark.parametrize("method,path,code", [
    ("GET", "/api/v1/namespaces/default/pods/a/log", 400),
    ("POST", "/api/v1/namespaces/default/pods/a/exec", 400),
    ("GET", "/api/v1/namespaces/default/pods/a", 200),
])
def test_http_answers_for_unported_subresources(method, path, code):
    """The kubelet's pod subresources are ported: on both packages'
    servers a pod that is not bound answers ``log`` and ``exec`` with the
    reference's 400 (no kubelet to proxy to), and the pod itself with
    200."""
    import http.client
    import json
    got = []
    for apiserver, clientset in ((ref_apiserver, ref_clientset),
                                 (port_apiserver, port_clientset)):
        server = apiserver.APIServer().start()
        try:
            clientset.HTTPClient(server.url, wire="json").pods(
                "default").create(make_pod("a").obj().to_dict())
            conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                              timeout=10)
            body = b"{}" if method != "GET" else None
            conn.request(method, path, body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            payload = json.loads(resp.read())
            conn.close()
            got.append((resp.status, payload.get("reason"),
                        payload.get("message")
                        if code != 200 else payload["metadata"]["name"]))
        finally:
            server.stop()
    assert got[1] == got[0]
    assert got[1][0] == code
    if code == 200:
        assert got[1][2] == "a"


# ---- durable mode ------------------------------------------------------------

def test_durable_apiserver_restores(tmp_path):
    """``data_dir``: every write is journalled; a new server over the same
    directory serves the same objects and carries the resourceVersion on."""
    server = port_apiserver.APIServer(data_dir=str(tmp_path)).start()
    client = port_clientset.HTTPClient(server.url, wire="json")
    client.nodes().create(make_node("n0").obj().to_dict())
    client.pods("default").create(make_pod("a").obj().to_dict())
    client.pods("default").bind("a", "n0")
    before, rv = client.pods(None).list_rv()
    server.stop()
    again = port_apiserver.APIServer(data_dir=str(tmp_path)).start()
    try:
        client = port_clientset.HTTPClient(again.url, wire="json")
        after, rv2 = client.pods(None).list_rv()
        assert after == before and rv2 >= rv
        assert after[0]["spec"]["nodeName"] == "n0"
        created = client.pods("default").create(
            make_pod("b").obj().to_dict())
        assert int(created["metadata"]["resourceVersion"]) > rv2
        import urllib.request
        with urllib.request.urlopen(again.url + "/readyz", timeout=5) as r:
            assert r.status == 200
    finally:
        again.stop()


# ---- the wire without msgpack -----------------------------------------------

_NO_MSGPACK = r"""
import sys
sys.modules["msgpack"] = None
from kubernetes_tpu_torch.store.apiserver import APIServer
from kubernetes_tpu_torch.client.clientset import HTTPClient
server = APIServer().start()
client = HTTPClient(server.url, wire="msgpack")
client.pods("default").create({"metadata": {"name": "a"}, "spec": {}})
client.pods("default").bind("a", "n0")
w = client.pods("default").watch(since_rv=0)
evs = []
while len(evs) < 2:
    ev = w.get(timeout=1.0)
    if ev is not None:
        evs.append(ev.type)
w.stop()
got = client.pods("default").get("a")
server.stop()
print(got["spec"]["nodeName"], evs)
"""


def test_json_when_msgpack_is_missing():
    """The card's machine has no msgpack: the server and a client that
    asks for msgpack both speak JSON there."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _NO_MSGPACK], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "n0 ['ADDED', 'MODIFIED']"
