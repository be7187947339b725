"""The port's ``ktpu`` (``kubernetes_tpu_torch/cli/ktpu.py``), on the CPU.

- The cases of ``tests/test_cli.py``, of ``tests/test_kubectl_breadth.py``
  that need no kubelet (a pod's Running status is written as the kubelet
  would write it), and of ``tests/test_explain_e2e.py``, with the port's
  ``ktpu`` against the port's ``APIServer`` and ``SchedulerRunner``.
- Byte for byte: a script of deterministic commands (every ported command,
  the status blocks of every component, the error surface) runs with the
  reference's ``ktpu`` against the reference's ``APIServer`` and with the
  port's against the port's, on the same objects; the outputs are equal
  once ages, uids, timestamps and resourceVersions are normalized.
- ``deschedule run --dry-run -o json`` plans the same on both.
- Every refused command raises ``not_ported`` naming its ROADMAP item,
  before any call to the server.
"""

from __future__ import annotations

import io
import json
import re
import tempfile
import threading
import time

import pytest

from kubernetes_tpu.cli import ktpu as ref_ktpu
from kubernetes_tpu.store.apiserver import APIServer as RefAPIServer
from kubernetes_tpu_torch.cli import ktpu
from kubernetes_tpu_torch.cli.ktpu import main
from kubernetes_tpu_torch.client.clientset import ApiError, HTTPClient
from kubernetes_tpu_torch.config.types import SchedulerConfiguration
from kubernetes_tpu_torch.sched.runner import SchedulerRunner
from kubernetes_tpu_torch.store.apiserver import APIServer
from kubernetes_tpu_torch.testing.wrappers import make_node, make_pod
from kubernetes_tpu_torch.utils.tracing import validate_chrome_trace


@pytest.fixture()
def server():
    s = APIServer().start()
    yield s
    s.stop()


def run(server, *argv):
    out = io.StringIO()
    rc = main(["--server", server.url, "--device", "cpu", *argv], out=out)
    return rc, out.getvalue()


def wait_for(pred, timeout=20.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(interval)
    return None


# ---- tests/test_cli.py -------------------------------------------------------

def test_apply_get_describe_delete(server, tmp_path):
    manifest = tmp_path / "app.yaml"
    manifest.write_text("""
apiVersion: v1
kind: Pod
metadata: {name: cli-pod, namespace: default, labels: {app: cli}}
spec:
  containers:
  - name: c
    image: img:v1
    resources: {requests: {cpu: 250m}}
---
apiVersion: v1
kind: Service
metadata: {name: cli-svc, namespace: default}
spec:
  selector: {app: cli}
  ports: [{port: 80}]
""")
    rc, out = run(server, "apply", "-f", str(manifest))
    assert rc == 0 and "pod/cli-pod created" in out and "service/cli-svc created" in out
    rc, out = run(server, "get", "pods")
    assert rc == 0 and "cli-pod" in out and "NAME" in out
    rc, out = run(server, "get", "pod", "cli-pod", "-o", "json")
    assert rc == 0
    assert json.loads(out)["metadata"]["name"] == "cli-pod"
    rc, out = run(server, "get", "svc")
    assert "10.96." in out  # allocated clusterIP rendered
    rc, out = run(server, "describe", "pod", "cli-pod")
    assert "Name:         cli-pod" in out and "Image: img:v1" in out
    manifest.write_text(manifest.read_text().replace("img:v1", "img:v2"))
    rc, out = run(server, "apply", "-f", str(manifest))
    assert rc == 0 and "pod/cli-pod configured" in out
    rc, out = run(server, "get", "pod", "cli-pod", "-o", "json")
    assert json.loads(out)["spec"]["containers"][0]["image"] == "img:v2"
    rc, out = run(server, "delete", "pod", "cli-pod")
    assert rc == 0 and "deleted" in out
    rc, out = run(server, "get", "pods")
    assert "cli-pod" not in out


def test_scale_and_selector(server):
    client = HTTPClient(server.url)
    client.resource("deployments").create({
        "apiVersion": "apps/v1", "kind": "Deployment",
        "metadata": {"name": "web", "namespace": "default"},
        "spec": {"replicas": 2, "selector": {"matchLabels": {"app": "web"}},
                 "template": {"metadata": {"labels": {"app": "web"}},
                              "spec": {"containers": [{"name": "c"}]}}},
    })
    rc, out = run(server, "scale", "deployment", "web", "--replicas", "5")
    assert rc == 0
    assert client.resource("deployments").get("web")["spec"]["replicas"] == 5
    client.pods().create(make_pod("a").label("app", "web").obj().to_dict())
    client.pods().create(make_pod("b").label("app", "other").obj().to_dict())
    rc, out = run(server, "get", "pods", "-l", "app=web")
    assert "a" in out.split() and "b" not in out.split()


def test_cordon_drain_uncordon(server):
    client = HTTPClient(server.url)
    client.nodes().create(make_node("n1").obj().to_dict())
    client.pods().create(make_pod("on-n1").node("n1").obj().to_dict())
    ds_pod = make_pod("daemon-on-n1").node("n1").obj().to_dict()
    ds_pod["metadata"]["ownerReferences"] = [{"kind": "DaemonSet",
                                              "name": "ds", "uid": "u-ds",
                                              "controller": True}]
    client.pods().create(ds_pod)
    rc, out = run(server, "drain", "n1")
    assert rc == 0 and "pod/on-n1 evicted" in out
    assert client.nodes().get("n1")["spec"]["unschedulable"] is True
    names = [p["metadata"]["name"] for p in client.pods().list()]
    assert names == ["daemon-on-n1"]
    rc, out = run(server, "uncordon", "n1")
    assert rc == 0
    assert not client.nodes().get("n1")["spec"].get("unschedulable")


def test_error_surface(server):
    rc, out = run(server, "get", "pod", "nope")
    assert rc == 1 and "Error from server" in out
    with pytest.raises(SystemExit):
        run(server, "get", "flurble")


def test_apply_json_manifest_without_yaml(server, tmp_path, monkeypatch):
    """A JSON manifest is read without PyYAML, which the card's machine
    lacks."""
    import builtins
    real_import = builtins.__import__

    def no_yaml(name, *a, **k):
        if name == "yaml":
            raise ImportError("no PyYAML here")
        return real_import(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", no_yaml)
    pod = tmp_path / "pod.json"
    pod.write_text(json.dumps(make_pod("j0").obj().to_dict()))
    rc, out = run(server, "apply", "-f", str(pod))
    assert rc == 0 and out == "pod/j0 created\n"
    rc, out = run(server, "apply", "-f", str(pod))
    assert rc == 0 and out == "pod/j0 configured\n"
    rc, out = run(server, "delete", "-f", str(pod))
    assert out == "pod/j0 deleted\n"


# ---- tests/test_kubectl_breadth.py, without the kubelet ----------------------

@pytest.fixture()
def cluster():
    """A node and a pod bound to it, Running with a Ready condition, as a
    kubelet would report it (the kubelet is item 15)."""
    server = APIServer().start()
    client = HTTPClient(server.url)
    client.nodes().create(make_node("kn-1").capacity(
        {"cpu": "4", "memory": "8Gi", "pods": "10"}).obj().to_dict())
    pod = make_pod("app").req({"cpu": "100m"}).obj().to_dict()
    pod["spec"]["nodeName"] = "kn-1"
    client.pods("default").create(pod)
    _run_pod(client, "app")
    yield server, client
    server.stop()


def _run_pod(client, name):
    got = client.pods("default").get(name)
    got["status"] = {"phase": "Running",
                     "conditions": [{"type": "Ready", "status": "True"}]}
    client.pods("default").update_status(got)


def _mk_rs(name, dep, dep_uid, rev, image):
    return {"kind": "ReplicaSet",
            "metadata": {"name": name,
                         "annotations": {
                             "deployment.kubernetes.io/revision": str(rev)},
                         "ownerReferences": [{"kind": "Deployment",
                                              "name": dep, "uid": dep_uid,
                                              "controller": True}]},
            "spec": {"replicas": 0,
                     "template": {"spec": {"containers": [
                         {"name": "c", "image": image}]}}}}


def test_rollout_status_history_undo(cluster):
    server, client = cluster
    deps = client.resource("deployments", "default")
    dep = deps.create({
        "kind": "Deployment", "metadata": {"name": "web"},
        "spec": {"replicas": 2,
                 "template": {"spec": {"containers": [
                     {"name": "c", "image": "img:v2"}]}}},
        "status": {"updatedReplicas": 2, "availableReplicas": 2}})
    uid = dep["metadata"].get("uid", "")
    rs = client.resource("replicasets", "default")
    rs.create(_mk_rs("web-1", "web", uid, 1, "img:v1"))
    rs.create(_mk_rs("web-2", "web", uid, 2, "img:v2"))
    rc, out = run(server, "rollout", "status", "deployment/web")
    assert rc == 0 and "successfully rolled out" in out
    rc, out = run(server, "rollout", "history", "deployment/web")
    assert rc == 0 and "1\n" in out and "2\n" in out
    assert run(server, "rollout", "undo", "deployment/web")[0] == 0
    got = deps.get("web")
    assert got["spec"]["template"]["spec"]["containers"][0]["image"] \
        == "img:v1"
    assert run(server, "rollout", "restart", "deployment/web")[0] == 0
    ann = deps.get("web")["spec"]["template"]["metadata"]["annotations"]
    assert "kubectl.kubernetes.io/restartedAt" in ann


def test_top_nodes_and_pods(cluster):
    server, _ = cluster
    rc, text = run(server, "top", "nodes")
    assert rc == 0 and "kn-1" in text and "CPU(req)" in text
    rc, text = run(server, "top", "pods", "-A")
    assert rc == 0 and "app" in text


def test_label_annotate_and_api_resources(cluster):
    server, client = cluster
    assert run(server, "label", "pods", "app", "tier=web",
               "color=blue")[0] == 0
    got = client.pods("default").get("app")["metadata"]["labels"]
    assert got["tier"] == "web" and got["color"] == "blue"
    rc, out = run(server, "label", "pods", "app", "tier=db")
    assert rc == 1 and "--overwrite" in out
    assert run(server, "label", "pods", "app", "tier=db",
               "--overwrite")[0] == 0
    assert client.pods("default").get("app")["metadata"]["labels"][
        "tier"] == "db"
    assert run(server, "label", "pods", "app", "color-")[0] == 0
    assert "color" not in client.pods("default").get("app")["metadata"][
        "labels"]
    assert run(server, "annotate", "pods", "app", "note=hi")[0] == 0
    assert client.pods("default").get("app")["metadata"]["annotations"][
        "note"] == "hi"
    rc, text = run(server, "api-resources")
    assert rc == 0
    assert "pods" in text and "volumeattachments" in text
    assert "NAMESPACED" in text


def test_wait_for_condition_and_delete(cluster):
    server, client = cluster
    rc, out = run(server, "wait", "pods", "app", "--for", "phase=Running",
                  "--timeout", "10")
    assert rc == 0, out
    rc, out = run(server, "wait", "pods", "app", "--for", "condition=Ready",
                  "--timeout", "10")
    assert rc == 0 and out == "pod/app condition met\n"
    done = {}

    def waiter():
        done["rc"] = run(server, "wait", "pods", "app", "--for", "delete",
                         "--timeout", "15")[0]
    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    time.sleep(0.3)
    client.pods("default").delete("app")
    t.join(timeout=15)
    assert done.get("rc") == 0
    pod2 = make_pod("p2").obj().to_dict()
    pod2["spec"]["nodeName"] = "kn-1"
    client.pods("default").create(pod2)
    rc, out = run(server, "wait", "pods", "p2", "--for",
                  "condition=NeverHappens", "--timeout", "1")
    assert rc == 1 and "timed out" in out


def test_scale_subresource(cluster):
    server, client = cluster
    deps = client.resource("deployments", "default")
    deps.create({"kind": "Deployment", "metadata": {"name": "web"},
                 "spec": {"replicas": 2,
                          "selector": {"matchLabels": {"app": "web"}},
                          "template": {"spec": {"containers": [
                              {"name": "c", "image": "i"}]}}},
                 "status": {"replicas": 2}})
    sc = deps.get_scale("web")
    assert sc["kind"] == "Scale" and sc["spec"]["replicas"] == 2
    assert sc["status"]["selector"] == "app=web"
    assert deps.update_scale("web", 5)["spec"]["replicas"] == 5
    got = deps.get("web")
    assert got["spec"]["replicas"] == 5
    assert got["spec"]["template"]["spec"]["containers"]
    with pytest.raises(ApiError) as ei:
        deps.update_scale("web", 9, expect_rv=sc["metadata"][
            "resourceVersion"])
    assert ei.value.code == 409
    assert run(server, "scale", "deployments", "web", "--replicas",
               "3")[0] == 0
    assert deps.get("web")["spec"]["replicas"] == 3


# ---- the refused commands ----------------------------------------------------

REFUSED = [(["logs", "app"], "15"), (["exec", "app", "--", "ls"], "15"),
           (["attach", "app"], "15"), (["port-forward", "app", "8080"], "15"),
           (["certificate", "approve", "csr-1"], "14"),
           (["lint", "--json"], "17"),
           (["scenario", "describe", "builtin:smoke"], "17")]


@pytest.mark.parametrize("argv,item", REFUSED,
                         ids=[a[0] for a, _ in REFUSED])
def test_refused_command_names_its_item(argv, item):
    """Refused before any call to the server: the address listens to
    nothing."""
    with pytest.raises(NotImplementedError, match=f"item {item}$"):
        main(["--server", "http://127.0.0.1:9", *argv], out=io.StringIO())
    assert set(ktpu.REFUSED) == {a[0] for a, _ in REFUSED}


# ---- tests/test_explain_e2e.py on the port's runner -------------------------

@pytest.fixture()
def connected():
    server = APIServer().start()
    client = HTTPClient(server.url)
    runner = SchedulerRunner(client, SchedulerConfiguration(
        backoff_initial_s=0.05, backoff_max_s=0.2), device="cpu")
    runner.start()
    yield server, client, runner
    runner.stop()
    server.stop()


def test_why_trace_and_event_for_untolerated_taint(connected):
    server, client, runner = connected
    for i in range(2):
        client.nodes().create(
            make_node(f"tainted-{i}")
            .capacity({"cpu": "4", "memory": "8Gi", "pods": "10"})
            .taint("dedicated", "ml", "NoSchedule").obj().to_dict())
    pods = client.pods("default")
    pods.create(make_pod("ok").req({"cpu": "100m"})
                .toleration(key="dedicated", operator="Exists")
                .obj().to_dict())
    pods.create(make_pod("stuck").req({"cpu": "100m"}).obj().to_dict())
    assert wait_for(
        lambda: pods.get("ok")["spec"].get("nodeName")), "ok pod never bound"

    def explained():
        rc, out = run(server, "why", "stuck", "-o", "json")
        return (rc, out) if rc == 0 else None
    got = wait_for(explained)
    assert got, "ktpu why never returned an explanation"
    doc = json.loads(got[1])
    assert doc["scheduled"] is False
    assert doc["filters"] == {"TaintToleration": 2}
    assert doc["message"] == ("0/2 nodes are available: 2 node(s) had "
                              "untolerated taint.")
    rc, table = run(server, "why", "stuck")
    assert rc == 0
    assert "TaintToleration: 2 node(s)" in table
    assert "0/2 nodes are available" in table
    runner.scheduler.recorder.flush()

    def event_msg():
        for e in client.resource("events", "default").list():
            if (e.get("reason") == "FailedScheduling"
                    and (e.get("involvedObject") or {}).get("name")
                    == "stuck"):
                return e.get("message")
        return None
    assert wait_for(event_msg) == ("0/2 nodes are available: 2 node(s) had "
                                   "untolerated taint.")
    rc, out = run(server, "why", "ok")
    assert rc == 0 and "scheduled to" in out
    client.pods("team-a").create(
        make_pod("stuck2", "team-a").req({"cpu": "100m"}).obj().to_dict())

    def explained_cross_ns():
        rc, out = run(server, "-n", "team-a", "why", "stuck2", "-o", "json")
        return out if rc == 0 else None
    cross = wait_for(explained_cross_ns)
    assert cross, "cross-namespace ktpu why never resolved"
    assert json.loads(cross)["filters"] == {"TaintToleration": 2}
    runner.publish_trace()
    rc, raw = run(server, "trace", "dump")
    assert rc == 0, raw
    trace = json.loads(raw)
    assert validate_chrome_trace(trace) == []
    names = {e["name"] for e in trace["traceEvents"]}
    assert "scheduler/gang_schedule" in names or \
        "scheduler/gang_dispatch" in names
    tracks = {e["args"].get("name") for e in trace["traceEvents"]
              if e.get("ph") == "M"}
    assert "default/ok" in tracks
    stages = {e["name"] for e in trace["traceEvents"]
              if e.get("cat") == "pod"}
    assert {"informer", "queue_add", "dispatch", "bind"} <= stages
    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        rc, out = run(server, "trace", "dump", "-o", f.name)
        assert rc == 0 and "events to" in out
        assert validate_chrome_trace(json.load(open(f.name))) == []
    runner.publish_status()
    rc, st = run(server, "status")
    assert rc == 0
    assert "Explainer:" in st and "Flight rec:" in st
    assert "Pending pods:" in st and "Resident ctx:" in st
    rc, raw = run(server, "status", "-o", "json")
    st = json.loads(raw)
    assert "ctx" in st and "aotCache" in st and "audit" in st
    rc, out = run(server, "audit", "status", "-o", "json")
    assert rc == 0 and json.loads(out)["violations"] == 0


def test_e2e_histogram_observed(connected):
    from kubernetes_tpu_torch.metrics.registry import E2E_SCHEDULING
    server, client, _runner = connected
    base = E2E_SCHEDULING.count()
    client.nodes().create(make_node("n0").capacity(
        {"cpu": "4", "pods": "10"}).obj().to_dict())
    client.pods("default").create(
        make_pod("e2e-pod").req({"cpu": "100m"}).obj().to_dict())
    assert wait_for(lambda: client.pods("default")
                    .get("e2e-pod")["spec"].get("nodeName"))
    assert wait_for(lambda: E2E_SCHEDULING.count() > base), \
        "e2e scheduling histogram never observed"


# ---- byte for byte against the reference ------------------------------------

def _status_configmaps() -> dict:
    """name -> data of every status ConfigMap ``ktpu`` reads, each block
    filled."""
    status = {
        "identity": "sched-0", "batchSize": 64, "maxDrainBatches": 4,
        "pipelineDepth": 2, "pipelineInflight": 1, "fusedFold": True,
        "ctx": {"folds": 7, "patches": 0, "rebuilds": 1,
                "reasons": {"batch_shape": 1}},
        "staging": {"enabled": True, "swaps": 5, "fallbacks": 0,
                    "bytesStaged": 1234567},
        "profiles": ["default-scheduler", "packer"],
        "pending": {"active": 3, "backoff": 1, "unschedulable": 2},
        "e2e": {"count": 40, "p50Seconds": 0.012, "p99Seconds": 0.2},
        "explain": {"podsExplained": 4, "entries": 2, "skipped": 1,
                    "errors": 0},
        "flight": {"enabled": True, "pods": 40, "droppedPods": 0},
        "aotCache": {"enabled": True, "entries": 2, "bytes": 3500000,
                     "bootEntries": 2, "bootLoadMs": 12, "hits": 2,
                     "misses": 0, "errors": 0, "invalidations": 0},
        "topology": {"grid": "4x4x4", "nodes": 64, "freeCells": 60,
                     "shapes": {"2x2x1": {"origins": 12,
                                          "fragmentationPct": 3}},
                     "carves": {"carved": 2, "failed": 1,
                                "slicePreempts": 0}},
        "resilience": {"degradedIndex": 0, "breakerTrips": 0,
                       "breakerRestores": 0, "watchdogRestarts": 0,
                       "lastRelist": None, "watchRelists": 0},
        "audit": {"sweeps": 9, "intervalSeconds": 5.0, "lastSweep": None,
                  "failFast": False, "failed": False, "violations": 0,
                  "byInvariant": {}, "bundleDir": "/tmp/b", "bundles": [],
                  "parity": {"every": 16, "samples": {"drain": 3, "wave": 0},
                             "skipped": 1, "divergences": 0}}}
    trace = {"traceEvents": [
        {"name": "scheduler/gang_dispatch", "ph": "X", "ts": 0, "dur": 5,
         "pid": 1, "tid": 1, "args": {}},
        {"name": "thread_name", "ph": "M", "pid": 2, "tid": 1,
         "args": {"name": "default/p"}}]}
    explanations = {"default/stuck": {
        "mode": "tensor", "ts": "2026-01-01T00:00:00Z",
        "message": "0/2 nodes are available: 2 node(s) had untolerated "
                   "taint.", "filters": {"TaintToleration": 2},
        "feasibleNow": 0}}
    return {
        "kubernetes-tpu-scheduler-status": {"status": json.dumps(status)},
        "kubernetes-tpu-scheduler-trace": {"trace": json.dumps(trace)},
        "scheduler-explanations": {"explanations": json.dumps(explanations)},
        "kubernetes-tpu-fleet-status": {"fleet": json.dumps({
            "nodes": 100, "shards": 4,
            "heartbeat": {"itemsPerS": 10, "lastBatch": 5},
            "lease": {"itemsPerS": 9, "lastBatch": 4}})},
        "kubernetes-tpu-fleet-sched-status": {"fleetSched": json.dumps({
            "tenants": 2, "tenant": {"0": {"bound": 5, "pending": 1,
                                           "batchShare": 0.5},
                                     "1": {"bound": 4, "pending": 0,
                                           "batchShare": 0.5}}})},
        "kubernetes-tpu-apiserver-status": {"durability": json.dumps({
            "walEntriesSinceSnapshot": 12, "lastSnapshotTime": None,
            "replayMs": 3, "walEntriesReplayed": 40,
            "tornTailsDropped": 1, "ready": True})},
        "kubernetes-tpu-nodelifecycle-status": {"disruption": json.dumps({
            "mode": "PartialDisruption", "unreadyFraction": 0.6,
            "nodes": 10, "engagedCount": 1, "evictions": 0,
            "evictionsDeferred": 2, "taintsSuppressed": 3,
            "evictionsHalted": False})},
        "kubernetes-tpu-scenario-status": {"scenario": json.dumps({
            "trace": "smoke", "state": "running", "phase": "ramp",
            "eventsDispatched": 5, "eventsTotal": 9, "podsBound": 3,
            "podsResident": 4, "skewMaxMs": 2, "speed": 2.0})},
        "kubernetes-tpu-planner-status": {"status": json.dumps({
            "cycles": 3, "intervalSeconds": 5.0, "steadyCompiles": 0,
            "planners": {"autoscaler": {"hits": 2, "declines": 1}}})},
        "cluster-autoscaler-status": {
            "lastProbeTime": "2026-01-01T00:00:00Z",
            "status": json.dumps({"expander": "least-waste", "groups": {
                "pool": {"size": 2, "minSize": 1, "maxSize": 5}},
                "lastScaleUp": {"group": "pool", "nodes": ["pool-1"],
                                "at": "t"}})},
        "descheduler-status": {
            "lastProbeTime": "2026-01-01T00:00:00Z",
            "status": json.dumps({"strategies": ["LowNodeUtilization"],
                                  "gangDefrag": True,
                                  "maxEvictionsPerCycle": 5,
                                  "lastCycle": {"planned": 1, "evicted": 0,
                                                "at": "t"},
                                  "lastLoop": {"blocked": {"x": "pdb"}}})},
    }


def _seed_objects(client) -> None:
    for i in range(3):
        client.nodes().create(make_node(f"n{i}").capacity(
            {"cpu": "4", "memory": "8Gi", "pods": "10"})
            .label("zone", f"z{i % 2}").obj().to_dict())
    for i in range(4):
        p = make_pod(f"p{i}").req({"cpu": "500m", "memory": "256Mi"}) \
            .label("app", "web" if i % 2 else "db").obj().to_dict()
        p["spec"]["nodeName"] = f"n{i % 3}"
        client.pods("default").create(p)
    client.resource("deployments", "default").create({
        "kind": "Deployment", "metadata": {"name": "web"},
        "spec": {"replicas": 2, "selector": {"matchLabels": {"app": "web"}},
                 "template": {"metadata": {"labels": {"app": "web"}},
                              "spec": {"containers": [
                                  {"name": "c", "image": "img:v2"}]}}},
        "status": {"updatedReplicas": 2, "availableReplicas": 2}})
    for name, data in _status_configmaps().items():
        client.resource("configmaps", "default").create(
            {"kind": "ConfigMap", "metadata": {"name": name},
             "data": data})
    got = client.pods("default").get("p1")
    got["status"] = {"phase": "Running", "podIP": "10.0.0.7",
                     "conditions": [{"type": "Ready", "status": "True"}]}
    client.pods("default").update_status(got)


def _script(svc: str, manifest: str) -> list:
    return [
        ["get", "pods"], ["get", "pods", "-o", "wide"],
        ["get", "pods", "-l", "app=web"], ["get", "nodes"],
        ["get", "deployments"], ["get", "pod", "p1", "-o", "json"],
        ["get", "configmaps"], ["get", "pod", "nope"],
        ["describe", "pod", "p1"], ["apply", "-f", svc],
        ["apply", "-f", manifest],
        ["apply", "-f", manifest], ["get", "svc"],
        ["label", "pods", "p0", "tier=web"],
        ["label", "pods", "p0", "tier=db"],
        ["annotate", "pods", "p0", "note=hi"],
        ["scale", "deployment", "web", "--replicas", "5"],
        ["cordon", "n2"], ["get", "nodes"], ["uncordon", "n2"],
        ["top", "nodes"], ["top", "pods"], ["top", "pods", "-A"],
        ["wait", "pods", "p1", "--for", "phase=Running", "--timeout", "5"],
        ["wait", "pods", "p1", "--for", "condition=Ready", "--timeout", "5"],
        ["rollout", "status", "deployment/web"],
        ["rollout", "history", "deployment/web"],
        ["status"], ["status", "-o", "json"], ["why", "stuck"],
        ["why", "stuck", "-o", "json"], ["why", "p1"], ["why", "ghost"],
        ["trace", "dump"], ["audit", "status"],
        ["audit", "status", "-o", "json"], ["autoscale", "status"],
        ["deschedule", "status"], ["drain", "n0"], ["get", "pods"],
        ["delete", "-f", manifest], ["delete", "pod", "p3"],
        ["delete", "pod", "p3"], ["get", "pods", "-o", "json"]]


_UID = re.compile(r'("uid": "[^"]*"|UID: +\S+)')
_RV = re.compile(r'"resourceVersion": "\d+"')
_TS = re.compile(r'"creationTimestamp": [0-9.e+]+')
_AGE = re.compile(r"(?<=\s)\d+[smhd](?=\s|$)", re.M)


def _normalize(text: str) -> str:
    text = _UID.sub("UID", text)
    text = _RV.sub('"resourceVersion": "RV"', text)
    text = _TS.sub('"creationTimestamp": TS', text)
    return _AGE.sub("AGE", text)


def test_outputs_equal_the_reference_byte_for_byte(tmp_path):
    # one object a file: the reference reads JSON as YAML, which takes no
    # top-level list of documents
    svc, manifest = tmp_path / "svc.json", tmp_path / "pod.json"
    svc.write_text(json.dumps(
        {"apiVersion": "v1", "kind": "Service",
         "metadata": {"name": "web-svc", "namespace": "default"},
         "spec": {"selector": {"app": "web"}, "ports": [{"port": 80}]}}))
    manifest.write_text(json.dumps(
        {"apiVersion": "v1", "kind": "Pod",
         "metadata": {"name": "m0", "namespace": "default",
                      "labels": {"app": "m"}},
         "spec": {"containers": [{"name": "c", "image": "img:v1"}]}}))
    outs = {}
    for name, server_cls, entry in (("ref", RefAPIServer, ref_ktpu.main),
                                    ("port", APIServer, main)):
        srv = server_cls().start()
        try:
            _seed_objects(HTTPClient(srv.url))
            lines = []
            for argv in _script(str(svc), str(manifest)):
                out = io.StringIO()
                rc = entry(["--server", srv.url, *argv], out=out)
                lines.append((argv, rc, _normalize(out.getvalue())))
            outs[name] = lines
        finally:
            srv.stop()
    for (argv, rc_ref, ref), (_, rc_port, port) in zip(outs["ref"],
                                                       outs["port"]):
        assert (rc_port, port) == (rc_ref, ref), argv
    # the script reached every status block
    status = dict((tuple(a), o) for a, _, o in outs["port"])[("status",)]
    for line in ("Resident ctx:", "Staging:", "Compile cache:",
                 "Topology:", "Durability:", "Disruption:", "Fleet:",
                 "Fleet sched:", "Scenario:", "Planners:", "Degraded:"):
        assert line in status, line


def test_deschedule_dry_run_plans_as_the_reference():
    """One descheduler cycle, dry run, on the same under-utilized cluster:
    the port's plan (on the CPU) equals the reference's."""
    outs = {}
    for name, server_cls, entry in (("ref", RefAPIServer, ref_ktpu.main),
                                    ("port", APIServer, main)):
        srv = server_cls().start()
        try:
            client = HTTPClient(srv.url)
            for i in range(4):
                client.nodes().create(make_node(f"n{i}").capacity(
                    {"cpu": "4", "memory": "8Gi", "pods": "20"})
                    .obj().to_dict())
            for i in range(9):
                p = make_pod(f"p{i}").req({"cpu": "1"}).obj().to_dict()
                p["spec"]["nodeName"] = "n0" if i < 3 else (
                    "n1" if i < 6 else "n2")
                p["metadata"]["ownerReferences"] = [
                    {"kind": "ReplicaSet", "name": "rs", "uid": "u",
                     "controller": True}]
                client.pods("default").create(p)
            flags = ["--device", "cpu"] if name == "port" else []
            out = io.StringIO()
            rc = entry(["--server", srv.url, *flags, "deschedule", "run",
                        "--dry-run", "-o", "json"], out=out)
            assert rc == 0
            table = io.StringIO()
            entry(["--server", srv.url, *flags, "deschedule", "run",
                   "--dry-run"], out=table)
            outs[name] = (json.loads(out.getvalue()), table.getvalue())
        finally:
            srv.stop()
    assert outs["port"] == outs["ref"]
    assert "planned" in outs["port"][0]
