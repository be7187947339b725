"""The port's sidecar client (``kubernetes_tpu_torch/sidecar/client.py``).

- The nine cases of ``tests/test_sidecar.py`` run with the port's client
  against the port's server (on the CPU) and against the reference's
  server: the protocol is one, so each case holds on both.
- ``native/sidecar_client.c`` drives the port's server from C, as
  ``tests/test_sidecar_native.py`` drives the reference's (skipped, with
  its reason, where no C compiler is present).
"""

from __future__ import annotations

import os
import shutil
import subprocess
from collections import Counter

import pytest

from kubernetes_tpu.sidecar import SidecarServer as RefServer
from kubernetes_tpu_torch.sidecar import SidecarClient, SidecarServer, proto
from kubernetes_tpu_torch.testing.wrappers import make_node, make_pod

NATIVE_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native", "sidecar_client.c")


@pytest.fixture(params=["port", "ref"], ids=["port_server", "ref_server"])
def sidecar(request):
    server = (SidecarServer(device="cpu") if request.param == "port"
              else RefServer()).start()
    client = SidecarClient(server.address)
    yield server, client
    client.close()
    server.stop()


def _seed(client, n_nodes=4):
    for i in range(n_nodes):
        client.upsert_node(make_node(f"n{i}").capacity(
            {"cpu": "4", "memory": "8Gi", "pods": "16"}).obj().to_dict())


def test_schedule_roundtrip(sidecar):
    _, client = sidecar
    _seed(client)
    client.push_snapshot()
    pods = [make_pod(f"p{i}").req({"cpu": "1"}).obj().to_dict()
            for i in range(6)]
    assigned = client.schedule(pods)
    assert len(assigned) == 6
    assert all(a.startswith("n") for a in assigned)


def test_filter_and_score_shapes(sidecar):
    _, client = sidecar
    _seed(client, n_nodes=3)
    client.upsert_node(make_node("n2").capacity(
        {"cpu": "4", "memory": "8Gi", "pods": "16"})
        .taint("dedicated", "gpu", "NoSchedule").obj().to_dict())
    client.push_snapshot()
    pods = [make_pod("a").req({"cpu": "1"}).obj().to_dict()]
    mask = client.filter(pods)
    assert mask.shape == (1, 3)
    assert mask[0].sum() == 2  # n2 excluded
    assert client.score(pods).shape == (1, 3)


def test_stale_reject_then_delta_push_then_reschedule(sidecar):
    _, client = sidecar
    for name in ("ta", "tb"):
        client.upsert_node(make_node(name).capacity(
            {"cpu": "2", "memory": "4Gi", "pods": "8"}).obj().to_dict())
    client.push_snapshot()
    gen0 = client.generation
    [first] = client.schedule(
        [make_pod("filler").req({"cpu": "2"}).obj().to_dict()])
    assert first in ("ta", "tb")
    assert client.stale_retries == 0
    client.observe_binding(
        make_pod("filler").req({"cpu": "2"}).node(first).obj().to_dict())
    assert client.generation == gen0 + 1
    [second] = client.schedule(
        [make_pod("next").req({"cpu": "2"}).obj().to_dict()])
    assert client.stale_retries == 1
    assert second == ("tb" if first == "ta" else "ta")


def test_journal_overflow_falls_back_to_full_push(sidecar):
    _, client = sidecar
    client._journal_limit = 4
    _seed(client, n_nodes=2)
    client.push_snapshot()
    for i in range(8):
        client.observe_binding(
            make_pod(f"b{i}").req({"cpu": "1"}).node("n0").obj().to_dict())
    assert client._journal == [] or len(client._journal) <= 4
    out = client.schedule([make_pod("x").req({"cpu": "1"}).obj().to_dict()])
    assert out[0] in ("n0", "n1")


def test_server_rejects_unknown_generation_delta(sidecar):
    _, client = sidecar
    _seed(client, n_nodes=1)
    client.push_snapshot()
    out = client._call["PushDelta"]({
        "base_generation": 999, "generation": 1000, "ops": []})
    assert out.get("stale") is True
    assert out["server_generation"] == client._pushed_gen


def test_bidi_session_stream(sidecar):
    import grpc
    server, client = sidecar
    _seed(client, n_nodes=2)
    snap = {"kind": "PushSnapshot", "seq": 1,
            "nodes": list(client._nodes.values()), "pods": [],
            "generation": client.generation}
    sched = {"kind": "Schedule", "seq": 2,
             "pods": [make_pod("s").req({"cpu": "1"}).obj().to_dict()],
             "generation": client.generation}
    chan = grpc.insecure_channel(server.address)
    call = chan.stream_stream(
        proto.method_path(proto.STREAM_METHOD),
        request_serializer=proto.pack, response_deserializer=proto.unpack)
    replies = list(call(iter([snap, sched])))
    chan.close()
    assert [r["seq"] for r in replies] == [1, 2]
    assert replies[0]["generation"] == client.generation
    assert replies[1]["assignments"][0] in ("n0", "n1")


def test_schedule_matches_oracle(sidecar):
    from kubernetes_tpu_torch.api.types import Node, Pod
    from kubernetes_tpu_torch.sched.oracle import OracleScheduler
    _, client = sidecar
    _seed(client, n_nodes=3)
    client.push_snapshot()
    pods = [make_pod(f"p{i}").req({"cpu": "2"}).obj() for i in range(6)]
    assigned = client.schedule([p.to_dict() for p in pods])
    nodes = [Node.from_dict(d) for d in client._nodes.values()]
    placed = OracleScheduler(nodes, []).schedule_all(
        [Pod.from_dict(p.to_dict()) for p in pods])
    oracle_names = [nodes[i].metadata.name if i is not None else ""
                    for i in placed]
    assert Counter(assigned) == Counter(oracle_names)
    assert all(a for a in assigned)


def test_delete_then_readd_survives_delta_push(sidecar):
    _, client = sidecar
    client.upsert_node(make_node("one").capacity(
        {"cpu": "2", "memory": "4Gi", "pods": "8"}).obj().to_dict())
    client.push_snapshot()
    bound = make_pod("x").req({"cpu": "2"}).node("one").obj().to_dict()
    client.observe_binding(bound)
    client.observe_delete("default/x")
    client.observe_binding(bound)
    assert client.schedule(
        [make_pod("y").req({"cpu": "2"}).obj().to_dict()]) == [""]
    assert client.stale_retries >= 1


def test_unknown_resource_widens_encoding(sidecar):
    _, client = sidecar
    client.upsert_node(make_node("plain").capacity(
        {"cpu": "4", "memory": "8Gi", "pods": "16"}).obj().to_dict())
    client.push_snapshot()
    assert client.schedule(
        [make_pod("warm").req({"cpu": "1"}).obj().to_dict()])[0] == "plain"
    fpga = make_pod("fpga").req({"cpu": "1"}).obj().to_dict()
    fpga["spec"]["containers"][0]["resources"]["requests"][
        "example.com/fpga"] = "1"
    assert client.schedule([fpga]) == [""]


@pytest.fixture(scope="module")
def client_bin(tmp_path_factory):
    cc = shutil.which("gcc") or shutil.which("cc")
    if cc is None:
        pytest.skip("no C compiler")
    out = str(tmp_path_factory.mktemp("native") / "sidecar_client")
    subprocess.run([cc, "-O2", "-Wall", "-std=c11", "-o", out, NATIVE_SRC,
                    "-ldl"], check=True, capture_output=True)
    return out


def test_native_client_against_the_port_server(client_bin):
    """PushSnapshot -> Schedule (100x100) -> PushDelta bind -> STALE
    rejection -> second wave -> ordered node/pod deletes, all from C,
    against the port's server."""
    srv = SidecarServer(device="cpu").start()
    try:
        p = subprocess.run([client_bin, srv.address, "100", "100"],
                           capture_output=True, text=True, timeout=180)
        assert p.returncode == 0, (p.stdout, p.stderr)
        assert "ALL CHECKS PASSED" in p.stdout
        assert "STALE (server at 2)" in p.stdout
        assert "100/100 pods placed" in p.stdout
    finally:
        srv.stop()
