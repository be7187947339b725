"""The port's scheduling sidecar against the JAX package's, request for
request.

Both engines answer the same PushSnapshot / Schedule / PushDelta / Filter /
Score sequence. Assignments and rounds must be equal, Filter masks
bit-equal, and Score values within ATOL (fp32 summation order). One gRPC
round trip goes through the port's ``SidecarServer``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmarks import workloads
from kubernetes_tpu.sidecar import SidecarClient
from kubernetes_tpu.sidecar.server import _Engine as RefEngine
from kubernetes_tpu_torch.sidecar import SidecarServer
from kubernetes_tpu_torch.sidecar.server import _Engine

ATOL = 1e-4
PROFILE = {"fit_strategy": "LeastAllocated",
           "weights": {"NodeResourcesBalancedAllocation": 2.0}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cluster(seed=0, n_nodes=24, n_bound=16, n_batches=2, batch=16):
    nodes, pods = workloads.mixed_heterogeneous(
        pods=n_bound + n_batches * batch, nodes=n_nodes, seed=seed)
    bound = [p.to_dict() for p in pods[:n_bound]]
    for i, d in enumerate(bound):
        d["spec"]["nodeName"] = f"node-{i % n_nodes}"
    pending = [p.to_dict() for p in pods[n_bound:]]
    return ([n.to_dict() for n in nodes], bound,
            [pending[i * batch:(i + 1) * batch] for i in range(n_batches)])


def _bind_ops(batch, assignments):
    ops = []
    for d, node in zip(batch, assignments):
        if node:
            ops.append({"op": "upsert",
                        "pod": dict(d, spec=dict(d["spec"], nodeName=node))})
    return ops


def test_request_sequence_matches_reference():
    nodes, bound, batches = _cluster()
    ref, port = RefEngine(), _Engine(device="cpu")

    def both(method, req):
        r, p = ref_dispatch(ref, method, req), port.dispatch(method, req)
        assert "error" not in p, p
        return r, p

    assert both("PushSnapshot", {"nodes": nodes, "pods": bound,
                                 "generation": 1, "profile": PROFILE}) \
        == ({"generation": 1}, {"generation": 1})
    gen = 1
    for batch in batches:
        r, p = both("Schedule", {"pods": batch, "generation": gen})
        assert p == r
        assert sum(1 for a in p["assignments"] if a) > len(batch) // 2
        r, p = both("PushDelta", {"base_generation": gen,
                                  "generation": gen + 1,
                                  "ops": _bind_ops(batch, p["assignments"])})
        gen += 1
        assert p == r == {"generation": gen}
    probe = batches[0][:8]
    r, p = both("Filter", {"pods": probe, "generation": gen})
    assert (p["pods"], p["nodes"]) == (r["pods"], r["nodes"])
    assert p["mask"] == r["mask"]
    r, p = both("Score", {"pods": probe, "generation": gen})
    rs = np.frombuffer(r["scores"], np.float32)
    ps = np.frombuffer(p["scores"], np.float32)
    assert np.array_equal(np.isneginf(rs), np.isneginf(ps))
    np.testing.assert_allclose(ps, rs, rtol=0, atol=ATOL)
    # a stale generation is refused the same way
    assert port.dispatch("Schedule", {"pods": probe, "generation": gen - 1}) \
        == ref_dispatch(ref, "Schedule", {"pods": probe, "generation": gen - 1})


def ref_dispatch(engine, method, req):
    """The reference keeps its dispatch on the gRPC server class; call it
    unbound on a stand-in that carries only the engine."""
    from kubernetes_tpu.sidecar.server import SidecarServer as RefServer

    class _Holder:
        pass
    holder = _Holder()
    holder.engine = engine
    return RefServer._dispatch(holder, method, req)


def test_grpc_round_trip_through_port_server():
    nodes, bound, batches = _cluster(seed=1, n_batches=1, batch=8)
    server = SidecarServer(device="cpu").start()
    client = SidecarClient(server.address)
    try:
        for n in nodes:
            client.upsert_node(n)
        for p in bound:
            client.observe_binding(p)
        client.push_snapshot()
        got = client.schedule(batches[0])
    finally:
        client.close()
        server.stop()
    ref = RefEngine()
    ref.snapshot(nodes, bound, gen=1)
    want = ref.schedule(batches[0], gen=1)["assignments"]
    assert got == want
    assert any(got)


def test_engine_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _Engine()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SidecarServer()
