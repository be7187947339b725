"""The gang rounds as captured CUDA graphs, on the card.

This file imports no JAX, so the card's machine runs it
(``python -m pytest --noconftest -m gpu tests/test_torch_graph_card.py``).
Every test needs the card and skips without one:

- ``gang_schedule``, ``gang_drain`` and two consecutive ``drain_step``s
  give bit-equal results captured, eager on the card and on the CPU
  (assignments, rounds, ``requested``, the folded context);
- a second captured call captures nothing and replays, and
  ``kernels.LAUNCHES["count_pn"]`` counts the launches of each replay:
  as many as the eager loop of the same chunk launches;
- the host reads the progress flag at most once per chunk of rounds;
- a warm ladder's graphs serve the scheduler's first drains (no capture
  after ``warm_drain``);
- a capture that fails raises ``GraphError``, which is fatal;
- serial rounds (TPUBatchScheduling off) capture too.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
from kubernetes_tpu_torch.models import gang, graphs
from kubernetes_tpu_torch.ops import kernels
from kubernetes_tpu_torch.testing.workloads import relational_mix

DEVICES = ("captured", "eager", "cpu")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _encode(P=16, batches=2, seed=3):
    nodes, bound, pending, ns = relational_mix(pods=P * batches * 2,
                                               nodes=24, bound=12, seed=seed)
    enc = SnapshotEncoder()
    enc.set_namespaces(ns)
    pending = pending[:P * batches]
    ct, meta = enc.encode_cluster(nodes, bound, pending_pods=pending,
                                  pending_slots=True)
    pbs = [enc.encode_pods(pending[b * P:(b + 1) * P], meta, min_p=P)
           for b in range(batches)]
    return ct, pbs, meta


def _where(mode):
    return ("cpu", True) if mode == "cpu" else ("cuda", mode == "captured")


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy().copy()
    if hasattr(x, "__dataclass_fields__"):
        return [_host(leaf) for leaf in gang._tree_leaves(x)]
    return np.asarray(x)


def _equal(a, b):
    if isinstance(a, list):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and np.array_equal(
        a, b, equal_nan=a.dtype.kind == "f")


@pytest.mark.gpu
def test_gang_schedule_captured_equals_eager_and_cpu(monkeypatch):
    _card()
    monkeypatch.setattr(gang, "GRAPH_CHUNK", 4)
    monkeypatch.setattr(gang, "CPU_CHUNK", 4)
    ct, pbs, meta = _encode()
    out = {}
    for mode in DEVICES:
        dev, capture = _where(mode)
        kernels.reset_launches()
        out[mode] = gang.gang_schedule(ct.to(dev), pbs[0].to(dev),
                                       topo_keys=meta.topo_keys,
                                       capture=capture)
        torch.cuda.synchronize()
        out[mode + "_launches"] = kernels.LAUNCHES["count_pn"]
    for mode in ("eager", "cpu"):
        assert np.array_equal(out["captured"][0], out[mode][0]), mode
        assert out["captured"][1] == out[mode][1], mode
    assert (out["captured"][0] >= 0).any() and out["eager_launches"] > 0
    # a second call of the same shapes: no capture, replays counted
    c0, r0, h0 = graphs.CAPTURES, graphs.REPLAYS, graphs.HOST_READS
    kernels.reset_launches()
    again = gang.gang_schedule(ct.to("cuda"), pbs[0].to("cuda"),
                               topo_keys=meta.topo_keys)
    assert np.array_equal(again[0], out["captured"][0])
    assert graphs.CAPTURES == c0 and graphs.REPLAYS > r0
    assert kernels.LAUNCHES["count_pn"] == out["eager_launches"]
    assert graphs.HOST_READS - h0 <= -(-again[1] // 4)


@pytest.mark.gpu
def test_serial_rounds_capture_on_the_card():
    """Serial rounds (``serial=True``, TPUBatchScheduling off: one pod
    attempted a round) capture and replay: the round's target mask reads
    no device scalar back to the host, which a capture refuses. Captured
    = eager = CPU."""
    _card()
    ct, pbs, meta = _encode()
    out = {}
    for mode in DEVICES:
        dev, capture = _where(mode)
        out[mode] = gang.gang_schedule(ct.to(dev), pbs[0].to(dev),
                                       topo_keys=meta.topo_keys, serial=True,
                                       capture=capture)
        torch.cuda.synchronize()
    for mode in ("eager", "cpu"):
        assert np.array_equal(out["captured"][0], out[mode][0]), mode
        assert out["captured"][1] == out[mode][1], mode
    assert (out["captured"][0] >= 0).any()


@pytest.mark.gpu
def test_gang_drain_captured_equals_eager_and_cpu():
    _card()
    ct, pbs, meta = _encode(batches=3)
    got = {}
    for mode in DEVICES:
        dev, capture = _where(mode)
        got[mode] = gang.gang_drain(ct, pbs, topo_keys=meta.topo_keys,
                                    device=dev, capture=capture)
    for mode in ("eager", "cpu"):
        for name, a, b in zip(("assignments", "rounds", "requested"),
                              got["captured"], got[mode]):
            assert _equal(a, b), (mode, name)
    assert (got["captured"][0] >= 0).any()


@pytest.mark.gpu
def test_drain_steps_captured_equal_eager_and_cpu(monkeypatch):
    """Two consecutive drain_steps over one resident context: the second
    replays the graphs the first captured (its context is the same
    storage), and every result is bit-equal across the three paths."""
    _card()
    monkeypatch.setattr(gang, "GRAPH_CHUNK", 3)
    monkeypatch.setattr(gang, "CPU_CHUNK", 3)
    ct, pbs, meta = _encode()
    stack = gang.stack_batches(gang.unify_batches(pbs))
    runs = {}
    for mode in DEVICES:
        dev, capture = _where(mode)
        ctx, e0, fill = gang.build_drain_context(ct, pbs, nom_bucket=8,
                                                 device=dev)
        steps = []
        for i in range(2):
            c0 = graphs.CAPTURES
            a, r, ctx, fill = gang.drain_step(
                ctx, stack, fill, e0=e0, topo_keys=meta.topo_keys,
                capture=capture)
            # a record, not a view of the live context (.numpy() of a CPU
            # tensor shares its memory)
            steps.append((_host(a), _host(r), int(fill), _host(ctx)))
            if mode == "captured" and i == 1:
                assert graphs.CAPTURES == c0, "the second drain recaptured"
        runs[mode] = steps
    names = [".".join(path) for path in _leaf_paths(ctx)]
    for mode in ("eager", "cpu"):
        for i, (want, have) in enumerate(zip(runs["captured"], runs[mode])):
            for name, a, b in zip(("assignments", "rounds", "fill"),
                                  want, have):
                assert (a == b) if name == "fill" else _equal(a, b), \
                    (mode, i, name)
            differ = [(n, int((x != y).sum()) if x.shape == y.shape else
                       (x.shape, y.shape))
                      for n, x, y in zip(names, want[3], have[3])
                      if not _equal(x, y)]
            assert not differ, (mode, i, differ)


def _leaf_paths(tree, prefix=()):
    if hasattr(tree, "__dataclass_fields__"):
        return [p for f in tree.__dataclass_fields__
                for p in _leaf_paths(getattr(tree, f), prefix + (f,))]
    return [prefix]


@pytest.mark.gpu
def test_warm_ladder_serves_the_first_drains():
    """warm_drain captures the rounds on the context it warms up; the
    kept context takes over its storage, so the scheduler's first drains
    replay and capture nothing."""
    _card()
    import chip_smoke
    from kubernetes_tpu_torch.api.types import Node, Pod
    nodes, bound, pending, ns = relational_mix(pods=96, nodes=16, bound=12,
                                               seed=1)
    sched, log = chip_smoke.make_scheduler(
        chip_smoke.sched_config(batch_size=8, max_drain_batches=2),
        [Node.from_dict(n.to_dict()) for n in nodes],
        [Pod.from_dict(p.to_dict()) for p in bound], ns, device="cuda")
    try:
        pods = [Pod.from_dict(p.to_dict()) for p in pending[:32]
                if not p.host_ports() and not p.spec.volumes]
        assert sched.warm_drain(pods[:16], slot_headroom=256)
        assert sched.warm_stats["captures"] >= 1
        c0 = graphs.CAPTURES
        for p in pods:
            sched.queue.add(p)
        for _ in range(4):
            sched.run_once(wait=0.01)
        sched._resolve_pending()
        assert log and graphs.CAPTURES == c0
    finally:
        sched.close()


@pytest.mark.gpu
def test_capture_failure_raises_graph_error():
    """A body that fails while it is captured raises GraphError, which
    is_fatal calls fatal (nothing runs it eagerly instead), and no graph
    is kept for its key. The body fails in Python, after its eager
    warm-up, so the capture itself ends cleanly and the card stays
    usable for the tests after this one."""
    _card()
    from kubernetes_tpu_torch.sched.faults import is_fatal
    x = torch.ones(4, device="cuda")
    calls = []

    def body(state):
        calls.append(torch.cuda.is_current_stream_capturing())
        if calls[-1]:
            raise RuntimeError("a body that cannot be captured")
        return [state[0] + 1]

    key = ("capture_failure_probe",)
    with graphs.LOCK, pytest.raises(graphs.GraphError) as err:
        graphs.replay(key, body, [x])
    assert calls == [False, True] and is_fatal(err.value)
    assert key not in graphs._GRAPHS
    torch.cuda.synchronize()
    assert float((x + 1).sum()) == 8.0
