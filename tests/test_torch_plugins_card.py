"""Out-of-tree tensor plugins inside the captured gang rounds, on the card.

This file imports no JAX, so the card's machine runs it
(``python -m pytest --noconftest -m gpu tests/test_torch_plugins_card.py``).
Every test needs the card and skips without one:

- with the stripe filter and the cpu-packing score
  (``kubernetes_tpu_torch/testing/plugins.py``), ``gang_schedule``,
  ``gang_drain`` and two consecutive ``drain_step``s are bit-equal
  captured, eager on the card and on the CPU, and every placement passes
  the filter;
- a plugin that reads the host (``.item()``) cannot be captured: the
  capture raises ``GraphError``, which stops the runner for good with no
  binding and no oracle placement; and the process's later captures still
  work (the failed capture's recording into the graph pool is ended).
"""

from __future__ import annotations

import copy
import time

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.client import clientset
from kubernetes_tpu_torch.config import features, types as config
from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
from kubernetes_tpu_torch.models import gang, graphs
from kubernetes_tpu_torch.sched import framework, runner as port_runner
from kubernetes_tpu_torch.store import store
from kubernetes_tpu_torch.testing import plugins
from kubernetes_tpu_torch.testing.workloads import relational_mix

MODES = (("captured", "cuda", True), ("eager", "cuda", False),
         ("cpu", "cpu", True))
MODULUS = 5


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


def _allowed(assignments, n_nodes) -> bool:
    a = np.asarray(assignments).reshape(-1)
    return bool(np.all(plugins.stripe_allows(n_nodes, MODULUS)[a[a >= 0]]))


@pytest.mark.gpu
def test_gang_schedule_and_drain_with_plugins_captured_equal_eager_and_cpu():
    _card()
    ct, pbs, meta = _encode(batches=3)
    pair = plugins.smoke_plugins(MODULUS)
    got = {}
    for mode, dev, capture in MODES:
        one = gang.gang_schedule(ct.to(dev), pbs[0].to(dev),
                                 topo_keys=meta.topo_keys, plugins=pair,
                                 capture=capture)
        drain = gang.gang_drain(ct, pbs, topo_keys=meta.topo_keys,
                                device=dev, plugins=pair, capture=capture)
        got[mode] = [np.asarray(one[0]), np.asarray(one[1])] + list(drain)
    for mode in ("eager", "cpu"):
        assert _equal(got["captured"], got[mode]), mode
    n = int(ct.node_valid.shape[0])
    assert _allowed(got["captured"][0], n) and _allowed(got["captured"][2], n)
    assert (got["captured"][2] >= 0).any()


@pytest.mark.gpu
def test_drain_steps_with_plugins_captured_equal_eager_and_cpu():
    """The second drain_step replays the graphs the first captured, with
    the plugins in them."""
    _card()
    ct, pbs, meta = _encode()
    stack = gang.stack_batches(gang.unify_batches(pbs))
    pair = plugins.smoke_plugins(MODULUS)
    runs = {}
    for mode, dev, capture in MODES:
        ctx, e0, fill = gang.build_drain_context(ct, pbs, nom_bucket=8,
                                                 device=dev)
        steps = []
        for i in range(2):
            c0 = graphs.CAPTURES
            a, r, ctx, fill = gang.drain_step(
                ctx, stack, fill, e0=e0, topo_keys=meta.topo_keys,
                plugins=pair, capture=capture)
            steps.append([_host(a), _host(r), np.asarray(int(fill)),
                          _host(ctx)])
            if mode == "captured" and i == 1:
                assert graphs.CAPTURES == c0, "the second drain recaptured"
        runs[mode] = steps
    for mode in ("eager", "cpu"):
        assert _equal(runs["captured"], runs[mode]), mode
    assert _allowed(runs["captured"][0][0], int(ct.node_valid.shape[0]))


def _reads_the_host():
    def filter_fn(ct, pb, topo_keys):
        n = ct.node_valid.shape[0]
        keep = int(ct.node_valid.sum().item()) % 7  # a host read
        allow = torch.arange(n, device=ct.node_valid.device) != keep
        return allow[None, :].expand(pb.pod_valid.shape[0], n)
    return framework.TensorPlugin(name="ReadsTheHost", filter_fn=filter_fn)


def _wait(cond, timeout=60.0, what="condition"):
    end = time.time() + timeout
    while not cond():
        if time.time() > end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


@pytest.mark.gpu
@pytest.mark.parametrize("max_drain_batches", [1, 2], ids=["group", "drain"])
def test_plugin_that_reads_the_host_stops_the_runner(monkeypatch,
                                                     max_drain_batches):
    """The plugin runs eagerly once (the capture's warm-up), then its
    ``.item()`` fails the capture: a ``GraphError``, fatal, so the loop
    stops, nothing binds and the oracle is never called."""
    _card()
    nodes, bound, pending, ns = relational_mix(pods=32, nodes=12, bound=4,
                                               seed=2)
    client = clientset.DirectClient(store.ObjectStore())
    for name, labels in sorted(ns.items()):
        client.resource("namespaces", None).create(
            {"kind": "Namespace", "metadata": {"name": name,
                                               "labels": labels}})
    client.nodes().create_many([n.to_dict() for n in nodes])
    for pods in (bound, pending):
        by_ns: dict = {}
        for p in pods:
            by_ns.setdefault(p.metadata.namespace, []).append(
                copy.deepcopy(p.to_dict()))
        for name in sorted(by_ns):
            client.pods(name).create_many(by_ns[name])
    gate = features.FeatureGate()
    gate.set_from_map({"PreemptionSimulation": False})
    cfg = config.SchedulerConfiguration(
        explainer_enabled=False, parity_sample_every=0, batch_size=8,
        max_drain_batches=max_drain_batches, backoff_initial_s=3600.0,
        backoff_max_s=3600.0, audit_interval_s=3600.0,
        watchdog_interval_s=0.05, breaker_threshold=1)
    registry = framework.Registry().register(_reads_the_host())
    run = port_runner.SchedulerRunner(client, cfg, registry=registry,
                                      feature_gate=gate, device="cuda")
    oracle = []
    monkeypatch.setattr(run.scheduler, "_schedule_oracle",
                        lambda *a: oracle.append(a) or 0)

    def bindings():
        return {p["metadata"]["name"]: p["spec"].get("nodeName", "")
                for p in client.pods(None).list()}
    before = bindings()
    run.start()
    try:
        _wait(lambda: run.loop_error is not None, what="the loop error")
        time.sleep(0.5)
        assert isinstance(run.loop_error, graphs.GraphError)
        assert not run._loop_thread.is_alive()
        assert run._watchdog.restarts == 0
        assert not oracle
        assert run.scheduler.breaker.trips == 0
        assert bindings() == before
    finally:
        with pytest.raises(graphs.GraphError):
            run.stop()
    # the card stays usable, and so does the graph pool: a new capture (a
    # plugin tuple made here is a static no graph of the process has in
    # its key, so this call captures whatever ran before it)
    torch.cuda.synchronize()
    assert float(torch.ones(4, device="cuda").sum()) == 4.0
    ct, pbs, meta = _encode(batches=1)
    pair = plugins.smoke_plugins(MODULUS)
    c0 = graphs.CAPTURES
    got = gang.gang_schedule(ct.to("cuda"), pbs[0].to("cuda"),
                             topo_keys=meta.topo_keys, seed=5, plugins=pair)
    want = gang.gang_schedule(ct.to("cpu"), pbs[0].to("cpu"),
                              topo_keys=meta.topo_keys, seed=5, plugins=pair)
    assert graphs.CAPTURES > c0
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
