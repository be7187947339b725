"""The port's gang rounds against the JAX package's ``gang_schedule``.

Same encoding in, and the assignments and the number of rounds must be
equal, in batched and in serial mode, over three workload seeds (the
tie-break seed stays 0, as the sidecar runs it, so the reference compiles
once per shape). Any difference in
an assignment is a fault of the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from benchmarks import workloads
from kubernetes_tpu.api.types import Node as RefNode, Pod as RefPod
from kubernetes_tpu.encode.snapshot import SnapshotEncoder as RefEncoder
from kubernetes_tpu.models import gang as ref_gang
from kubernetes_tpu_torch.encode.convert import from_reference
from kubernetes_tpu_torch.models import gang
from kubernetes_tpu_torch.testing.workloads import relational_mix


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is faster, and the test workers
    share the machine's cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _flat(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _flat(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return np.asarray(x)


def _mixed(seed):
    nodes, pods = workloads.mixed_heterogeneous(pods=56, nodes=24, seed=seed)
    bound = [p.to_dict() for p in pods[:16]]
    for i, d in enumerate(bound):
        d["spec"]["nodeName"] = f"node-{i % len(nodes)}"
    return ([n.to_dict() for n in nodes], bound,
            [p.to_dict() for p in pods[16:]], None)


def _relational(seed):
    nodes, bound, pending, ns_labels = relational_mix(pods=40, nodes=24,
                                                      seed=seed)
    return ([n.to_dict() for n in nodes], [p.to_dict() for p in bound],
            [p.to_dict() for p in pending], ns_labels)


def _encode(node_dicts, bound_dicts, pending_dicts, ns_labels):
    enc = RefEncoder()
    if ns_labels:
        enc.set_namespaces(ns_labels)
    pending = [RefPod.from_dict(d) for d in pending_dicts]
    ct, meta = enc.encode_cluster([RefNode.from_dict(d) for d in node_dicts],
                                  [RefPod.from_dict(d) for d in bound_dicts],
                                  pending_pods=pending)
    return ct, enc.encode_pods(pending, meta), meta


@pytest.mark.parametrize("serial", [False, True], ids=["batched", "serial"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("workload", ["mixed", "relational"])
def test_gang_schedule_equals_reference(workload, seed, serial):
    rct, rpb, meta = _encode(*{"mixed": _mixed,
                               "relational": _relational}[workload](seed))
    ref_assign, ref_rounds = ref_gang.gang_schedule(
        rct, rpb, topo_keys=meta.topo_keys, serial=serial)
    assign, rounds = gang.gang_schedule(
        from_reference(_flat(rct), "cpu"), from_reference(_flat(rpb), "cpu"),
        topo_keys=meta.topo_keys, serial=serial)
    ref_assign = np.asarray(ref_assign)
    assert (ref_assign >= 0).sum() > 0
    assert np.array_equal(ref_assign, assign)
    assert rounds == ref_rounds


def test_gang_schedule_profile_equals_reference():
    """A profile's weights, fit strategy and filter subset reach every round."""
    rct, rpb, meta = _encode(*_relational(4))
    kw = dict(seed=4, topo_keys=meta.topo_keys, fit_strategy="MostAllocated",
              weights={"NodeResourcesFit": 3.0, "InterPodAffinity": 0.0},
              enabled_filters={"NodeResourcesFit", "TaintToleration",
                               "PodTopologySpread"})
    ref_assign, ref_rounds = ref_gang.gang_schedule(rct, rpb, **kw)
    assign, rounds = gang.gang_schedule(from_reference(_flat(rct), "cpu"),
                                        from_reference(_flat(rpb), "cpu"), **kw)
    assert np.array_equal(np.asarray(ref_assign), assign)
    assert rounds == ref_rounds


def test_segmented_capacity_accept_equals_reference():
    import jax
    ref_accept = jax.jit(ref_gang._segmented_capacity_accept,
                         static_argnames=("per_node_cap",))
    rng = np.random.default_rng(3)
    P, R = 50, 3
    choice = rng.integers(0, 6, P).astype(np.int32)
    want = rng.random(P) < 0.8
    rank = rng.permutation(P).astype(np.int32)
    requests = rng.integers(0, 5, (P, R)).astype(np.int32)
    free = rng.integers(0, 12, (P, R)).astype(np.int32)
    for cap in (None, 2):
        ref = ref_accept(choice, want, rank, requests,
                                                  free, per_node_cap=cap)
        port = gang._segmented_capacity_accept(
            *(torch.from_numpy(a) for a in (choice, want, rank, requests, free)),
            per_node_cap=cap)
        assert np.array_equal(np.asarray(ref), port.numpy())
