"""The port's snapshot encoder against the JAX package's, field for field.

Both encoders read the same pod and node dicts; every field of the encoded
``ClusterTensors`` and ``PodBatch`` must be equal in dtype, shape and value,
and the metadata the pipeline reads (node names, resource axis, topology
keys) must be equal too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from benchmarks import workloads
from kubernetes_tpu.api.types import Node as RefNode, Pod as RefPod
from kubernetes_tpu.encode.snapshot import SnapshotEncoder as RefEncoder
from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
from kubernetes_tpu_torch.testing.workloads import relational_mix

BASELINE_WORKLOADS = ("SchedulingBasic", "NodeResourcesFit",
                      "SchedulingPodAntiAffinity",
                      "PreferredTopologySpreading", "MixedHeterogeneous")


def _flat(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _flat(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return np.asarray(x)


def _assert_same(ref, port, path="") -> None:
    if isinstance(ref, dict):
        assert set(ref) == set(port), path
        for k in ref:
            _assert_same(ref[k], port[k], f"{path}.{k}")
        return
    assert ref.dtype == port.dtype, (path, ref.dtype, port.dtype)
    assert ref.shape == port.shape, (path, ref.shape, port.shape)
    assert np.array_equal(ref, port, equal_nan=ref.dtype.kind == "f"), path


def _bind(pod_dicts, n_nodes):
    return [dict(d, spec=dict(d["spec"], nodeName=f"node-{i % n_nodes}"))
            for i, d in enumerate(pod_dicts)]


def _encode_both(node_dicts, bound_dicts, batches, ns_labels=None):
    """Encode the cluster and then each pending batch in turn through one
    encoder per package; assert every encoding equal."""
    ref, port = RefEncoder(), SnapshotEncoder()
    if ns_labels:
        ref.set_namespaces(ns_labels)
        port.set_namespaces(ns_labels)
    pending = [d for b in batches for d in b]
    rct, rmeta = ref.encode_cluster(
        [RefNode.from_dict(d) for d in node_dicts],
        [RefPod.from_dict(d) for d in bound_dicts],
        pending_pods=[RefPod.from_dict(d) for d in pending])
    ct, meta = port.encode_cluster(
        [Node.from_dict(d) for d in node_dicts],
        [Pod.from_dict(d) for d in bound_dicts],
        pending_pods=[Pod.from_dict(d) for d in pending])
    _assert_same(_flat(rct), _flat(ct), "ct")
    assert meta.node_names == rmeta.node_names
    assert meta.resources == rmeta.resources
    for batch in batches:
        rpods = [RefPod.from_dict(d) for d in batch]
        pods = [Pod.from_dict(d) for d in batch]
        # the informer-time precompile path for half the batch
        for rp, p in zip(rpods[::2], pods[::2]):
            assert ref.precompile_pod(rp) == port.precompile_pod(p)
        rpb = ref.encode_pods(rpods, rmeta)
        pb = port.encode_pods(pods, meta)
        _assert_same(_flat(rpb), _flat(pb), "pb")
        assert meta.topo_keys == rmeta.topo_keys
        assert meta.pod_keys == rmeta.pod_keys
    assert port.pod_cache_hits == ref.pod_cache_hits
    assert port.pod_rows_stacked == ref.pod_rows_stacked


@pytest.mark.parametrize("workload", BASELINE_WORKLOADS)
def test_encode_matches_reference(workload):
    nodes, pods = workloads.WORKLOADS[workload](pods=40, nodes=24, seed=3)
    node_dicts = [n.to_dict() for n in nodes]
    pod_dicts = [p.to_dict() for p in pods]
    _encode_both(node_dicts, _bind(pod_dicts[:16], len(nodes)),
                 [pod_dicts[16:28], pod_dicts[28:]])


def test_encode_relational_mix_matches_reference():
    """Anti-affinity symmetry terms, explicit and selected namespaces,
    ports, images, taints and numeric expressions."""
    nodes, bound, pending, ns_labels = relational_mix(pods=40, nodes=20, seed=5)
    pend = [p.to_dict() for p in pending]
    _encode_both([n.to_dict() for n in nodes], [p.to_dict() for p in bound],
                 [pend[:24], pend[24:]], ns_labels)
