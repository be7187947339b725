"""The port's device mesh (``kubernetes_tpu_torch/parallel/mesh.py``) held
against the JAX package's, on the CPU.

Each case of ``tests/test_mesh.py`` runs on both packages from the same
encoded inputs: ``schedule_step``, one gang round, ``gang_schedule`` to
convergence and the fused ``drain_step``, on the cluster whose zones of 3
nodes straddle the shard boundaries. The JAX side runs sharded on XLA's 8
virtual CPU devices (``tests/conftest.py``); the port's side runs on a mesh
of logical ``cpu`` shards, at (1,2), (2,2), (1,4) and (2,4). Choices,
rounds, fill and the folded state are bit-equal between the port's sharded
run, the port's single-device run and the JAX run; the float scores too,
since every cross-shard reduction is exact (max, min, and float32 sums of
integer counts below 2**24). Where the JAX canary of ``tests/test_mesh.py``
finds the installed jaxlib unable to shard at a shape, the port is
compared with the JAX UNSHARDED run (the port's own check never skips).

Then the ``drain_parity_check`` workload (``benchmarks/connected.py``:
MixedHeterogeneous at 1024 nodes, P=128, B=2, rebuilt from the port's
``testing/workloads.py``), the factored domain branch across shards, and
the mesh module's own pieces.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from kubernetes_tpu.encode.snapshot import SnapshotEncoder as JaxEncoder
from kubernetes_tpu.models import gang as jgang
from kubernetes_tpu.models.schedule_step import schedule_step as jstep
from kubernetes_tpu.parallel import mesh as jmesh
from kubernetes_tpu.testing.wrappers import make_node as jnode
from kubernetes_tpu.testing.wrappers import make_pod as jpod
from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
from kubernetes_tpu_torch.models import gang
from kubernetes_tpu_torch.models.schedule_step import schedule_step
from kubernetes_tpu_torch.ops import topology
from kubernetes_tpu_torch.parallel import mesh as mesh_mod
from kubernetes_tpu_torch.testing.wrappers import make_node, make_pod

SHAPES = [(1, 2), (2, 2), (1, 4), (2, 4)]
IDS = [f"{p}x{n}" for p, n in SHAPES]


def _cluster(mk_node, mk_pod, n_nodes=16, n_pods=16):
    """tests/test_mesh.py's cluster: zones of 3 nodes, so domains cross
    the shard boundaries (shards of 4 at 16 nodes and a 4-wide axis)."""
    nodes = [mk_node(f"n{i:02d}")
             .capacity({"cpu": "8", "memory": "16Gi", "pods": "20"})
             .label("topology.kubernetes.io/zone", f"z{i // 3}")
             .label("kubernetes.io/hostname", f"n{i:02d}").obj()
             for i in range(n_nodes)]
    pods = []
    for i in range(n_pods):
        b = mk_pod(f"p{i:02d}").req({"cpu": "500m", "memory": "256Mi"})
        b = b.label("app", f"g{i % 3}")
        if i % 3 == 0:
            b = b.spread(1, "topology.kubernetes.io/zone", "DoNotSchedule",
                         {"app": "g0"})
        if i % 3 == 1:
            b = b.pod_anti_affinity("kubernetes.io/hostname", {"app": "g1"})
        pods.append(b.obj())
    return nodes, pods


def _both(n_nodes=16, n_pods=16):
    """(port ct, port pb, JAX ct, JAX pb, topo keys) of one cluster."""
    nodes, pods = _cluster(make_node, make_pod, n_nodes, n_pods)
    enc = SnapshotEncoder()
    ct, meta = enc.encode_cluster(nodes, [], pending_pods=pods)
    pb = enc.encode_pods(pods, meta)
    jn, jp = _cluster(jnode, jpod, n_nodes, n_pods)
    jenc = JaxEncoder()
    jct, jmeta = jenc.encode_cluster(jn, [], pending_pods=jp)
    jpb = jenc.encode_pods(jp, jmeta)
    assert tuple(meta.topo_keys) == tuple(jmeta.topo_keys)
    return ct.to("cpu"), pb.to("cpu"), jct, jpb, tuple(meta.topo_keys)


def _cpu_mesh(shape):
    """A (pods, nodes) mesh of logical shards on the CPU."""
    return mesh_mod.make_mesh(["cpu"] * (shape[0] * shape[1]),
                              pods_axis=shape[0])


@functools.lru_cache(maxsize=None)
def _jax_shards(shape) -> bool:
    """Can the installed jaxlib shard at ``shape`` (tests/test_mesh.py's
    canary)? False: the JAX side runs unsharded."""
    import test_mesh
    return test_mesh._sharded_backend_verdict(tuple(shape))[0]


def _jax_mesh(shape):
    if not _jax_shards(shape):
        return None
    return jmesh.make_mesh(jax.devices()[:shape[0] * shape[1]],
                           pods_axis=shape[0])


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_schedule_step_sharded_bit_equal(shape):
    ct, pb, jct, jpb, keys = _both()
    base = schedule_step(ct, pb, seed=3, topo_keys=keys)
    out = schedule_step(ct, pb, seed=3, topo_keys=keys,
                        mesh=_cpu_mesh(shape))
    m = _jax_mesh(shape)
    if m is None:
        ref = jstep(jct, jpb, seed=3, topo_keys=keys)
    else:
        with m:
            ref = jstep(jmesh.shard_cluster(m, jct), jmesh.shard_batch(m, jpb),
                        seed=3, topo_keys=keys)
    for f in ("choice", "assigned", "feasible", "scores"):
        _eq(getattr(base, f), getattr(out, f))
        _eq(getattr(out, f), getattr(ref, f))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_gang_round_sharded_bit_equal(shape):
    ct, pb, jct, jpb, keys = _both()
    P = int(pb.pod_valid.shape[0])
    ct_ext = gang.extend_cluster(ct, pb)

    def fresh():
        return gang.GangState(
            requested=ct.requested.clone(),
            committed=torch.zeros(P, dtype=torch.bool),
            assignment=torch.full((P,), -1, dtype=torch.int32),
            tried=torch.zeros(P, dtype=torch.bool),
            rounds=torch.zeros((), dtype=torch.int32))

    base, base_n = gang.gang_round(ct_ext, pb, fresh(), seed=1,
                                   topo_keys=keys)
    st, n = gang.gang_round(ct_ext, pb, fresh(), seed=1, topo_keys=keys,
                            mesh=_cpu_mesh(shape))
    jst0 = jgang.GangState(
        requested=jax.numpy.asarray(jct.requested),
        committed=jax.numpy.zeros(P, bool),
        assignment=jax.numpy.full(P, -1, jax.numpy.int32),
        tried=jax.numpy.zeros(P, bool),
        rounds=jax.numpy.zeros((), jax.numpy.int32))
    jct_ext = jgang.extend_cluster(jct, jpb)
    m = _jax_mesh(shape)
    if m is None:
        ref, ref_n = jgang.gang_round(jct_ext, jpb, jst0, seed=1,
                                      topo_keys=keys)
    else:
        with m:
            ref, ref_n = jgang.gang_round(
                jmesh.shard_cluster(m, jct_ext), jmesh.shard_batch(m, jpb),
                jst0, seed=1, topo_keys=keys)
    assert int(base_n) == int(n) == int(ref_n)
    for f in ("assignment", "committed", "requested", "rounds"):
        _eq(getattr(base, f), getattr(st, f))
        _eq(getattr(st, f), getattr(ref, f))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_gang_schedule_full_convergence_sharded(shape):
    ct, pb, jct, jpb, keys = _both(n_nodes=16, n_pods=24)
    base_asg, base_rounds = gang.gang_schedule(ct, pb, seed=0,
                                               topo_keys=keys)
    asg, rounds = gang.gang_schedule(ct, pb, seed=0, topo_keys=keys,
                                     mesh=_cpu_mesh(shape))
    m = _jax_mesh(shape)
    if m is None:
        ref_asg, ref_rounds = jgang.gang_schedule(jct, jpb, seed=0,
                                                  topo_keys=keys)
    else:
        with m:
            ref_asg, ref_rounds = jgang.gang_schedule(
                jct, jpb, seed=0, topo_keys=keys, mesh=m)
    _eq(base_asg, asg)
    _eq(asg, ref_asg)
    assert base_rounds == rounds == ref_rounds


def _drain_inputs(nodes, pods, P, B, enc):
    ct, meta = enc.encode_cluster(nodes, [], pending_pods=pods)
    chunks = [pods[i:i + P] for i in range(0, P * B, P)]
    return ct, meta, [enc.encode_pods(c, meta, min_p=P) for c in chunks]


def _port_drain(ct, pbs, keys, mesh=None, drains=2):
    """``drains`` fused drains over the resident context (the second on
    the first's folded state) -> (assignments, rounds, fills, folded)."""
    ct_all, e0, fill = gang.build_drain_context(ct, pbs, device="cpu",
                                                mesh=mesh)
    stack = gang.stack_batches(gang.unify_batches(pbs))
    kw = dict(e0=e0, seed=0, fit_strategy="LeastAllocated", topo_keys=keys,
              weights=(), enabled_filters=(), max_rounds=64)
    outs = []
    for _ in range(drains):
        a, r, ct_all, fill = gang.drain_step(ct_all, stack, fill, **kw)
        outs.append((a, r, int(fill)))
    return outs, mesh_mod.full_view(ct_all)


def _jax_drain(jct, jpbs, keys, m, drains=1):
    """The JAX package's fused drains -> ([(assignments, rounds, fill)],
    folded ClusterTensors)."""
    pbs = jgang.unify_batches(jpbs)
    ct_all, e0 = jgang.extend_cluster_drain(jct, pbs)
    stack = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *pbs)
    kw = dict(e0=e0, seed=0, fit_strategy="LeastAllocated", topo_keys=keys,
              weights=(), enabled_filters=(), max_rounds=64)
    outs, fill = [], 0
    with (m if m is not None else _null()):
        if m is not None:
            ct_all, stack = jmesh.shard_drain(m, ct_all, stack)
        for _ in range(drains):
            a, r, ct_all, fill = jgang.drain_step(ct_all, stack, fill,
                                                  mesh=m, **kw)
            outs.append((np.asarray(a), np.asarray(r), int(fill)))
    return outs, ct_all


def _null():
    import contextlib
    return contextlib.nullcontext()


def _folded_equal(a, b):
    for x, y in zip(gang._tree_leaves(a), gang._tree_leaves(b)):
        # label_value_num holds NaN for values that are no number
        assert torch.equal(x, y) or torch.allclose(x, y, rtol=0, atol=0,
                                                   equal_nan=True)


@pytest.mark.parametrize("factored", ["auto", "on"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_drain_step_sharded_parity(shape, factored, monkeypatch):
    """The fused drain (stacked batches, fold-back, fill) on the mesh ==
    single-device == the JAX package, on both branches of the domain
    aggregation (32 nodes take the [N,N] one; ``on`` forces the factored
    one), twice over the resident context."""
    monkeypatch.setenv("KTPU_DOMAIN_FACTORED",
                       "1" if factored == "on" else "auto")
    P, B = 8, 2
    nodes, pods = _cluster(make_node, make_pod, 32, P * B)
    ct, meta, pbs = _drain_inputs(nodes, pods, P, B, SnapshotEncoder())
    keys = tuple(meta.topo_keys)
    base, base_ct = _port_drain(ct, pbs, keys)
    out, out_ct = _port_drain(ct, pbs, keys, mesh=_cpu_mesh(shape))
    for (a0, r0, f0), (a1, r1, f1) in zip(base, out):
        _eq(a0, a1)
        _eq(r0, r1)
        assert f0 == f1 > 0
    _folded_equal(base_ct, out_ct)
    jn, jp = _cluster(jnode, jpod, 32, P * B)
    jct, _jmeta, jpbs = _drain_inputs(jn, jp, P, B, JaxEncoder())
    ref, jct_out = _jax_drain(jct, jpbs, keys, _jax_mesh(shape), drains=2)
    for (a1, r1, f1), (a, r, fill) in zip(out, ref):
        _eq(a1, a)
        _eq(r1, r)
        assert f1 == fill
    _eq(out_ct.requested, jct_out.requested)
    _eq(out_ct.epod_node, jct_out.epod_node)
    _eq(out_ct.epod_valid, jct_out.epod_valid)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_drain_parity_check_workload(shape):
    """``drain_parity_check``'s workload (MixedHeterogeneous at 1024 nodes,
    P=128, B=2): the sharded drain's placements and fill equal the
    single-device drain's and the JAX package's unsharded drain's."""
    from kubernetes_tpu_torch.testing.workloads import mixed_heterogeneous
    P, B = 128, 2
    nodes, pods = mixed_heterogeneous(pods=P * B, nodes=1024)
    ct, meta, pbs = _drain_inputs(nodes, pods, P, B, SnapshotEncoder())
    keys = tuple(meta.topo_keys)
    base, base_ct = _port_drain(ct, pbs, keys, drains=1)
    out, out_ct = _port_drain(ct, pbs, keys, mesh=_cpu_mesh(shape),
                              drains=1)
    _eq(base[0][0], out[0][0])
    _eq(base[0][1], out[0][1])
    assert base[0][2] == out[0][2] > 0
    _folded_equal(base_ct, out_ct)
    jct, _jm, jpbs = _jax_reference_workload(P, B)
    ref, _ct = _jax_drain(jct, jpbs, keys, None)
    _eq(out[0][0], ref[0][0])
    assert out[0][2] == ref[0][2]


def _jax_reference_workload(P, B):
    from benchmarks.workloads import mixed_heterogeneous
    nodes, pods = mixed_heterogeneous(pods=P * B, nodes=1024)
    return _drain_inputs(nodes, pods, P, B, JaxEncoder())


# ---- the mesh module's own pieces -------------------------------------------

def test_cluster_shardings_split_node_fields():
    ct, _pb, _jct, _jpb, _keys = _both()
    m = _cpu_mesh((1, 4))
    sh = mesh_mod.cluster_shardings(m, ct)
    split = {f for f in mesh_mod.PORT_NODE_DIM
             if getattr(sh, f) == mesh_mod.Sharding("nodes", 0)}
    assert split == mesh_mod.PORT_NODE_DIM
    assert mesh_mod.NODE_DIM <= mesh_mod.PORT_NODE_DIM
    assert sh.epod_node == mesh_mod.Sharding()
    assert sh.ea_sel.key == mesh_mod.Sharding()
    # an axis that does not divide N replicates
    odd = mesh_mod.make_mesh(["cpu"] * 3)
    assert mesh_mod.cluster_shardings(odd, ct).allocatable \
        == mesh_mod.Sharding()
    s = mesh_mod.shard_cluster(m, ct)
    assert [p.allocatable.shape[0] for p in s.pieces] == \
        [ct.allocatable.shape[0] // 4] * 4
    _folded_equal(ct, s.gather())
    with pytest.raises(AttributeError):
        s.requested


def test_batch_and_stack_shardings_split_the_pod_axis():
    _ct, pb, _jct, _jpb, _keys = _both()
    m = _cpu_mesh((2, 4))
    assert mesh_mod.batch_shardings(m, pb).pod_labels \
        == mesh_mod.Sharding("pods", 0)
    stack = gang.stack_batches([pb, pb])
    assert mesh_mod.stack_shardings(m, stack).requests \
        == mesh_mod.Sharding("pods", 1)
    odd = mesh_mod.make_mesh(["cpu"] * 3, pods_axis=3)
    assert mesh_mod.stack_shardings(odd, stack).requests \
        == mesh_mod.replicated(odd)
    assert not mesh_mod.Layout(odd, 16, int(pb.pod_valid.shape[0])).pod_split
    staged = mesh_mod.presplit_stack(m, stack)
    assert list(staged) == [torch.device("cpu")]


def test_non_dividing_axis_replicates_and_stays_equal():
    ct, pb, _jct, _jpb, keys = _both()
    base = schedule_step(ct, pb, seed=5, topo_keys=keys)
    out = schedule_step(ct, pb, seed=5, topo_keys=keys,
                        mesh=mesh_mod.make_mesh(["cpu"] * 3))
    _eq(base.choice, out.choice)
    _eq(base.scores, out.scores)


def test_mesh_from_shape_counts_real_devices():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="needs 2 devices"):
        mesh_mod.mesh_from_shape((1, 2), devices=["cpu"])
    if n < 2:
        with pytest.raises(ValueError):
            mesh_mod.mesh_from_shape((1, 2))
    m = mesh_mod.mesh_from_shape((2, 2), devices=["cpu"] * 5)
    assert m.shape == {"pods": 2, "nodes": 2} and m.size == 4
    assert mesh_mod.make_mesh(["cpu"] * 6, pods_axis=4).shape \
        == {"pods": 3, "nodes": 2}
    assert m.describe()["deviceIds"] == ["cpu"] * 4


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_argmin_ties_resolve_to_the_first_global_node(shape):
    """Tied keys across shards: the combined (key, global index) gives
    torch.argmin's first occurrence, and the choice is a global id."""
    g = torch.Generator().manual_seed(7)
    key = torch.randint(0, 4, (8, 16), generator=g)
    want = torch.argmin(key, dim=-1)
    m = _cpu_mesh(shape)
    layout = mesh_mod.Layout(m, 16, 8)

    def body():
        local = mesh_mod.node_slice(mesh_mod.pod_rows(key), 1)
        return mesh_mod.gather_pods(mesh_mod.argmin_nodes(local))

    for got in mesh_mod.run(layout, body, [()] * m.size):
        _eq(want, got)


def test_count_pn_per_shard_counts_only_its_nodes():
    """On a shard, the count takes the existing pods' node ids remapped to
    its local rows: a pod on another shard's node counts nowhere there,
    and the shards' counts joined are the whole-axis count."""
    nodes, pods = _cluster(make_node, make_pod, 16, 8)
    enc = SnapshotEncoder()
    bound = []
    for i, p in enumerate(pods):
        p = make_pod(f"b{i}").label("app", f"g{i % 3}").node(
            f"n{(5 * i) % 16:02d}").obj()
        bound.append(p)
    ct, meta = enc.encode_cluster(nodes, bound, pending_pods=pods)
    pb = enc.encode_pods(pods, meta)
    ct, pb = ct.to("cpu"), pb.to("cpu")
    full = topology._count_pn(ct, pb.sc_sel, pb.pod_ns)
    m = _cpu_mesh((1, 4))
    s = mesh_mod.shard_cluster(m, ct)
    layout = mesh_mod.Layout(m, s.layout.N, 0)
    parts = mesh_mod.run(layout, lambda piece: topology._count_pn(
        piece, pb.sc_sel, pb.pod_ns), [(p,) for p in s.pieces])
    assert float(full.sum()) > 0
    _eq(torch.cat(parts, dim=2), full)


def test_shard_error_reaches_the_caller_and_frees_the_others():
    m = _cpu_mesh((1, 4))
    layout = mesh_mod.Layout(m, 16, 0)

    def body(j):
        if j == 2:
            raise KeyError("shard 2")
        return mesh_mod.reduce_nodes(torch.ones(()), "sum")

    with pytest.raises(KeyError, match="shard 2"):
        mesh_mod.run(layout, body, [(j,) for j in range(4)])


def test_collectives_and_counters_hold_under_thread_stress():
    """More shards than cores, a switch interval of a microsecond: every
    rendezvous of 200 rounds returns each shard's exact sum and gather,
    and 500 launches counted by each of 16 shards add up to 8000 with 500
    a shard (a lost update of the counters would break either)."""
    import sys
    from kubernetes_tpu_torch.ops import kernels
    m = mesh_mod.make_mesh(["cpu"] * 16, pods_axis=2)
    layout = mesh_mod.Layout(m, 64, 32)

    def body(i, j):
        for r in range(200):
            x = torch.tensor([i * 8 + j + r], dtype=torch.int64)
            assert int(mesh_mod.reduce_nodes(x, "sum")) == 8 * (8 * i + r) + 28
            assert mesh_mod.gather_pods(x).tolist() == [j + r, 8 + j + r]
        for _ in range(500):
            kernels.count_launch("count_pn")
        return True

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    kernels.reset_launches()
    try:
        assert all(mesh_mod.run(layout, body, [(i, j) for i in range(2)
                                               for j in range(8)]))
        assert kernels.LAUNCHES["count_pn"] == 16 * 500
        assert sorted(kernels.SHARD_LAUNCHES.values()) == [500] * 16
    finally:
        sys.setswitchinterval(old)
        kernels.reset_launches()
