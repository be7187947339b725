"""The device mesh (``kubernetes_tpu_torch/parallel/mesh.py``) on the card.

This file imports no JAX, so the card's machine runs it
(``python -m pytest --noconftest -m gpu tests/test_torch_mesh_card.py``).
Every test needs the card and skips without one; whether there is one is
decided inside each test. With one card the mesh is made of logical
shards of ``cuda:0``; with more, of distinct cards:

- a sharded ``drain_step`` (twice over the resident context) equals the
  card's single-device drain and the CPU's: assignments, rounds, fill and
  the folded state, bit for bit;
- ``count_pn`` is launched on every shard (``kernels.SHARD_LAUNCHES``),
  over the shard's node slice, and its per-shard count equals the plain
  version's slice of the whole-axis count;
- the live scheduler on a mesh binds the pods where single-device does.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
from kubernetes_tpu_torch.models import gang
from kubernetes_tpu_torch.ops import kernels, topology
from kubernetes_tpu_torch.parallel import mesh as mesh_mod
from kubernetes_tpu_torch.testing.workloads import relational_mix


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _mesh(shape):
    """Distinct cards where there are enough, else logical shards of
    cuda:0."""
    k = shape[0] * shape[1]
    n = torch.cuda.device_count()
    devices = ([f"cuda:{i}" for i in range(k)] if n >= k
               else ["cuda:0"] * k)
    return mesh_mod.make_mesh(devices, pods_axis=shape[0])


def _encode(P=32, batches=2, seed=5, nodes=48):
    pods_n = P * batches * 2
    nodes, bound, pending, ns = relational_mix(pods=pods_n, nodes=nodes,
                                               bound=24, seed=seed)
    enc = SnapshotEncoder()
    enc.set_namespaces(ns)
    pending = pending[:P * batches]
    ct, meta = enc.encode_cluster(nodes, bound, pending_pods=pending)
    pbs = [enc.encode_pods(pending[b * P:(b + 1) * P], meta, min_p=P)
           for b in range(batches)]
    return ct, pbs, meta


def _drains(ct, pbs, meta, device=None, mesh=None, n=2):
    ct_all, e0, fill = gang.build_drain_context(ct, pbs, device=device,
                                                mesh=mesh)
    stack = gang.stack_batches(gang.unify_batches(pbs))
    out = []
    for _ in range(n):
        a, r, ct_all, fill = gang.drain_step(
            ct_all, stack, fill, e0=e0, topo_keys=meta.topo_keys)
        out.append((a.cpu().numpy(), r.cpu().numpy(), int(fill)))
    folded = [t.cpu().numpy() for t in
              gang._tree_leaves(mesh_mod.full_view(ct_all))]
    return out, folded


def _same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)],
                         ids=["1x2", "2x2", "1x4"])
def test_sharded_drain_equals_single_device_and_cpu(shape):
    _card()
    ct, pbs, meta = _encode()
    single, single_ct = _drains(ct, pbs, meta, device="cuda")
    cpu, cpu_ct = _drains(ct, pbs, meta, device="cpu")
    kernels.reset_launches()
    m = _mesh(shape)
    sharded, sharded_ct = _drains(ct, pbs, meta, mesh=m)
    for x, y, z in zip(single, cpu, sharded):
        _same(x[:2], y[:2])
        _same(x[:2], z[:2])
        assert x[2] == y[2] == z[2] > 0
    for a, b, c in zip(single_ct, cpu_ct, sharded_ct):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    for i in range(shape[0]):
        for j in range(shape[1]):
            assert kernels.SHARD_LAUNCHES.get(("count_pn", i, j), 0) > 0
    assert kernels.LAUNCHES["count_pn"] == sum(
        n for (name, _i, _j), n in kernels.SHARD_LAUNCHES.items()
        if name == "count_pn")


@pytest.mark.gpu
def test_count_pn_per_shard_equals_the_plain_slices():
    _card()
    ct, pbs, _meta = _encode()
    pb = pbs[0].to("cuda")
    ext = gang.extend_cluster(ct.to("cuda"), pb)
    full = topology._count_pn_plain(ext, pb.sc_sel, pb.pod_ns)
    m = _mesh((1, 2))
    s = mesh_mod.shard_cluster(m, ext)
    layout = mesh_mod.Layout(m, s.layout.N, 0)
    kernels.reset_launches()
    parts = mesh_mod.run(layout, lambda piece, d: topology._count_pn(
        piece, pb.sc_sel.to(d), pb.pod_ns.to(d)),
        [(p, d) for p, d in zip(s.pieces, m.device_list())])
    got = torch.cat([p.to("cuda:0") for p in parts], dim=2)
    assert float(full.sum()) > 0
    assert torch.equal(got, full)
    assert kernels.SHARD_LAUNCHES[("count_pn", 0, 0)] == 1
    assert kernels.SHARD_LAUNCHES[("count_pn", 0, 1)] == 1


@pytest.mark.gpu
def test_live_scheduler_on_a_mesh_binds_like_single_device():
    _card()
    from kubernetes_tpu_torch.config.types import SchedulerConfiguration
    from kubernetes_tpu_torch.sched.cache import SchedulerCache
    from kubernetes_tpu_torch.sched.queue import SchedulingQueue
    from kubernetes_tpu_torch.sched.scheduler import Scheduler
    from kubernetes_tpu_torch.testing.wrappers import make_node, make_pod

    def run(mesh):
        cache = SchedulerCache()
        for i in range(32):
            cache.add_node(make_node(f"n{i:02d}")
                           .capacity({"cpu": "8", "memory": "16Gi",
                                      "pods": "20"})
                           .label("topology.kubernetes.io/zone", f"z{i // 3}")
                           .obj())
        queue = SchedulingQueue(backoff_initial=0.05)
        log = []
        sched = Scheduler(SchedulerConfiguration(batch_size=16,
                                                 max_drain_batches=2),
                          cache, queue, lambda p, n: log.append(
                              (p.metadata.name, n)) or True)
        if mesh is not None:
            sched.set_mesh(mesh)
        pods = [make_pod(f"p{i:02d}").req({"cpu": "500m"})
                .label("app", f"g{i % 3}")
                .spread(1, "topology.kubernetes.io/zone", "ScheduleAnyway",
                        {"app": "g1"}).obj() for i in range(48)]
        for p in pods:
            queue.add(p)
        try:
            for _ in range(20):
                sched.run_once(wait=0.01)
                if not sched._pending and not queue.stats()["active"]:
                    break
            sched._resolve_pending()
            sched.wait_for_bindings()
        finally:
            sched.close()
        return dict(log)

    single = run(None)
    assert len(single) == 48
    assert run(_mesh((1, 2))) == single
