"""The live scheduler on a device mesh: the port against the JAX package,
on the CPU.

The cases of ``tests/test_mesh_live.py`` run on both packages through
``tests/torch_store_parity.py``: both pass, and their records are equal.
Where a case configures ``meshShape``, the JAX side meets it with XLA's 8
virtual CPU devices (``tests/conftest.py``); the port's
``mesh_from_shape`` counts real devices (CUDA cards) and so is handed
logical ``cpu`` shards for the port's leg, the port's counterpart of the
virtual devices. The two status cases are compared by their own
assertions on both packages, not by record: the status ConfigMap carries
the port's ``loopError`` (a fatal error stops the port's runner, C1) and
a write stamp. The cases that call JAX directly (the sharded preemption
masks, the fill-only encode's leaf walk) are rewritten for the port
below.

Then the port's own cases: a mesh installed through ``set_mesh`` (the
operator entry, the one that takes a repeated device) schedules the same
pods onto the same nodes as single-device at (1,2), (2,2) and (1,4), with
churn mid-run folded into the sharded context; a reshape rebuilds the drain context
and declines the planners' view built under the old mesh; the staging
arena's tickets follow the mesh; and ``publish_status`` and ``ktpu
status`` show the installed mesh.
"""

from __future__ import annotations

import io
import json

import numpy as np
import pytest

import torch_store_parity as parity
from kubernetes_tpu_torch.config.types import SchedulerConfiguration, validate
from kubernetes_tpu_torch.parallel import mesh as mesh_mod
from kubernetes_tpu_torch.sched.cache import SchedulerCache
from kubernetes_tpu_torch.sched.queue import SchedulingQueue
from kubernetes_tpu_torch.sched.scheduler import Scheduler
from kubernetes_tpu_torch.testing.wrappers import make_node, make_pod

NAME = "test_mesh_live"
# JAX's buffer donation and its row-pack encode: the port donates nothing
# (it updates the resident tensors in place) and has no row pack
LEFT_OUT = ("test_drain_patch_steady_state_no_copy_on_donate_warnings",
            "test_row_pack_invalidation_on_epoch_and_identity")
# call JAX directly (jax.devices(), jax.tree_util): rewritten below
REWRITTEN = ("test_preempt_masks_sharded_parity",
             "test_fill_only_cycles_do_no_per_pod_fill_work")
# the status ConfigMap differs by the port's loopError and a stamp
BY_ASSERTIONS = ("test_publish_status_and_ktpu_status",
                 "test_ktpu_status_compile_cache_line")
CASES = [c for c in parity.cases(NAME)
         if c[1] not in LEFT_OUT + REWRITTEN]


@pytest.fixture(scope="module")
def shared():
    yield from parity.shared_fixtures()


@pytest.fixture
def cpu_devices(monkeypatch):
    """The port's ``mesh_from_shape`` over 8 logical ``cpu`` shards, as
    the JAX side's over XLA's 8 virtual CPU devices."""
    real = mesh_mod.mesh_from_shape

    def on_cpu(shape, devices=None):
        return real(shape, devices=devices or ["cpu"] * 8)

    monkeypatch.setattr(mesh_mod, "mesh_from_shape", on_cpu)


@pytest.mark.parametrize("fname,params", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_reference_case_on_both_packages(fname, params, tmp_path, shared,
                                         cpu_devices):
    ref, port = parity.both(NAME, fname, params, tmp_path, shared)
    if fname not in BY_ASSERTIONS:
        assert port == ref


def test_mesh_live_cases_are_selected():
    names = {c[1] for c in parity.cases(NAME)}
    assert names - {c[1] for c in CASES} == set(LEFT_OUT + REWRITTEN)
    assert len(CASES) == 9


def test_fill_only_cycles_do_no_per_pod_fill_work():
    """tests/test_mesh_live.py's case, for the port: a second encode of
    the same pods stacks their cached rows, and precompiled pods pay no
    per-pod fill on the hot path."""
    from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
    from kubernetes_tpu_torch.models.gang import _tree_leaves
    nodes, pods = _nodes(16), _pods(12)
    enc = SnapshotEncoder()
    _ct, meta = enc.encode_cluster(nodes, [], pending_pods=pods)
    pb1 = enc.encode_pods(pods, meta)
    assert enc.pod_rows_filled == 12 and enc.pod_rows_stacked == 0
    pb2 = enc.encode_pods(pods, meta)
    assert enc.pod_rows_filled == 12 and enc.pod_rows_stacked == 12
    for a, b in zip(_tree_leaves(pb1), _tree_leaves(pb2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    fresh = _pods(8, prefix="q")
    for p in fresh:
        enc.precompile_pod(p)
    filled0 = enc.pod_rows_filled
    enc.encode_pods(fresh, meta)
    assert enc.pod_rows_filled == filled0


# ---- the port's own cases -------------------------------------------------

def _nodes(n=64):
    return [make_node(f"n{i:03d}")
            .capacity({"cpu": "8", "memory": "16Gi", "pods": "20"})
            .label("topology.kubernetes.io/zone", f"z{i // 3}")
            .label("kubernetes.io/hostname", f"n{i:03d}")
            .obj() for i in range(n)]


def _pods(n=48, prefix="p"):
    out = []
    for i in range(n):
        b = (make_pod(f"{prefix}{i:03d}")
             .req({"cpu": "500m", "memory": "256Mi"})
             .label("app", f"g{i % 3}"))
        if i % 5 == 0:
            b = b.pod_anti_affinity("kubernetes.io/hostname", {"app": "g0"})
        if i % 7 == 0:
            b = b.spread(1, "topology.kubernetes.io/zone", "DoNotSchedule",
                         {"app": "g1"})
        out.append(b.obj())
    return out


def _scheduler(mesh=None, batch_size=16):
    cfg = SchedulerConfiguration(batch_size=batch_size, max_drain_batches=2)
    validate(cfg)
    cache = SchedulerCache()
    for n in _nodes():
        cache.add_node(n)
    queue = SchedulingQueue(backoff_initial=0.05)
    log = []
    sched = Scheduler(cfg, cache, queue,
                      lambda pod, node: log.append((pod.metadata.name, node))
                      or True, device="cpu")
    if mesh is not None:
        sched.set_mesh(mesh)
    warm = [make_pod(f"__warm{i}").req({"cpu": "100m"}).obj()
            for i in range(batch_size)]
    assert sched.warm_drain(warm, slot_headroom=256)
    return sched, cache, queue, log


def _run_to_empty(sched, queue, pods, rounds=30):
    for p in pods:
        queue.add(p)
    bound = 0
    for _ in range(rounds):
        bound += sched.run_once(wait=0.01)
        if not sched._pending and not queue.stats()["active"]:
            break
    bound += sched._resolve_pending()
    sched.wait_for_bindings()
    return bound


def _cpu_mesh(shape):
    return mesh_mod.make_mesh(["cpu"] * (shape[0] * shape[1]),
                              pods_axis=shape[0])


def _live(mesh):
    sched, cache, queue, log = _scheduler(mesh)
    try:
        bound = _run_to_empty(sched, queue, _pods(48))
        # churn against the resident (sharded) context mid-run: a node
        # joins and a bound pod leaves
        cache.add_node(make_node("late-node")
                       .capacity({"cpu": "8", "memory": "16Gi", "pods": "20"})
                       .label("topology.kubernetes.io/zone", "z99")
                       .label("kubernetes.io/hostname", "late-node").obj())
        cache.remove_pod("default/p003")
        bound += _run_to_empty(sched, queue, _pods(16, prefix="late"))
        assert sched.ctx_stats["rebuilds"] >= 1
        stats = dict(sched.ctx_stats)
        return bound, dict(log), stats, sched.mesh
    finally:
        sched.close()


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)],
                         ids=["1x2", "2x2", "1x4"])
def test_live_path_on_a_mesh_equals_single_device(shape):
    mesh = _cpu_mesh(shape)
    bound, placed, stats, active = _live(mesh)
    bound0, placed0, stats0, _ = _live(None)
    assert active is mesh
    assert bound == bound0 == 64
    assert placed == placed0
    # the churn rode the resident context on both (no extra rebuilds)
    assert stats["rebuilds"] == stats0["rebuilds"]
    assert stats["folds"] + stats["patches"] >= 1
    assert (stats["folds"], stats["patches"]) == (stats0["folds"],
                                                  stats0["patches"])


def test_reshape_rebuilds_and_declines_old_views():
    sched, cache, queue, log = _scheduler(_cpu_mesh((1, 2)))
    try:
        assert _run_to_empty(sched, queue, _pods(24)) == 24
        ctx = sched._drain_ctx
        assert isinstance(ctx["ct"], mesh_mod.ShardedCluster)
        view, why = sched.resident_plan_view()
        assert why == "ok" and view["mesh"] is sched.mesh
        rebuilds = sched.ctx_stats["rebuilds"]
        sched.set_mesh(_cpu_mesh((1, 4)))
        assert sched.resident_plan_view() == (None, "mesh_epoch")
        assert _run_to_empty(sched, queue, _pods(24, prefix="q")) == 24
        assert sched.ctx_stats["reasons"]["mesh_reshape"] >= 1
        assert sched.ctx_stats["rebuilds"] > rebuilds
        ct = sched._drain_ctx["ct"]
        assert ct.mesh is sched.mesh and len(ct.pieces) == 4
        sched.set_mesh(None)
        assert _run_to_empty(sched, queue, _pods(8, prefix="r")) == 8
        assert not isinstance(sched._drain_ctx["ct"], mesh_mod.ShardedCluster)
    finally:
        sched.close()


def test_staging_tickets_follow_the_mesh():
    from kubernetes_tpu_torch.models.gang import stack_batches
    from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
    cache = SchedulerCache()
    cache.configure_staging(True, "cpu")
    enc = SnapshotEncoder()
    nodes, pods = _nodes(8), _pods(4)
    _ct, meta = enc.encode_cluster(nodes, [], pending_pods=pods)
    stack = stack_batches([enc.encode_pods(pods, meta, min_p=4)])
    mesh = _cpu_mesh((1, 2))
    cache.set_mesh(mesh)
    staged = cache.stage_redeem(cache.stage_submit(stack))
    assert set(staged) == {mesh_mod.torch.device("cpu")}
    # a ticket staged for one mesh never redeems under another
    ticket = cache.stage_submit(stack)
    cache.set_mesh(_cpu_mesh((1, 4)))
    assert cache.stage_redeem(ticket) is None
    assert cache.staging_stats()["fallbacks"] == 1
    inline = cache.stage_drain_batch(stack)
    assert isinstance(inline, dict)
    cache.close_staging()


def test_preempt_masks_sharded_parity():
    """tests/test_mesh_live.py's case, for the port: the preemption wave's
    static masks on a mesh == single-device == the JAX package's."""
    from kubernetes_tpu.sched.preemption import \
        tensor_static_masks as ref_masks
    from kubernetes_tpu.testing.wrappers import make_node as jnode
    from kubernetes_tpu.testing.wrappers import make_pod as jpod
    from kubernetes_tpu_torch.sched.preemption import tensor_static_masks

    def inputs(mk_node, mk_pod):
        nodes = [mk_node(f"n{i:03d}")
                 .capacity({"cpu": "8", "memory": "16Gi", "pods": "20"})
                 .label("kubernetes.io/hostname", f"n{i:03d}").obj()
                 for i in range(32)]
        nodes[3].spec.unschedulable = True
        pre = [mk_pod(f"hi{i}").req({"cpu": "6"}).priority(100).obj()
               for i in range(8)]
        return nodes, pre

    nodes, pre = inputs(make_node, make_pod)
    base = tensor_static_masks(nodes, pre, bound_pods=[], device="cpu")
    ref = ref_masks(*inputs(jnode, jpod), bound_pods=[])
    assert not base.all()
    for shape in [(1, 2), (2, 2)]:
        sharded = tensor_static_masks(nodes, pre, bound_pods=[],
                                      mesh=_cpu_mesh(shape), device="cpu")
        np.testing.assert_array_equal(base, sharded)
    np.testing.assert_array_equal(base, ref)


def test_publish_status_and_ktpu_status_show_the_mesh():
    from kubernetes_tpu_torch.cli.ktpu import main as ktpu_main
    from kubernetes_tpu_torch.client.clientset import HTTPClient
    from kubernetes_tpu_torch.metrics.registry import MESH_DEVICES
    from kubernetes_tpu_torch.sched.runner import SchedulerRunner
    from kubernetes_tpu_torch.store.apiserver import APIServer
    server = APIServer().start()
    try:
        runner = SchedulerRunner(HTTPClient(server.url), device="cpu")
        runner.scheduler.set_mesh(_cpu_mesh((1, 2)))
        assert MESH_DEVICES.get() == 2
        runner.publish_status()
        out = io.StringIO()
        assert ktpu_main(["--server", server.url, "status"], out=out) == 0
        text = out.getvalue()
        assert "Mesh:          1x2 (2 devices, pods x nodes)" in text
        assert "Device ids:    ['cpu', 'cpu']" in text
        out = io.StringIO()
        assert ktpu_main(["--server", server.url, "status", "-o", "json"],
                         out=out) == 0
        st = json.loads(out.getvalue())
        assert st["mesh"] == {"shape": {"pods": 1, "nodes": 2},
                              "devices": 2, "deviceIds": ["cpu", "cpu"]}
        runner.scheduler.set_mesh(None)
        assert MESH_DEVICES.get() == 1
        runner.scheduler.close()
    finally:
        server.stop()
