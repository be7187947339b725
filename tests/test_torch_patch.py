"""The port's churn patch path against the JAX package's, on the CPU.

Two halves of the reference's incremental ``Cache.UpdateSnapshot``:

- the host encoding's pod deltas (``SnapshotEncoder.apply_pod_deltas``
  through ``SchedulerCache.snapshot``): the sequences of
  ``tests/test_cache_incremental.py`` give equal encodings, and the same
  full-encode fallbacks;
- the device-resident drain context's churn patches (``encode/patch.py``,
  ``drain_step``'s fused ``patch``): the sequences of
  ``tests/test_ctx_patch.py`` driven through ``testing/resident.py`` and
  through the same steps of the reference give equal compiled patches
  (array by array), equal ``CtxPatchState`` bookkeeping, equal placements
  and a bit-equal resident context after every cycle.
"""

from __future__ import annotations

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api.types import Node as RefNode, Pod as RefPod
from kubernetes_tpu.encode import patch as ref_patch
from kubernetes_tpu.models import gang as ref_gang
from kubernetes_tpu.sched.cache import SchedulerCache as RefCache
from kubernetes_tpu.testing import wrappers as ref_wrappers
from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.encode import patch
from kubernetes_tpu_torch.models import gang
from kubernetes_tpu_torch.sched.cache import SchedulerCache
from kubernetes_tpu_torch.testing import wrappers
from kubernetes_tpu_torch.testing.resident import (DRAIN_NOM_BUCKET as
                                                   NOM_BUCKET, ResidentDrain)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _flat(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _flat(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy().copy()  # a record, not a view of live state
    return np.asarray(x)


def _assert_same(ref, port, path="") -> None:
    if isinstance(ref, dict):
        assert set(ref) == set(port), path
        for k in ref:
            _assert_same(ref[k], port[k], f"{path}.{k}")
        return
    ref, port = np.asarray(ref), np.asarray(port)
    assert ref.dtype == port.dtype, (path, ref.dtype, port.dtype)
    assert ref.shape == port.shape, (path, ref.shape, port.shape)
    assert np.array_equal(ref, port, equal_nan=ref.dtype.kind == "f"), path


def _plain(v):
    """CtxPatchState values with the packages' own types taken out: pods
    by key, arrays as lists, sets sorted."""
    if isinstance(v, (Pod, RefPod)):
        return ("pod", v.key)
    if isinstance(v, np.ndarray):
        return ("array", v.dtype.str, v.tolist())
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, set):
        return sorted(v)
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def _patch_state(cs) -> dict:
    return {f.name: _plain(getattr(cs, f.name)) for f in dataclasses.fields(cs)}


# ---- host encoding: the cache's pod-delta path ------------------------------

class _Caches:
    """The same events into a reference cache and a port cache; each
    snapshot is compared field for field."""

    def __init__(self):
        self.ref, self.port = RefCache(), SchedulerCache()

    def node(self, d):
        self.ref.add_node(RefNode.from_dict(copy.deepcopy(d)))
        self.port.add_node(Node.from_dict(copy.deepcopy(d)))

    def pod(self, d):
        self.ref.add_pod(RefPod.from_dict(copy.deepcopy(d)))
        self.port.add_pod(Pod.from_dict(copy.deepcopy(d)))

    def assume(self, d, node):
        self.ref.assume(RefPod.from_dict(copy.deepcopy(d)), node)
        self.port.assume(Pod.from_dict(copy.deepcopy(d)), node)

    def remove_pod(self, key):
        self.ref.remove_pod(key)
        self.port.remove_pod(key)

    def snapshot(self, pending=()):
        before = (self.ref._encoder.generation, self.port._encoder.generation)
        rn, rct, rmeta = self.ref.snapshot(
            pending_pods=[RefPod.from_dict(d) for d in pending])
        pn, pct, pmeta = self.port.snapshot(
            pending_pods=[Pod.from_dict(d) for d in pending])
        _assert_same(_flat(rct), _flat(pct), "ct")
        assert [n.metadata.name for n in rn] == [n.metadata.name for n in pn]
        assert (rmeta.node_names, rmeta.resources, rmeta.topo_keys) == \
            (pmeta.node_names, pmeta.resources, pmeta.topo_keys)
        assert self.ref.log_seq() == self.port.log_seq()
        assert self.ref._generation == self.port._generation
        full = [self.ref._encoder.generation > before[0],
                self.port._encoder.generation > before[1]]
        assert full[0] == full[1]
        return full[1], pct


def _nodes(n=8):
    return [wrappers.make_node(f"n{i}")
            .capacity({"cpu": "8", "memory": "16Gi", "pods": "20"})
            .label("topology.kubernetes.io/zone", f"z{i % 3}")
            .label("kubernetes.io/hostname", f"n{i}")
            .obj().to_dict() for i in range(n)]


def _pod(i, labels=None, anti=False, **extra):
    b = wrappers.make_pod(f"p{i}").req({"cpu": "500m", "memory": "256Mi"})
    for k, v in (labels or {"app": "a"}).items():
        b = b.label(k, v)
    if anti:
        b = b.pod_anti_affinity("kubernetes.io/hostname", {"app": "a"})
    d = b.obj().to_dict()
    d["spec"].update(extra)
    return d


def test_pod_binds_patch_the_host_encoding_as_the_reference():
    c = _Caches()
    for n in _nodes():
        c.node(n)
    pending = [_pod(i, anti=(i % 2 == 0)) for i in range(6)]
    assert c.snapshot(pending)[0]
    for i, p in enumerate(pending[:3]):
        c.assume(p, f"n{i}")
    full, ct = c.snapshot(pending[3:])
    assert not full, "should have patched"
    assert int(np.asarray(ct.epod_valid).sum()) == 3


def test_unbind_and_rebind_patch_the_host_encoding_as_the_reference():
    c = _Caches()
    for n in _nodes(4):
        c.node(n)
    pods = [_pod(i) for i in range(4)]
    c.snapshot(pods)
    for i, p in enumerate(pods):
        c.assume(p, f"n{i}")
    assert not c.snapshot()[0]
    c.remove_pod("default/p0")
    full, ct = c.snapshot()
    assert not full and int(np.asarray(ct.epod_valid).sum()) == 3
    c.assume(pods[0], "n3")
    assert not c.snapshot()[0]


def test_heartbeat_and_status_updates_keep_the_encoding():
    c = _Caches()
    for n in _nodes(4):
        c.node(n)
    bound = _pod(0, nodeName="n0")
    c.pod(bound)
    c.snapshot()
    cached = c.port.snapshot()[1]
    hb = copy.deepcopy(_nodes(4)[0])
    hb["status"]["conditions"] = [{"type": "Ready", "status": "True"}]
    c.node(hb)
    status = copy.deepcopy(bound)
    status.setdefault("status", {})["phase"] = "Running"
    c.pod(status)
    assert c.port.snapshot()[1] is cached
    assert c.ref.log_seq() == c.port.log_seq()
    relabeled = copy.deepcopy(status)
    relabeled["metadata"]["labels"]["app"] = "changed"
    c.pod(relabeled)
    assert not c.snapshot()[0]


def test_structural_changes_fall_back_to_a_full_encode_as_the_reference():
    c = _Caches()
    for n in _nodes(4):
        c.node(n)
    c.snapshot()
    relabeled = _nodes(4)[0]
    relabeled["metadata"]["labels"]["disk"] = "ssd"
    c.node(relabeled)
    assert c.snapshot()[0]
    # a label key beyond the K bucket: the patch bails, full encode
    c.assume(_pod(9, labels={"brand-new-key": "x"}), "n1")
    full, ct = c.snapshot()
    assert full and int(np.asarray(ct.epod_valid).sum()) == 1
    # a pod with a volume: not patchable
    vol = _pod(10, volumes=[{"name": "v",
                             "persistentVolumeClaim": {"claimName": "c1"}}])
    c.assume(vol, "n0")
    assert c.snapshot()[0]


def test_apply_pod_deltas_refuses_what_the_reference_refuses():
    """Direct encoder calls: an upsert onto an unknown node and a delete of
    a pod with host ports give None on both sides; a fitting delta gives
    equal arrays."""
    c = _Caches()
    for n in _nodes(3):
        c.node(n)
    ported = _pod(1, nodeName="n1")
    ported["spec"]["containers"][0]["ports"] = [{"containerPort": 80,
                                                 "hostPort": 8080}]
    c.pod(ported)
    c.pod(_pod(2, nodeName="n2"))
    c.snapshot()
    _, rct, rmeta = c.ref.snapshot()
    _, pct, pmeta = c.port.snapshot()
    renc, penc = c.ref._encoder, c.port._encoder
    ghost = _pod(3, nodeName="nowhere")
    assert renc.apply_pod_deltas(rct, rmeta, [RefPod.from_dict(ghost)],
                                 []) is None
    assert penc.apply_pod_deltas(pct, pmeta, [Pod.from_dict(ghost)],
                                 []) is None
    assert renc.apply_pod_deltas(rct, rmeta, [], ["default/p1"]) is None
    assert penc.apply_pod_deltas(pct, pmeta, [], ["default/p1"]) is None
    moved = _pod(2, nodeName="n0")
    r = renc.apply_pod_deltas(rct, rmeta, [RefPod.from_dict(moved)], [])
    p = penc.apply_pod_deltas(pct, pmeta, [Pod.from_dict(moved)], [])
    _assert_same(_flat(r), _flat(p), "patched")
    assert _patch_state(renc._patch) == _patch_state(penc._patch)


def test_with_nominated_equals_reference():
    c = _Caches()
    for n in _nodes(3):
        c.node(n)
    c.snapshot()
    _, rct, rmeta = c.ref.snapshot()
    _, pct, pmeta = c.port.snapshot()
    noms = [("n1", 50, _pod(7)), ("gone", 9, _pod(8)), ("n2", 3, _pod(9))]
    for min_m in (0, 16):
        r = c.ref._encoder.with_nominated(
            rct, rmeta, [(n, p, RefPod.from_dict(d)) for n, p, d in noms],
            min_m=min_m)
        p = c.port._encoder.with_nominated(
            pct, pmeta, [(n, p, Pod.from_dict(d)) for n, p, d in noms],
            min_m=min_m)
        _assert_same(_flat(r), _flat(p), f"nominated[{min_m}]")


# ---- the resident drain context under churn ---------------------------------

class _RefResident:
    """The reference package's side of ``testing/resident.ResidentDrain``:
    the same steps of ``sched/scheduler.py`` ``_schedule_drain`` and
    ``warm_drain``, each through the reference's own functions."""

    def __init__(self, cache, batch_size, max_drain_batches, slot_headroom):
        self.cache, self.P, self.B = cache, batch_size, max_drain_batches
        self.slot_headroom = slot_headroom
        self.ctx = None

    def _stack(self, pbs):
        return jax.tree_util.tree_map(lambda *xs: np.stack(xs),
                                      *ref_gang.unify_batches(pbs))

    def _build(self, ct, meta, pbs, seq0):
        ct_dev, e0, fill = ref_gang.build_drain_context(
            ct, pbs, nom_bucket=NOM_BUCKET)
        cs = self.cache.patch_state_fork()
        ref_patch.sync_resident_widths(cs, ct_dev)
        self.ctx = {"ct": ct_dev, "e0": e0,
                    "fill_dev": jnp.asarray(fill, jnp.int32),
                    "fill_bound": fill, "meta": ref_patch.fork_meta(meta),
                    "cs": cs, "seq": seq0,
                    "pb_shape": ref_gang.batch_shapes(self._stack(pbs))}

    def arm(self, sample):
        _, ct, meta = self.cache.snapshot(pending_pods=sample[:self.P],
                                          slot_headroom=self.slot_headroom)
        chunks = [sample[i * self.P:(i + 1) * self.P] or sample[:self.P]
                  for i in range(self.B)]
        pbs = [self.cache.encode_pods(c, meta, min_p=self.P) for c in chunks]
        self._build(ct, meta, pbs, self.cache.last_snapshot_seq())

    def cycle(self, pods, nom_target):
        ctx, use_ctx, fused, rebuilt = self.ctx, False, None, False
        if ctx is not None:
            cs = ctx["cs"]
            known = set(ctx["meta"].resources)
            if (not cs.tainted and ctx["fill_bound"] + len(pods) <= cs.top
                    and not any(r not in known for p in pods
                                for r in p.resource_requests())):
                entries = self.cache.deltas_since(ctx["seq"])
                nom_dirty = (set(nom_target) != set(cs.nom_applied)
                             or any(cs.nom_applied[k][1:] != (n, prio)
                                    for k, (n, prio, _p) in nom_target.items()
                                    if k in cs.nom_applied))
                if entries is None:
                    pass
                elif not nom_dirty and ref_patch.entries_all_folded(cs,
                                                                    entries):
                    if entries:
                        ctx["seq"] = entries[-1][0] + 1
                    use_ctx = True
                else:
                    new_seq = entries[-1][0] + 1 if entries else ctx["seq"]
                    compiled = self.cache.compile_ctx_patch(
                        ctx["meta"], cs, entries, nom_target,
                        NOM_BUCKET, fold_floor=ctx["fill_bound"])
                    if (compiled is not None
                            and ctx["fill_bound"] + len(pods) <= cs.top):
                        fused, ctx["seq"], use_ctx = compiled, new_seq, True
        if use_ctx:
            meta = ctx["meta"]
        else:
            self.ctx = None
            _, ct, meta = self.cache.snapshot(
                pending_pods=pods, slot_headroom=self.slot_headroom)
            seq0 = self.cache.last_snapshot_seq()
        chunks = [pods[i:i + self.P] for i in range(0, len(pods), self.P)]
        pbs = [self.cache.encode_pods(c, meta, min_p=self.P) for c in chunks]
        while len(pbs) < self.B:
            pbs.append(pbs[-1].replace(
                pod_valid=np.zeros_like(np.asarray(pbs[-1].pod_valid))))
        pb_stack = self._stack(pbs)
        if not use_ctx:
            self._build(ct, meta, pbs, seq0)
            rebuilt, ctx, meta = True, self.ctx, self.ctx["meta"]
            if nom_target:
                compiled = self.cache.compile_ctx_patch(
                    meta, ctx["cs"], [], nom_target, NOM_BUCKET)
                ctx["ct"] = ref_gang.apply_ctx_patch(ctx["ct"], compiled)
        else:
            pb_stack = ref_gang.pad_batch_to(pb_stack, ctx["pb_shape"])
        a, rounds, ctx["ct"], ctx["fill_dev"] = ref_gang.drain_step(
            ctx["ct"], pb_stack, ctx["fill_dev"], fused, e0=ctx["e0"],
            seed=0, fit_strategy="LeastAllocated", topo_keys=meta.topo_keys,
            weights=(), enabled_filters=(), max_rounds=64)
        ctx["fill_bound"] += len(pods)
        a = np.asarray(a)
        names = ctx["meta"].node_names
        to_bind, rows = [], []
        for b, chunk in enumerate(chunks):
            for pod, x in zip(chunk, a[b][:len(chunk)]):
                if x >= 0:
                    to_bind.append((pod, names[int(x)]))
                    rows.append(int(x))
        if to_bind:
            self.cache.assume_many(to_bind)
            cs = ctx["cs"]
            fill = cs.fill_host
            for (pod, node), row in zip(to_bind, rows):
                cs.slot_of[pod.key] = fill
                cs.slot_node[pod.key] = row
                cs.slot_req[pod.key] = pod
                cs.row_pods[row] = cs.row_pods.get(row, 0) + 1
                cs.folded[pod.key] = node
                fill += 1
            cs.fill_host = fill
        return {"placed": {p.key: n for p, n in to_bind},
                "rounds": np.asarray(rounds).tolist(), "patch": fused,
                "rebuilt": rebuilt}


class _Env:
    """One package's side of a churn script: its cache, its drain driver
    and its wrappers. ``drain`` records each cycle for the comparison."""

    def __init__(self, side, nodes, batch_size=4, drain_batches=2,
                 slot_headroom=64):
        self.side = side
        self.w = ref_wrappers if side == "ref" else wrappers
        self.cache = RefCache() if side == "ref" else SchedulerCache()
        for n in nodes:
            self.cache.add_node(self.parse_node(n))
        args = (self.cache, batch_size, drain_batches, slot_headroom)
        self.drv = (_RefResident(*args) if side == "ref" else
                    ResidentDrain(*args[:1], batch_size=batch_size,
                                  max_drain_batches=drain_batches,
                                  slot_headroom=slot_headroom, device="cpu"))
        self.records = []
        warm = [self.w.make_pod(f"__warm{i}").req({"cpu": "100m"}).obj()
                for i in range(batch_size)]
        self.drv.arm(warm)
        self.ctx0 = self.drv.ctx

    def parse_node(self, d):
        return (RefNode if self.side == "ref" else Node).from_dict(
            copy.deepcopy(d))

    def drain(self, pods, nom_target=None):
        nom_target = nom_target or {}
        if self.side == "ref":
            rec = self.drv.cycle(pods, nom_target)
        else:
            out = self.drv.cycle(pods, nom_target)
            rec = {"placed": out.placed, "rounds": out.rounds,
                   "patch": out.patch, "rebuilt": out.rebuilt}
        ctx = self.drv.ctx
        rec.update(cs=_patch_state(ctx["cs"]), ct=_flat(ctx["ct"]),
                   fill=int(ctx["fill_dev"]),
                   node_names=list(ctx["meta"].node_names))
        self.records.append(rec)
        return len(rec["placed"])


def _script_pod_delete(env):
    w, c = env.w, env.cache
    fill = [w.make_pod(f"f{i}").req({"cpu": "600m"}).obj() for i in range(2)]
    assert env.drain(fill) == 2
    assert env.drain([w.make_pod("nofit").req({"cpu": "600m"}).obj()]) == 0
    c.remove_pod("default/f0")
    assert env.drain([w.make_pod("refit").req({"cpu": "600m"}).obj()]) == 1


def _script_node_add(env):
    w, c = env.w, env.cache
    assert env.drain([w.make_pod(f"s{i}").req({"cpu": "700m"}).obj()
                      for i in range(2)]) == 2
    assert env.drain([w.make_pod("wait").req({"cpu": "900m"}).obj()]) == 0
    c.add_node(w.make_node("fresh")
               .capacity({"cpu": "4", "memory": "8Gi", "pods": "32"}).obj())
    assert env.drain([w.make_pod("landed").req({"cpu": "900m"}).obj()]) == 1
    assert env.records[-1]["placed"] == {"default/landed": "fresh"}


def _script_node_delete(env):
    w, c = env.w, env.cache
    c.remove_node("n1")
    assert env.drain([w.make_pod(f"p{i}").req({"cpu": "100m"}).obj()
                      for i in range(6)]) == 6
    assert "n1" not in env.records[-1]["placed"].values()


def _script_recreate_cycle(env):
    w, c = env.w, env.cache
    for i in range(6):
        c.add_node(w.make_node(f"churn-n{i}")
                   .capacity({"cpu": "2", "memory": "4Gi", "pods": "8"})
                   .obj())
        c.add_pod(w.make_pod(f"churn-p{i}", "churn").req({"cpu": "100m"})
                  .node(f"churn-n{i}").obj())
        if i >= 2:
            c.remove_node(f"churn-n{i - 2}")
            c.remove_pod(f"churn/churn-p{i - 2}")
            c.remove_pod(f"default/m{i - 2}")
        assert env.drain([w.make_pod(f"m{i}").req({"cpu": "100m"}).obj()]) \
            == 1


def _script_nominee(env):
    w = env.w
    nominee = w.make_pod("nom").req({"cpu": "1500m"}).priority(50).obj()
    target = {"preempt/nom": ("n0", 50, nominee)}
    low = w.make_pod("low").req({"cpu": "1"}).priority(1).obj()
    assert env.drain([low], target) == 0
    high = w.make_pod("high").req({"cpu": "1"}).priority(100).obj()
    assert env.drain([high], target) == 1
    # the reservation dropped: its capacity is free for any priority
    assert env.drain([w.make_pod("after").req({"cpu": "600m"}).priority(1)
                      .obj()], {}) == 1


def _script_unpatchable(env):
    w, c = env.w, env.cache
    assert env.drain([w.make_pod("before").req({"cpu": "100m"}).obj()]) == 1
    c.update_volume_object(
        "StorageClass", {"kind": "StorageClass", "metadata": {"name": "fast"},
                         "provisioner": "x",
                         "volumeBindingMode": "WaitForFirstConsumer"})
    assert env.drain([w.make_pod("after").req({"cpu": "100m"}).obj()]) == 1
    assert env.records[-1]["rebuilt"] and env.records[-1]["patch"] is None


def _cluster(n, cpu):
    return [wrappers.make_node(f"n{i}")
            .capacity({"cpu": cpu, "memory": "8Gi", "pods": "32"})
            .obj().to_dict() for i in range(n)]


SCRIPTS = {
    "pod_delete": (_script_pod_delete, _cluster(2, "1")),
    "node_add": (_script_node_add, _cluster(2, "1")),
    "node_delete": (_script_node_delete, _cluster(3, "2")),
    "recreate_cycle": (_script_recreate_cycle, _cluster(4, "4")),
    "nominee_reservation": (_script_nominee, _cluster(1, "2")),
    "unpatchable_delta": (_script_unpatchable, _cluster(2, "4")),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_churn_patches_equal_reference(name):
    script, nodes = SCRIPTS[name]
    envs = {side: _Env(side, nodes) for side in ("ref", "port")}
    for env in envs.values():
        script(env)
    ref, port = envs["ref"].records, envs["port"].records
    assert len(ref) == len(port)
    for i, (r, p) in enumerate(zip(ref, port)):
        assert r["placed"] == p["placed"], i
        assert r["rounds"] == p["rounds"], i
        assert r["rebuilt"] == p["rebuilt"], i
        assert (r["patch"] is None) == (p["patch"] is None), i
        if r["patch"] is not None:
            _assert_same(r["patch"], p["patch"], f"patch[{i}]")
        _assert_same(r["ct"], p["ct"], f"ctx[{i}]")
        assert r["cs"] == p["cs"], i
        assert (r["fill"], r["node_names"]) == (p["fill"], p["node_names"])
    port_env = envs["port"]
    if name == "unpatchable_delta":
        assert port_env.drv.stats["rebuilds"] == 1
    else:
        assert port_env.drv.ctx is port_env.ctx0, "the context was rebuilt"
        assert port_env.drv.stats["rebuilds"] == 0
        assert any(rec["patch"] is not None for rec in port)


def _churned_context(side):
    """A context after a drain, with foreign churn waiting in the log."""
    env = _Env(side, _cluster(3, "4"))
    w, c = env.w, env.cache
    env.drain([w.make_pod(f"a{i}").req({"cpu": "500m"}).obj()
               for i in range(6)])
    c.add_pod(w.make_pod("foreign").req({"cpu": "300m"}).node("n1").obj())
    c.remove_pod("default/a0")
    c.add_node(w.make_node("late").capacity(
        {"cpu": "2", "memory": "4Gi", "pods": "8"}).obj())
    c.remove_node("n2")
    ctx = env.drv.ctx
    entries = c.deltas_since(ctx["seq"])
    compiled = c.compile_ctx_patch(ctx["meta"], ctx["cs"], entries, {},
                                   NOM_BUCKET, fold_floor=ctx["fill_bound"])
    assert compiled is not None
    pods = [w.make_pod(f"b{i}").req({"cpu": "500m"}).obj() for i in range(6)]
    chunks = [pods[:4], pods[4:]]
    pbs = [c.encode_pods(ch, ctx["meta"], min_p=4) for ch in chunks]
    return env, ctx, compiled, pbs


def test_fused_drain_step_equals_apply_then_drain_and_reference():
    """drain_step(..., patch) equals apply_ctx_patch followed by
    drain_step (tests/test_fused_fold.py's property), and both equal the
    reference's fused drain."""
    env, ctx, compiled, pbs = _churned_context("port")
    renv, rctx, rcompiled, rpbs = _churned_context("ref")
    _assert_same(rcompiled, compiled, "patch")
    assert _patch_state(rctx["cs"]) == _patch_state(ctx["cs"])
    stack = gang.pad_batch_to(gang.stack_batches(gang.unify_batches(pbs)),
                              ctx["pb_shape"])
    kw = dict(e0=ctx["e0"], topo_keys=ctx["meta"].topo_keys)
    twin = gang._tree_map(lambda t: t.clone(), ctx["ct"])
    fused = gang.drain_step(ctx["ct"], stack, ctx["fill_dev"], compiled, **kw)
    applied = gang.apply_ctx_patch(twin, compiled)
    split = gang.drain_step(applied, stack, ctx["fill_dev"], **kw)
    for name, a, b in zip(("assignments", "rounds", "ct", "fill"), fused,
                          split):
        _assert_same(_flat(a), _flat(b), name)
    rstack = ref_gang.pad_batch_to(
        jax.tree_util.tree_map(lambda *xs: np.stack(xs),
                               *ref_gang.unify_batches(rpbs)),
        rctx["pb_shape"])
    ref = ref_gang.drain_step(
        rctx["ct"], rstack, rctx["fill_dev"], rcompiled, e0=rctx["e0"],
        seed=0, fit_strategy="LeastAllocated",
        topo_keys=rctx["meta"].topo_keys, weights=(), enabled_filters=(),
        max_rounds=64)
    for name, a, b in zip(("assignments", "rounds", "ct", "fill"), ref,
                          fused):
        _assert_same(_flat(a), _flat(b), name)
    assert (fused[0] >= 0).any()


def test_apply_ctx_patch_equals_reference():
    env, ctx, compiled, _ = _churned_context("port")
    renv, rctx, rcompiled, _ = _churned_context("ref")
    ref = ref_gang.apply_ctx_patch(rctx["ct"], rcompiled)
    port = gang.apply_ctx_patch(ctx["ct"], compiled)
    assert port is ctx["ct"]
    _assert_same(_flat(ref), _flat(port), "patched")


def test_fold_verdicts_equal_reference():
    """entries_all_folded and entries_fold_safe give the reference's
    verdicts on the same log windows and in-flight key sets."""
    envs = {side: _Env(side, _cluster(3, "4")) for side in ("ref", "port")}
    logs = {}
    for side, env in envs.items():
        w, c = env.w, env.cache
        env.drain([w.make_pod(f"a{i}").req({"cpu": "200m"}).obj()
                   for i in range(4)])
        seq = env.drv.ctx["seq"]
        c.add_pod(w.make_pod("foreign").req({"cpu": "300m"}).node("n1").obj())
        c.add_node(w.make_node("late").capacity(
            {"cpu": "2", "memory": "4Gi", "pods": "8"}).obj())
        c.remove_pod("default/a1")
        c.remove_node("n0")
        logs[side] = (env.drv.ctx["cs"], c.deltas_since(seq))
    mods = {"ref": ref_patch, "port": patch}
    verdicts = {}
    for side, (cs, entries) in logs.items():
        m = mods[side]
        out = []
        for lo in range(len(entries) + 1):
            for hi in range(lo, len(entries) + 1):
                window = entries[lo:hi]
                out.append(m.entries_all_folded(cs, window))
                for inflight in (set(), {"default/a1"}, {"default/foreign"}):
                    out.append(m.entries_fold_safe(cs, window, inflight))
        verdicts[side] = out
    assert verdicts["ref"] == verdicts["port"]
    assert any(verdicts["port"]) and not all(verdicts["port"])
