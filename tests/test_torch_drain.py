"""The port's queue drain against the JAX package's, on the CPU.

``gang_drain`` (the whole queue in one call) and the device-resident
``drain_step`` (refill, per-batch convergence, fold) take the same
encodings on both sides; assignments, rounds, the carried ``requested`` and
every field of the folded context must be bit-equal. Cross-batch cases
come from ``tests/test_gang_drain.py``: a later batch must see an earlier
batch's placements.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from benchmarks import workloads
from kubernetes_tpu.api.types import Node as RefNode, Pod as RefPod
from kubernetes_tpu.encode.snapshot import SnapshotEncoder as RefEncoder
from kubernetes_tpu.models import gang as ref_gang
from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.encode.convert import from_reference
from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
from kubernetes_tpu_torch.models import gang
from kubernetes_tpu_torch.testing.workloads import relational_mix
from kubernetes_tpu_torch.testing.wrappers import make_node, make_pod

KW = dict(seed=0, fit_strategy="LeastAllocated", weights=(),
          enabled_filters=(), max_rounds=64)


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
    assert ref.dtype == port.dtype, (path, ref.dtype, port.dtype)
    assert ref.shape == port.shape, (path, ref.shape, port.shape)
    assert np.array_equal(ref, port, equal_nan=ref.dtype.kind == "f"), path


def _zone_nodes(n, per_zone=3, cpu="4"):
    return [make_node(f"n{i}")
            .capacity({"cpu": cpu, "memory": "8Gi", "pods": "20"})
            .label("kubernetes.io/hostname", f"n{i}")
            .label("topology.kubernetes.io/zone", f"z{i // per_zone}")
            .obj().to_dict() for i in range(n)]


def _anti_affinity():
    pods = [make_pod(f"p{i}").label("grp", "g").req({"cpu": "500m"})
            .pod_anti_affinity("kubernetes.io/hostname", {"grp": "g"}).obj()
            for i in range(8)]
    return _zone_nodes(8), [], [p.to_dict() for p in pods], 4, None


def _capacity_carry():
    pods = [make_pod(f"p{i}").req({"cpu": "1"}).obj() for i in range(8)]
    return _zone_nodes(4, cpu="2"), [], [p.to_dict() for p in pods], 3, None


def _hard_spread():
    pods = [make_pod(f"p{i}").label("app", "a").req({"cpu": "250m"})
            .spread(1, "topology.kubernetes.io/zone", "DoNotSchedule",
                    {"app": "a"}).obj() for i in range(8)]
    return _zone_nodes(8, per_zone=2), [], [p.to_dict() for p in pods], 4, None


def _relational():
    nodes, bound, pending, ns_labels = relational_mix(pods=48, nodes=24,
                                                      seed=3)
    return ([n.to_dict() for n in nodes], [p.to_dict() for p in bound],
            [p.to_dict() for p in pending], 16, ns_labels)


def _mixed():
    nodes, pods = workloads.mixed_heterogeneous(pods=96, nodes=64, seed=1)
    return [n.to_dict() for n in nodes], [], [p.to_dict() for p in pods], 32, None


CASES = {"anti_affinity": _anti_affinity, "capacity_carry": _capacity_carry,
         "hard_spread": _hard_spread, "relational_mix": _relational,
         "mixed_heterogeneous": _mixed}


def _encode_both(node_dicts, bound_dicts, pending_dicts, batch, ns_labels,
                 pending_slots=False):
    """The same objects through each package's encoder, as
    ``scheduler_perf.run_workload`` encodes a drain: -> ((ref ct, ref
    batches, ref meta, ref encoder), (ct, batches, meta, encoder))."""
    out = []
    for enc, N, P in ((RefEncoder(), RefNode, RefPod),
                      (SnapshotEncoder(), Node, Pod)):
        if ns_labels:
            enc.set_namespaces(ns_labels)
        pending = [P.from_dict(d) for d in pending_dicts]
        ct, meta = enc.encode_cluster([N.from_dict(d) for d in node_dicts],
                                      [P.from_dict(d) for d in bound_dicts],
                                      pending_pods=pending,
                                      pending_slots=pending_slots)
        pbs = [enc.encode_pods(pending[i:i + batch], meta)
               for i in range(0, len(pending), batch)]
        out.append((ct, pbs, meta, enc))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_gang_drain_equals_reference(case):
    (rct, rpbs, rmeta, _), (ct, pbs, meta, _) = _encode_both(*CASES[case]())
    ref = ref_gang.gang_drain(rct, rpbs, topo_keys=rmeta.topo_keys)
    got = gang.gang_drain(ct, pbs, topo_keys=meta.topo_keys, device="cpu")
    for name, r, g in zip(("assignments", "rounds", "requested"), ref, got):
        r = np.asarray(r)
        assert r.dtype == g.dtype and np.array_equal(r, g), name
    assert (np.asarray(ref[0]) >= 0).sum() > 0


# a profile other than the default: the connected scheduler passes its
# profile's seed, fit strategy, weights, filters and round limit
PROFILE = dict(seed=4, fit_strategy="MostAllocated",
               weights={"NodeResourcesFit": 3.0, "InterPodAffinity": 0.0},
               enabled_filters={"NodeResourcesFit", "TaintToleration",
                                "PodTopologySpread"})


@pytest.mark.parametrize("max_rounds", [1, 64])
def test_gang_drain_profile_equals_reference(max_rounds):
    """A profile's seed, fit strategy, weights, filter subset and round
    limit reach every batch of the drain."""
    (rct, rpbs, rmeta, _), (ct, pbs, meta, _) = _encode_both(*_relational())
    ref = ref_gang.gang_drain(rct, rpbs, topo_keys=rmeta.topo_keys,
                              max_rounds=max_rounds, **PROFILE)
    got = gang.gang_drain(ct, pbs, topo_keys=meta.topo_keys, device="cpu",
                          max_rounds=max_rounds, **PROFILE)
    for name, r, g in zip(("assignments", "rounds", "requested"), ref, got):
        r = np.asarray(r)
        assert r.dtype == g.dtype and np.array_equal(r, g), name
    assert (np.asarray(ref[0]) >= 0).sum() > 0


def test_drain_step_profile_equals_reference():
    """drain_step takes the profile as the scheduler passes it (sorted
    tuples); assignments, rounds, new_fill and the folded context are
    bit-equal."""
    node_dicts, bound, pending, _, ns_labels = _relational()
    (rct, rpbs, rmeta, _), (ct, pbs, meta, _) = _encode_both(
        node_dicts, bound, pending[:16], 8, ns_labels, pending_slots=True)
    rctx, e0, rfill = ref_gang.build_drain_context(rct, rpbs, nom_bucket=8)
    ctx, _, fill = gang.build_drain_context(ct, pbs, nom_bucket=8,
                                            device="cpu")
    kw = dict(seed=PROFILE["seed"], fit_strategy=PROFILE["fit_strategy"],
              weights=tuple(sorted(PROFILE["weights"].items())),
              enabled_filters=tuple(sorted(PROFILE["enabled_filters"])),
              max_rounds=3)
    ra, rr, rctx, rfill = ref_gang.drain_step(
        rctx, _ref_stack(rpbs), rfill, e0=e0, topo_keys=rmeta.topo_keys, **kw)
    pa, pr, ctx, fill = gang.drain_step(
        ctx, gang.stack_batches(gang.unify_batches(pbs)), fill, e0=e0,
        topo_keys=meta.topo_keys, **kw)
    assert np.array_equal(np.asarray(ra), pa.numpy())
    assert np.array_equal(np.asarray(rr), pr.numpy())
    assert int(rfill) == int(fill) and (pa >= 0).any()
    _assert_same(_flat(rctx), _flat(ctx), "folded")


def test_gang_drain_sees_earlier_batches():
    """The cross-batch semantics of tests/test_gang_drain.py, on the port:
    anti-affinity spreads 8 pods over 8 nodes across two batches."""
    _, (ct, pbs, meta, _) = _encode_both(*_anti_affinity())
    a, rounds, _ = gang.gang_drain(ct, pbs, topo_keys=meta.topo_keys,
                                   device="cpu")
    placed = [int(x) for x in a.reshape(-1)]
    assert all(x >= 0 for x in placed) and len(set(placed)) == 8
    assert rounds.dtype == np.int32 and a.dtype == np.int32


def test_prepared_drain_is_reusable():
    """A prepared drain runs twice with the same result: gang_drain does
    not write into what prepare_drain staged."""
    _, (ct, pbs, meta, _) = _encode_both(*_relational())
    plan = gang.prepare_drain(ct, pbs, device="cpu")
    first = gang.gang_drain(topo_keys=meta.topo_keys, prepared=plan)
    second = gang.gang_drain(topo_keys=meta.topo_keys, prepared=plan)
    for a, b in zip(first, second):
        assert np.array_equal(a, b)


def _ref_stack(pbs):
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs),
                                  *ref_gang.unify_batches(pbs))


def test_two_drain_steps_equal_reference():
    """Two consecutive drain_steps from one build_drain_context: the
    assignments, rounds and new_fill of each, and every field of the
    folded context after each, are bit-equal. The cluster has bound pods
    (fill > 0), and the second drain takes fresh pods."""
    node_dicts, bound, pending, _, ns_labels = _relational()
    (rct, rpbs, rmeta, renc), (ct, pbs, meta, enc) = _encode_both(
        node_dicts, bound, pending[:16], 8, ns_labels, pending_slots=True)
    assert len(pbs) == 2
    rctx, e0, rfill = ref_gang.build_drain_context(rct, rpbs, nom_bucket=8)
    ctx, pe0, fill = gang.build_drain_context(ct, pbs, nom_bucket=8,
                                              device="cpu")
    assert (pe0, fill) == (e0, rfill) and rfill > 0
    _assert_same(_flat(rctx), _flat(ctx), "built")
    rnext = [RefPod.from_dict(d) for d in pending[16:32]]
    pnext = [Pod.from_dict(d) for d in pending[16:32]]
    second = ([renc.encode_pods(rnext[j:j + 8], rmeta, min_p=8)
               for j in (0, 8)],
              [enc.encode_pods(pnext[j:j + 8], meta, min_p=8)
               for j in (0, 8)])
    for i, (rb, pb) in enumerate([(rpbs, pbs), second]):
        rstack = ref_gang.pad_batch_to(_ref_stack(rb),
                                       ref_gang.batch_shapes(_ref_stack(rpbs)))
        pstack = gang.pad_batch_to(
            gang.stack_batches(gang.unify_batches(pb)),
            gang.batch_shapes(gang.stack_batches(gang.unify_batches(pbs))))
        assert rstack is not None and pstack is not None
        ra, rr, rctx, rfill = ref_gang.drain_step(
            rctx, rstack, rfill, e0=e0, topo_keys=rmeta.topo_keys, **KW)
        pa, pr, ctx, fill = gang.drain_step(
            ctx, pstack.to("cpu"), fill, e0=e0, topo_keys=meta.topo_keys,
            **KW)
        assert np.array_equal(np.asarray(ra), pa.numpy()), i
        assert np.array_equal(np.asarray(rr), pr.numpy()), i
        assert int(rfill) == int(fill) and fill.dtype == torch.int32, i
        assert pa.dtype == torch.int32 and (pa >= 0).any()
        _assert_same(_flat(rctx), _flat(ctx), f"folded[{i}]")


def test_build_drain_context_refuses_holes():
    """Base slots with a hole (a deleted pod's slot below the fill) give
    None on both sides: the fold would overwrite an occupied slot."""
    node_dicts, bound, pending, _, ns_labels = _relational()
    (rct, rpbs, _, _), (ct, pbs, _, _) = _encode_both(
        node_dicts, bound, pending[:16], 8, ns_labels, pending_slots=True)
    holed = np.asarray(rct.epod_valid).copy()
    assert holed[:3].all()
    holed[1] = False
    assert ref_gang.build_drain_context(
        rct.replace(epod_valid=holed), rpbs) is None
    assert gang.build_drain_context(
        ct.replace(epod_valid=holed), pbs, device="cpu") is None
    assert gang.build_drain_context(ct, pbs, device="cpu") is not None


def test_build_drain_context_copies_the_host_encoding():
    """The resident context shares no storage with the host encoding, so
    drain_step's in-place updates never reach the encoder's arrays."""
    node_dicts, bound, pending, _, ns_labels = _relational()
    _, (ct, pbs, meta, _) = _encode_both(node_dicts, bound, pending[:16], 8,
                                         ns_labels, pending_slots=True)
    before = _flat(ct)
    ctx, e0, fill = gang.build_drain_context(ct, pbs, device="cpu")
    stack = gang.stack_batches(gang.unify_batches(pbs))
    gang.drain_step(ctx, stack.to("cpu"), fill, e0=e0,
                    topo_keys=meta.topo_keys, **KW)
    _assert_same(before, _flat(ct), "host")


def test_pad_batch_to_equals_reference():
    """Recorded shapes pin a narrower batch; a leaf wider than its target
    gives None, on both sides."""
    node_dicts, bound, pending, _, ns_labels = _relational()
    (_, rpbs, _, _), (_, pbs, _, _) = _encode_both(
        node_dicts, bound, pending, 16, ns_labels)
    rwide, wide = _ref_stack(rpbs), gang.stack_batches(
        gang.unify_batches(pbs))
    rnarrow, narrow = _ref_stack(rpbs[:1]), gang.stack_batches(pbs[:1])
    assert gang.batch_shapes(wide) == ref_gang.batch_shapes(rwide)
    rpad = ref_gang.pad_batch_to(rnarrow, ref_gang.batch_shapes(rwide))
    pad = gang.pad_batch_to(narrow, gang.batch_shapes(wide))
    _assert_same(_flat(rpad), _flat(pad), "padded")
    shapes = gang.batch_shapes(narrow)
    assert gang.batch_shapes(gang.pad_batch_to(narrow, shapes)) == shapes
    if gang.batch_shapes(narrow) != gang.batch_shapes(wide):
        assert ref_gang.pad_batch_to(rwide,
                                     ref_gang.batch_shapes(rnarrow)) is None
        assert gang.pad_batch_to(wide, shapes) is None
    too_wide = [tuple(s[:-1]) + (s[-1] - 1,) if len(s) > 1 and s[-1] > 0
                else s for s in gang.batch_shapes(wide)]
    assert gang.pad_batch_to(wide, too_wide) is None
    assert ref_gang.pad_batch_to(rwide, too_wide) is None


@pytest.mark.parametrize("workload", ["relational_mix", "anti_affinity"])
def test_gang_schedule_keeps_the_trailing_slots(workload):
    """gang_schedule's rounds take the trailing P slots by default: the
    same as an explicit slot_start of E - P, and the reference's."""
    (rct, rpbs, rmeta, _), (ct, pbs, meta, _) = _encode_both(
        *CASES[workload](), pending_slots=True)
    ref_assign, ref_rounds = ref_gang.gang_schedule(
        rct, rpbs[0], topo_keys=rmeta.topo_keys)
    assign, rounds = gang.gang_schedule(
        from_reference(_flat(rct), "cpu"),
        from_reference(_flat(rpbs[0]), "cpu"), topo_keys=meta.topo_keys)
    assert np.array_equal(np.asarray(ref_assign), assign)
    assert rounds == ref_rounds
    pb = pbs[0].to("cpu")
    ct_ext = gang.extend_cluster(ct.to("cpu"), pb)
    P = int(pb.pod_valid.shape[0])
    st = gang._converge(ct_ext, pb, gang._new_state(ct_ext.requested, P,
                                                    "cpu"),
                        slot_start=int(ct_ext.epod_valid.shape[0]) - P,
                        topo_keys=meta.topo_keys, **KW)
    assert np.array_equal(st.assignment.numpy(), assign)
    assert st.rounds == rounds
