"""The port's device-flag convergence against the JAX package, on the CPU.

``models/gang._converge`` runs the reference's static trip of cond-guarded
rounds in chunks of K masked rounds, with one host read of the progress
flag per chunk. Cutting the trip at a chunk edge must give the reference's
``gang_converge`` state exactly — assignments, rounds, ``requested``,
``committed`` and ``tried`` — for every K used here (1, 3, 8 and the round
limit), and ``drain_step`` / ``gang_drain`` over 1 to 3 batches must give
the reference's assignments, rounds, new fill and folded context. Cases:
progress that stops after the first round, the ``max_rounds`` cut, serial
mode (limit P) and the extender overlay (``ext_mask``/``ext_scores``,
seeded with numpy). The graph key (models/graphs.py) is checked too: equal
inputs give equal keys, and each static argument or shape that differs
gives another.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
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
from kubernetes_tpu_torch.models import gang, graphs
from kubernetes_tpu_torch.testing.workloads import relational_mix
from kubernetes_tpu_torch.testing.wrappers import make_node, make_pod

CHUNKS = (1, 3, 8, None)   # None: K = the round limit


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _flat(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _flat(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy().copy()
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


# ---- workloads ----------------------------------------------------------------

def _relational(seed=3, pods=40, nodes=24):
    n, b, p, ns = relational_mix(pods=pods, nodes=nodes, seed=seed)
    return ([x.to_dict() for x in n], [x.to_dict() for x in b],
            [x.to_dict() for x in p], ns)


def _mixed(seed=1):
    n, p = workloads.mixed_heterogeneous(pods=40, nodes=24, seed=seed)
    return [x.to_dict() for x in n], [], [x.to_dict() for x in p], None


def _one_round():
    """One pod that fits: round 1 commits it and round 2 makes no
    progress."""
    nodes = [make_node(f"n{i}").capacity({"cpu": "8", "memory": "8Gi",
                                          "pods": "20"}).obj().to_dict()
             for i in range(4)]
    pods = [make_pod("p0").req({"cpu": "100m"}).obj().to_dict()]
    return nodes, [], pods, None


def _none_fit():
    """No pod fits anywhere: the first round makes no progress."""
    nodes = [make_node(f"n{i}").capacity({"cpu": "1", "memory": "1Gi",
                                          "pods": "20"}).obj().to_dict()
             for i in range(4)]
    pods = [make_pod(f"p{i}").req({"cpu": "4"}).obj().to_dict()
            for i in range(6)]
    return nodes, [], pods, None


WORKLOADS = {"relational": _relational, "mixed": _mixed,
             "one_round": _one_round, "none_fit": _none_fit}

# case -> (workload, converge options); "rounds" pins what the case is for
CASES = {
    "relational": ("relational", {}),
    "mixed": ("mixed", {}),
    "one_round": ("one_round", {"rounds": 2}),
    "none_fit": ("none_fit", {"rounds": 1}),
    "max_rounds_cut": ("relational", {"max_rounds": 2, "rounds": 2}),
    "serial": ("relational", {"serial": True}),
    "extender": ("relational", {"ext": True}),
    "profile": ("mixed", {"seed": 4, "fit_strategy": "MostAllocated",
                          "weights": (("InterPodAffinity", 0.0),
                                      ("NodeResourcesFit", 3.0)),
                          "enabled_filters": ("NodeResourcesFit",
                                              "PodTopologySpread",
                                              "TaintToleration")}),
}


def _encode_ref(node_dicts, bound_dicts, pending_dicts, ns_labels):
    enc = RefEncoder()
    if ns_labels:
        enc.set_namespaces(ns_labels)
    pending = [RefPod.from_dict(d) for d in pending_dicts]
    ct, meta = enc.encode_cluster([RefNode.from_dict(d) for d in node_dicts],
                                  [RefPod.from_dict(d) for d in bound_dicts],
                                  pending_pods=pending)
    return ct, enc.encode_pods(pending, meta), meta


def _ext(pb, n_nodes, seed=11):
    rng = np.random.default_rng(seed)
    P = int(np.asarray(pb.pod_valid).shape[0])
    mask = rng.random((P, n_nodes)) > 0.3
    scores = rng.integers(0, 20, (P, n_nodes)).astype(np.float32)
    return mask, scores


def _opts(opts):
    limit_kw = {k: opts[k] for k in ("seed", "fit_strategy", "weights",
                                     "enabled_filters") if k in opts}
    return dict(dict(seed=0, fit_strategy="LeastAllocated", weights=(),
                     enabled_filters=()), **limit_kw)


@functools.lru_cache(maxsize=None)
def _reference(case):
    """(ref ct, ref pb, meta, ext, limit, the reference's final state)."""
    wl, opts = CASES[case]
    rct, rpb, meta = _encode_ref(*WORKLOADS[wl]())
    P = int(np.asarray(rpb.pod_valid).shape[0])
    N = int(np.asarray(rct.node_valid).shape[0])
    serial = opts.get("serial", False)
    limit = max(P if serial else opts.get("max_rounds", 64), 1)
    ext = _ext(rpb, N) if opts.get("ext") else (None, None)
    ct_ext = ref_gang.extend_cluster(rct, rpb)
    state = ref_gang.GangState(
        requested=jnp.asarray(rct.requested),
        committed=jnp.zeros(P, bool),
        assignment=jnp.full(P, -1, jnp.int32),
        tried=jnp.zeros(P, bool),
        rounds=jnp.zeros((), jnp.int32))
    ref = ref_gang.gang_converge(
        ct_ext, rpb, state, topo_keys=meta.topo_keys, serial=serial,
        max_rounds=limit, ext_mask=ext[0], ext_scores=ext[1], **_opts(opts))
    return rct, rpb, meta, ext, limit, _flat(jax.device_get(ref))


@pytest.mark.parametrize("chunk", CHUNKS, ids=lambda k: f"K{k or 'max'}")
@pytest.mark.parametrize("case", sorted(CASES))
def test_converge_equals_reference(case, chunk, monkeypatch):
    rct, rpb, meta, ext, limit, ref = _reference(case)
    monkeypatch.setattr(gang, "CPU_CHUNK", chunk or limit)
    wl, opts = CASES[case]
    ct = from_reference(_flat(rct), "cpu")
    pb = from_reference(_flat(rpb), "cpu")
    ct_ext = gang.extend_cluster(ct, pb)
    P = int(pb.pod_valid.shape[0])
    reads0 = graphs.HOST_READS
    st = gang._converge(
        ct_ext, pb, gang._new_state(ct.requested, P, "cpu"),
        topo_keys=meta.topo_keys, serial=opts.get("serial", False),
        max_rounds=limit,
        ext_mask=None if ext[0] is None else torch.from_numpy(ext[0]),
        ext_scores=None if ext[1] is None else torch.from_numpy(ext[1]),
        **_opts(opts))
    _assert_same(ref, _flat(st), case)
    rounds = int(ref["rounds"])
    if "rounds" in opts:
        assert rounds == opts["rounds"]
    # the host reads the progress flag at most once per chunk
    K = max(1, min(chunk or limit, limit))
    assert graphs.HOST_READS - reads0 <= -(-rounds // K)
    assert st.rounds.dtype == torch.int32 and st.rounds.dim() == 0


def test_dead_round_leaves_the_state():
    """A trip after a round without progress changes nothing, ``rounds``
    included, as the reference's cond leaves its carry."""
    rct, rpb, meta, _, limit, _ = _reference("relational")
    ct = from_reference(_flat(rct), "cpu")
    pb = from_reference(_flat(rpb), "cpu")
    ct_ext = gang.extend_cluster(ct, pb)
    P = int(pb.pod_valid.shape[0])
    st0 = gang._new_state(ct.requested, P, "cpu")
    kw = dict(seed=0, fit_strategy="LeastAllocated",
              topo_keys=meta.topo_keys, serial=False, weights=(),
              enabled_filters=(), slot_start=int(ct_ext.epod_valid.shape[0])
              - P, ext_mask=None, ext_scores=None)
    live, n1 = gang._masked_round(ct_ext, pb, st0, torch.tensor(1), limit, kw)
    assert int(live.rounds) == 1 and int(n1) > 0
    for n, lim in ((torch.tensor(0), limit), (n1, 1)):
        dead, n2 = gang._masked_round(ct_ext, pb, live, n, lim, kw)
        _assert_same(_flat(live), _flat(dead), "dead")
        assert int(n2) == 0


# ---- drains of 1 to 3 batches -------------------------------------------------

def _encode_both(node_dicts, bound_dicts, pending_dicts, batch, ns_labels):
    out = []
    for enc, N, P in ((RefEncoder(), RefNode, RefPod),
                      (SnapshotEncoder(), Node, Pod)):
        if ns_labels:
            enc.set_namespaces(ns_labels)
        pending = [P.from_dict(d) for d in pending_dicts]
        ct, meta = enc.encode_cluster([N.from_dict(d) for d in node_dicts],
                                      [P.from_dict(d) for d in bound_dicts],
                                      pending_pods=pending,
                                      pending_slots=True)
        pbs = [enc.encode_pods(pending[i:i + batch], meta, min_p=batch)
               for i in range(0, len(pending), batch)]
        out.append((ct, pbs, meta))
    return out


@functools.lru_cache(maxsize=None)
def _drain_reference(B):
    node_dicts, bound, pending, ns = _relational(seed=5, pods=8 * B + 16)
    (rct, rpbs, rmeta), (ct, pbs, meta) = _encode_both(
        node_dicts, bound, pending[:8 * B], 8, ns)
    assert len(pbs) == B
    rctx, e0, rfill = ref_gang.build_drain_context(rct, rpbs, nom_bucket=8)
    rstack = jax.tree_util.tree_map(lambda *xs: np.stack(xs),
                                    *ref_gang.unify_batches(rpbs))
    ra, rr, rctx, rfill = ref_gang.drain_step(
        rctx, rstack, rfill, e0=e0, topo_keys=rmeta.topo_keys, seed=0,
        fit_strategy="LeastAllocated", weights=(), enabled_filters=(),
        max_rounds=64)
    drained = ref_gang.gang_drain(rct, rpbs, topo_keys=rmeta.topo_keys)
    return ((np.asarray(ra), np.asarray(rr), int(rfill), _flat(rctx)),
            tuple(np.asarray(x) for x in drained), (ct, pbs, meta))


@pytest.mark.parametrize("chunk", CHUNKS, ids=lambda k: f"K{k or 'max'}")
@pytest.mark.parametrize("B", [1, 2, 3])
def test_drain_step_equals_reference(B, chunk, monkeypatch):
    (ra, rr, rfill, rctx), _, (ct, pbs, meta) = _drain_reference(B)
    monkeypatch.setattr(gang, "CPU_CHUNK", chunk or 64)
    ctx, e0, fill = gang.build_drain_context(ct, pbs, nom_bucket=8,
                                             device="cpu")
    pa, pr, ctx, new_fill = gang.drain_step(
        ctx, gang.stack_batches(gang.unify_batches(pbs)), fill, e0=e0,
        topo_keys=meta.topo_keys)
    assert np.array_equal(ra, pa.numpy()) and np.array_equal(rr, pr.numpy())
    assert pr.dtype == torch.int32 and pr.shape == (B,)
    assert rfill == int(new_fill) and (pa >= 0).any()
    _assert_same(rctx, _flat(ctx), "folded")


@pytest.mark.parametrize("chunk", CHUNKS, ids=lambda k: f"K{k or 'max'}")
@pytest.mark.parametrize("B", [1, 2, 3])
def test_gang_drain_equals_reference(B, chunk, monkeypatch):
    _, ref, (ct, pbs, meta) = _drain_reference(B)
    monkeypatch.setattr(gang, "CPU_CHUNK", chunk or 64)
    got = gang.gang_drain(ct, pbs, topo_keys=meta.topo_keys, device="cpu")
    for name, r, g in zip(("assignments", "rounds", "requested"), ref, got):
        assert r.dtype == g.dtype and np.array_equal(r, g), name


# ---- the graph key --------------------------------------------------------------

def _key_inputs():
    rct, rpb, meta, _, _, _ = _reference("relational")
    ct = from_reference(_flat(rct), "cpu")
    pb = from_reference(_flat(rpb), "cpu")
    ct_ext = gang.extend_cluster(ct, pb)
    P = int(pb.pod_valid.shape[0])
    return ct, pb, ct_ext, gang._new_state(ct.requested, P, "cpu"), meta


def _key(ct_ext, pb, st, **over):
    kw = dict(limit=64, chunk=8, slot_start=10, ext_mask=None,
              ext_scores=None, seed=0, fit_strategy="LeastAllocated",
              topo_keys=(1, 2), serial=False, weights=(),
              enabled_filters=())
    kw.update(over)
    return gang.converge_key(ct_ext, pb, st, **kw)


def test_graph_key_equal_inputs_equal_keys():
    ct, pb, ct_ext, st, _ = _key_inputs()
    assert _key(ct_ext, pb, st) == _key(ct_ext, pb, st)
    assert hash(_key(ct_ext, pb, st)) == hash(_key(ct_ext, pb, st))


@pytest.mark.parametrize("change", [
    {"seed": 1}, {"fit_strategy": "MostAllocated"}, {"topo_keys": (1,)},
    {"serial": True}, {"weights": (("NodeResourcesFit", 2.0),)},
    {"enabled_filters": ("NodeResourcesFit",)}, {"slot_start": 11},
    {"limit": 32}, {"chunk": 4}, {"ext_mask": "given"},
    {"ext_scores": "given"}], ids=lambda c: next(iter(c)))
def test_graph_key_each_static_argument_differs(change):
    ct, pb, ct_ext, st, _ = _key_inputs()
    N = int(ct.node_valid.shape[0])
    P = int(pb.pod_valid.shape[0])
    given = {"ext_mask": torch.ones((P, N), dtype=torch.bool),
             "ext_scores": torch.zeros((P, N))}
    change = {k: given[k] if v == "given" else v for k, v in change.items()}
    assert _key(ct_ext, pb, st) != _key(ct_ext, pb, st, **change)


def test_graph_key_shapes_and_addresses_differ():
    ct, pb, ct_ext, st, _ = _key_inputs()
    base = _key(ct_ext, pb, st)
    # another batch width: every pod leaf changes shape
    narrow = gang._tree_map(lambda x: x[:-1], pb)
    assert _key(ct_ext, narrow, st) != base
    # the same values at other addresses (a rebuilt context)
    moved = gang._tree_map(lambda x: x.clone(), ct_ext)
    assert _key(moved, pb, st) != base
    # the same tensors again: equal
    same = gang._tree_map(lambda x: x, ct_ext)
    assert _key(same, pb, st) == base
    # the carried state is copied into the graph's buffers: another
    # state of the same layout is the same key, another width is not
    fresh = gang._new_state(ct.requested.clone(), int(st.committed.shape[0]),
                            "cpu")
    assert _key(ct_ext, pb, fresh) == base
    wide = gang._new_state(ct.requested, int(st.committed.shape[0]) + 1,
                           "cpu")
    assert _key(ct_ext, pb, wide) != base


def test_adopt_storage_keeps_the_addresses():
    """A rebuilt context of the same shapes is written into the old one's
    tensors, so the graphs keyed on them stay valid; another shape is
    taken as it is."""
    ct, pb, ct_ext, st, _ = _key_inputs()
    old = gang._tree_map(lambda x: x.clone(), ct_ext)
    new = gang._tree_map(lambda x: x.clone(), ct_ext)
    new.epod_valid[0] = ~new.epod_valid[0]
    out = gang.adopt_storage(old, new)
    assert out is old and bool(out.epod_valid[0]) == bool(new.epod_valid[0])
    assert gang.adopt_storage(None, new) is new
    wider = new.replace(epod_valid=torch.cat([new.epod_valid,
                                              new.epod_valid[:1]]))
    assert gang.adopt_storage(old, wider) is wider
