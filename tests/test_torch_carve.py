"""The port's slice carving against the JAX package's, on the CPU.

The same inputs go through both packages: nodes and pods built with the
reference's wrappers and parsed by the port from the same dicts, the
reference's cluster encoding carried across with
``encode/convert.from_reference``, host verdicts drawn from a seed.

- ``carve_step``/``carve_device``: ``fits``, ``cost``, ``node_grid`` and
  ``free_grid`` bit-equal (tolerance 0, dtypes included) and
  ``select_assignment``/``select_eviction`` equal, over the reference's
  fuzz generator (``tests/test_topology.py`` ``test_carve_parity_fuzz``,
  24 seeds) and over duplicate coordinates, non-numeric, negative,
  missing, out-of-range and huge coordinate labels, a tenant label,
  claimed cells, a shape no rotation fits, and encodings without the
  topology (and tenant) label columns; the port's oracle carver equal too;
- ``numpy_grids`` and the selection and coverage functions equal to the
  reference's on seeded host verdicts;
- the scheduler cases of ``tests/test_topology.py`` replayed on both
  packages: a contiguous bind (binder log, sentinel samples,
  ``topology_status()``), a failed carve's message, events and
  explanation, slice preemption (evictions, binder log, counters),
  ``_slice_chunks``, the oracle placing slice gangs first, the
  ``SliceCarve`` gate through the explainer, ``verify_carve_assignments``
  refuting tampering, the ``slice_contiguity`` invariant; the runner over a
  ``DirectClient`` (store bindings, the status ConfigMap's topology block);
  both runners' own loops with a gang that arrives whole (bound alike) or
  in fragments (each fragment fails its carve on the member count, alike);
  an oversize gang's pod bucket;
- no fallback hides the device: an error in the carve leaves ``run_once``
  (no oracle, no breaker count, the pods back in a queue), a
  ``KernelError``, ``ParityError`` or ``NotImplementedError`` there stops
  the runner;
- a gang whose members ask for their slice through slice-shaped
  ResourceClaims (DRA) is carved and bound as the reference does it.
"""

from __future__ import annotations

import dataclasses
import json
import random
import time

import jax
import numpy as np
import pytest
import torch

from kubernetes_tpu.audit import sentinel as ref_sentinel
from kubernetes_tpu.audit.auditor import InvariantAuditor as RefAuditor
from kubernetes_tpu.client import clientset as ref_clientset
from kubernetes_tpu.config import features as ref_features
from kubernetes_tpu.config import types as ref_config
from kubernetes_tpu.encode.snapshot import TENANT_KEY_ID, TENANT_LABEL
from kubernetes_tpu.encode.snapshot import SnapshotEncoder as RefEncoder
from kubernetes_tpu.sched import cache as ref_cache
from kubernetes_tpu.sched import explainer as ref_explainer
from kubernetes_tpu.sched import queue as ref_queue
from kubernetes_tpu.sched import runner as ref_runner
from kubernetes_tpu.sched import scheduler as ref_scheduler
from kubernetes_tpu.sched.oracle import OracleScheduler as RefOracle
from kubernetes_tpu.store import store as ref_store
from kubernetes_tpu.testing.wrappers import make_node, make_pod
from kubernetes_tpu.topology import carve as ref_carve
from kubernetes_tpu.topology.slicing import (GANG_LABEL, SLICE_SHAPE_LABEL,
                                             coords_of_labels, grid_dims,
                                             is_contiguous_slice, shape_str,
                                             topology_labels)
from kubernetes_tpu_torch.api import types as port_types
from kubernetes_tpu_torch.audit import sentinel as port_sentinel
from kubernetes_tpu_torch.audit.auditor import InvariantAuditor as PortAuditor
from kubernetes_tpu_torch.audit.sentinel import ParityError
from kubernetes_tpu_torch.client import clientset as port_clientset
from kubernetes_tpu_torch.config import features as port_features
from kubernetes_tpu_torch.config import types as port_config
from kubernetes_tpu_torch.encode.convert import from_reference
from kubernetes_tpu_torch.metrics import registry as port_registry
from kubernetes_tpu_torch.ops.kernels import KernelError
from kubernetes_tpu_torch.sched import cache as port_cache
from kubernetes_tpu_torch.sched import explainer as port_explainer
from kubernetes_tpu_torch.sched import queue as port_queue
from kubernetes_tpu_torch.sched import runner as port_runner
from kubernetes_tpu_torch.sched import scheduler as port_scheduler
from kubernetes_tpu_torch.sched.oracle import OracleScheduler as PortOracle
from kubernetes_tpu_torch.store import store as port_store
from kubernetes_tpu_torch.topology import carve as port_carve

LONG = 3600.0


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
    return np.asarray(x)


def _port_objs(objs, cls):
    return [cls.from_dict(o.to_dict()) for o in objs]


def _grid_node(name, x, y, z, cpu="4"):
    nb = make_node(name).capacity({"cpu": cpu, "memory": "8Gi",
                                   "pods": "16"})
    for k, v in topology_labels(x, y, z).items():
        nb = nb.label(k, v)
    return nb


def _grid_nodes(X, Y, Z, cpu="4"):
    return [_grid_node(f"n{x}{y}{z}", x, y, z, cpu=cpu).obj()
            for x in range(X) for y in range(Y) for z in range(Z)]


def _slice_gang(gang, shape, cpu="2", prio=0):
    want = shape[0] * shape[1] * shape[2]
    out = []
    for m in range(want):
        pb = (make_pod(f"{gang}-{m}").req({"cpu": cpu})
              .labels({GANG_LABEL: gang,
                       SLICE_SHAPE_LABEL: shape_str(shape)}))
        if prio:
            pb = pb.priority(prio)
        out.append(pb.obj())
    return out


# ---- carve_step / carve_device, bit-equal -------------------------------

def _assert_results_equal(ref, port):
    assert (ref is None) == (port is None)
    if ref is None:
        return
    for f in ("fits", "cost", "node_grid", "free_grid"):
        a, b = getattr(ref, f), getattr(port, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)  # tolerance 0
    assert (ref.rots, ref.dims, ref.shape) == (port.rots, port.dims,
                                               port.shape)
    assert ref_carve.select_assignment(ref) == \
        port_carve.select_assignment(port)
    assert ref_carve.select_eviction(ref) == port_carve.select_eviction(port)


def _carve_both(nodes, bound, gang, shape, dims=None, claimed=None,
                label_cols=None):
    """One encoding of the reference's, carried across; both carvers on
    it. -> (reference result, port result, port oracle result)."""
    gang = sorted(gang, key=lambda p: p.key)
    enc = RefEncoder()
    ct, meta = enc.encode_cluster(nodes, bound, pending_pods=gang)
    pb = enc.encode_pods(gang, meta)
    if label_cols is not None:
        ct = ct.replace(node_labels=np.asarray(ct.node_labels)[:, :label_cols])
    member_req = np.asarray(pb.requests)[:len(gang)].max(axis=0)
    pod_labels = np.asarray(pb.pod_labels)
    tenant = int(pod_labels[0, TENANT_KEY_ID])
    if dims is None:
        dims = grid_dims([c for c in (coords_of_labels(n.metadata.labels)
                                      for n in nodes) if c is not None])
    Nb = ct.node_valid.shape[0]
    if claimed is None:
        claimed = np.zeros(Nb, bool)
    ref = ref_carve.carve_device(ct, member_req, tenant, claimed, dims, shape)
    pct = from_reference(_flat(ct), "cpu")
    port = port_carve.carve_device(pct, member_req, tenant, claimed, dims,
                                   shape)
    orc = PortOracle(_port_objs(nodes, port_types.Node),
                     _port_objs(bound, port_types.Pod))
    orc._dims = dims
    ora = orc.oracle_carve(_port_objs(gang, port_types.Pod), shape,
                           {int(i) for i in np.flatnonzero(claimed)})
    return ref, port, ora


def _fuzz_case(seed):
    """The reference's fuzz generator (tests/test_topology.py
    test_carve_parity_fuzz): fragmented, wrap-around, rotated clusters
    with holes, unschedulable nodes and a node off the grid."""
    rng = random.Random(4000 + seed)
    X, Y, Z = rng.randint(2, 4), rng.randint(1, 3), rng.randint(1, 2)
    nodes, k = [], 0
    for x in range(X):
        for y in range(Y):
            for z in range(Z):
                if rng.random() < 0.15:
                    continue  # hole in the torus
                nb = _grid_node(f"n{k}", x, y, z,
                                cpu=rng.choice(["2", "4", "8"]))
                if rng.random() < 0.1:
                    nb = nb.unschedulable()
                nodes.append(nb.obj())
                k += 1
    if rng.random() < 0.5:  # a node with no coordinates at all
        nodes.append(make_node(f"n{k}").capacity(
            {"cpu": "4", "memory": "8Gi", "pods": "16"}).obj())
    names = [n.metadata.name for n in nodes]
    bound = []
    for i in range(rng.randint(0, 2 * len(nodes))):
        p = make_pod(f"b{i}").req(
            {"cpu": rng.choice(["500m", "1", "2", "3"])}).obj()
        p.spec.node_name = rng.choice(names)
        bound.append(p)
    shape = rng.choice([(1, 1, 1), (2, 1, 1), (1, 2, 1), (2, 2, 1),
                        (1, 2, 2), (3, 1, 1)])
    gang = _slice_gang("g", shape, cpu=rng.choice(["500m", "1", "2"]))
    return nodes, bound, gang, shape, rng


@pytest.mark.parametrize("seed", range(24))
def test_carve_step_matches_reference_fuzz(seed):
    nodes, bound, gang, shape, rng = _fuzz_case(seed)
    if not any(coords_of_labels(n.metadata.labels) for n in nodes):
        nodes.append(_grid_node("extra", 0, 0, 0).obj())
    ref, port, ora = _carve_both(nodes, bound, gang, shape)
    _assert_results_equal(ref, port)
    _assert_results_equal(ref, ora)
    # the same cluster with seeded claimed cells (earlier gangs' picks)
    enc = RefEncoder()
    ct, _m = enc.encode_cluster(nodes, bound, pending_pods=gang)
    Nb = ct.node_valid.shape[0]
    claimed = np.zeros(Nb, bool)
    claimed[:len(nodes)] = [rng.random() < 0.3 for _ in nodes]
    ref, port, ora = _carve_both(nodes, bound, gang, shape, claimed=claimed)
    _assert_results_equal(ref, port)
    _assert_results_equal(ref, ora)


def _labelled(name, labels, cpu="4"):
    nb = make_node(name).capacity({"cpu": cpu, "memory": "8Gi",
                                   "pods": "16"})
    for k, v in labels.items():
        nb = nb.label(k, v)
    return nb.obj()


def _odd_coordinate_nodes():
    """A 4x2x1 grid, two nodes on one cell (the higher index must win),
    and nodes whose labels the parse must put off the grid."""
    nodes = _grid_nodes(4, 2, 1)
    nodes.append(_grid_node("dup-a", 1, 1, 0).obj())
    nodes.append(_grid_node("dup-b", 1, 1, 0).obj())
    tx, ty, tz = (f"kubernetes-tpu.io/topology-{a}" for a in "xyz")
    nodes += [
        _labelled("nonnum", {tx: "abc", ty: "0", tz: "0"}),
        _labelled("negative", {tx: "-2", ty: "1", tz: "0"}),
        _labelled("missing-axis", {tx: "2", ty: "1"}),
        _labelled("beyond", {tx: "7", ty: "0", tz: "0"}),
        _labelled("huge", {tx: "99999999999", ty: "0", tz: "0"}),
        _labelled("bare", {}),
    ]
    return nodes


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 1, 1), (2, 2, 1),
                                   (4, 2, 1), (2, 2, 2)],
                         ids=lambda s: shape_str(s))
def test_carve_step_edge_coordinates(shape):
    nodes = _odd_coordinate_nodes()
    bound = []
    for i, nn in enumerate(["n000", "dup-b", "n310"]):
        p = make_pod(f"b{i}").req({"cpu": "3"}).obj()
        p.spec.node_name = nn
        bound.append(p)
    gang = _slice_gang("g", shape, cpu="2")
    # the grid as the 4x2x1 cells give it: "beyond" and "huge" are past it
    ref, port, ora = _carve_both(nodes, bound, gang, shape, dims=(4, 2, 1))
    _assert_results_equal(ref, port)
    _assert_results_equal(ref, ora)
    if ref is None:
        assert shape == (2, 2, 2)  # no rotation fits a 4x2x1 grid
        return
    names = [n.metadata.name for n in nodes]
    assert port.node_grid[1, 1, 0] == names.index("dup-b")  # max wins
    on_grid = {int(i) for i in port.node_grid.reshape(-1) if i >= 0}
    for off in ("nonnum", "negative", "missing-axis", "beyond", "huge",
                "bare", "dup-a", "n110"):
        assert names.index(off) not in on_grid


def test_carve_step_tenant_label():
    nodes = []
    for n in _grid_nodes(4, 2, 1):
        x = int(n.metadata.labels["kubernetes-tpu.io/topology-x"])
        n.metadata.labels[TENANT_LABEL] = "a" if x < 2 else "b"
        nodes.append(n)
    for tenant in ("a", "b"):
        gang = _slice_gang("g", (2, 2, 1))
        for p in gang:
            p.metadata.labels[TENANT_LABEL] = tenant
        ref, port, ora = _carve_both(nodes, [], gang, (2, 2, 1))
        _assert_results_equal(ref, port)
        _assert_results_equal(ref, ora)
        cells = {nodes[i].metadata.labels[TENANT_LABEL]
                 for i in port_carve.select_assignment(port)}
        assert cells == {tenant}


@pytest.mark.parametrize("label_cols", [3, 2])
def test_carve_step_without_label_columns(label_cols):
    """Encodings predating the topology (and tenant) label columns: no
    node is on the grid, on both sides."""
    nodes = _grid_nodes(2, 2, 1)
    ref, port, _ora = _carve_both(nodes, [], _slice_gang("g", (2, 1, 1)),
                                  (2, 1, 1), label_cols=label_cols)
    _assert_results_equal(ref, port)
    assert (port.node_grid == -1).all() and not port.fits.any()
    assert port_carve.select_eviction(port) is None


def test_carve_step_on_device_tensors_directly():
    """``carve_step`` itself (no read-back helper): the four planes equal
    the reference's on the same encoding."""
    nodes, bound, gang, shape, _rng = _fuzz_case(3)
    gang = sorted(gang, key=lambda p: p.key)
    enc = RefEncoder()
    ct, meta = enc.encode_cluster(nodes, bound, pending_pods=gang)
    pb = enc.encode_pods(gang, meta)
    member_req = np.asarray(pb.requests)[:len(gang)].max(axis=0)
    tenant = int(np.asarray(pb.pod_labels)[0, TENANT_KEY_ID])
    dims = grid_dims([c for c in (coords_of_labels(n.metadata.labels)
                                  for n in nodes) if c is not None])
    from kubernetes_tpu.topology.slicing import rotations
    rots = rotations(shape, dims)
    claimed = np.zeros(ct.node_valid.shape[0], bool)
    want = jax.device_get(ref_carve.carve_step(
        ct, jax.numpy.asarray(member_req), jax.numpy.int32(tenant),
        jax.numpy.asarray(claimed), dims=dims, rots=rots))
    got = port_carve.carve_step(from_reference(_flat(ct), "cpu"),
                                torch.from_numpy(member_req), tenant,
                                torch.from_numpy(claimed), dims, rots)
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert w.dtype == g.numpy().dtype
        np.testing.assert_array_equal(w, g.numpy())


# ---- numpy_grids, selection, coverage ------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_numpy_grids_and_selection_match_reference(seed):
    rng = np.random.default_rng(seed)
    dims = tuple(int(d) for d in rng.integers(1, 5, size=3))
    n = int(np.prod(dims)) + 3
    coords = []
    for _ in range(n):
        if rng.random() < 0.15:
            coords.append(None)
        else:
            coords.append(tuple(int(rng.integers(0, d + 1)) for d in dims))
    free = list(rng.random(n) < 0.6)
    evictable = [f or bool(rng.random() < 0.7) for f in free]
    n_pods = [int(v) for v in rng.integers(0, 4, size=n)]
    for shape in ((1, 1, 1), (2, 1, 1), (2, 2, 1), (1, 2, 3), (5, 1, 1)):
        ref = ref_carve.numpy_grids(coords, free, evictable, n_pods, dims,
                                    shape)
        port = port_carve.numpy_grids(coords, free, evictable, n_pods, dims,
                                      shape)
        _assert_results_equal(ref, port)
        assert ref_carve.covered_nodes(ref, n) == \
            port_carve.covered_nodes(port, n)
        assert ref_carve.coverage_stats(ref) == \
            port_carve.coverage_stats(port)


def test_selection_cases_of_the_reference():
    """tests/test_topology.py's wrap-around, rotation, cheapest-box and
    coverage cases through the port's functions."""
    coords = [(0, 0, 0), (1, 0, 0), (2, 0, 0), (3, 0, 0)]
    res = port_carve.numpy_grids(coords, [True, False, False, True],
                                 [True] * 4, [0, 1, 1, 0], (4, 1, 1),
                                 (2, 1, 1))
    assert port_carve.select_assignment(res) == [3, 0]
    coords2 = [(0, y, z) for y in range(2) for z in range(2)]
    res = port_carve.numpy_grids(coords2, [True] * 4, [True] * 4, [0] * 4,
                                 (1, 2, 2), (2, 2, 1))
    assert res.rots == ((1, 2, 2),)
    assert sorted(port_carve.select_assignment(res)) == [0, 1, 2, 3]
    res = port_carve.numpy_grids(coords, [False, False, False, True],
                                 [True] * 4, [2, 3, 1, 0], (4, 1, 1),
                                 (2, 1, 1))
    assert port_carve.select_eviction(res) == ([2, 3], [(2, 0, 0),
                                                        (3, 0, 0)], 1.0)
    res = port_carve.numpy_grids(coords, [True, True, False, False],
                                 [True] * 4, [0, 0, 1, 1], (4, 1, 1),
                                 (2, 1, 1))
    assert port_carve.covered_nodes(res, 4) == [True, True, False, False]
    assert port_carve.coverage_stats(res) == {"origins": 1,
                                              "fragmentationPct": 0.0}
    assert port_carve.coverage_stats(None) == {"origins": 0,
                                               "fragmentationPct": None}


# ---- the Scheduler, both packages ----------------------------------------

class _Recorder:
    def __init__(self):
        self.events = []

    def event(self, obj, type_, reason, message):
        self.events.append((obj.key, type_, reason, message))

    def flush(self):
        pass


def _no_ts(d):
    return None if d is None else {k: v for k, v in d.items() if k != "ts"}


def _sched_both(nodes, bound=(), batch_size=8):
    """(reference, port) Schedulers over the same nodes and bound pods, as
    tests/test_topology.py builds them (default configuration: the
    explainer on, the sentinel sampling)."""
    sides = []
    for pkg in ("ref", "port"):
        if pkg == "ref":
            cache, queue = ref_cache.SchedulerCache(), None
            objs_n, objs_b = nodes, bound
            queue = ref_queue.SchedulingQueue(backoff_initial=0.05)
            cfg = ref_config.SchedulerConfiguration(batch_size=batch_size)
            kw = {}
            smod = ref_scheduler
        else:
            cache = port_cache.SchedulerCache()
            objs_n = _port_objs(nodes, port_types.Node)
            objs_b = _port_objs(bound, port_types.Pod)
            queue = port_queue.SchedulingQueue(backoff_initial=0.05)
            cfg = port_config.SchedulerConfiguration(batch_size=batch_size)
            kw = {"device": "cpu"}
            smod = port_scheduler
        for n in objs_n:
            cache.add_node(n)
        for p in objs_b:
            cache.add_pod(p)
        log = []
        sched = smod.Scheduler(cfg, cache, queue,
                               lambda pod, node, log=log: log.append(
                                   (pod.metadata.name, node)) or True,
                               **kw)
        rec = _Recorder()
        sched.recorder = rec
        sides.append((sched, cache, queue, log, rec))
    return sides


def _drive(side, pods, rounds=4):
    sched, _cache, queue, _log, _rec = side
    for p in pods:
        queue.add(p)
    for _ in range(rounds):
        sched.run_once(wait=0.01)
    sched.wait_for_bindings()


def _drive_both(sides, pods, rounds=4):
    for side, ps in zip(sides, (pods, _port_objs(pods, port_types.Pod))):
        _drive(side, ps, rounds)


def _close(sides):
    for sched, _c, queue, _l, _r in sides:
        queue.close()
        sched.close()


def _fragmented_cluster():
    nodes = _grid_nodes(4, 4, 1)
    fillers = []
    for i, nn in enumerate(["n000", "n010", "n110", "n220", "n330"]):
        p = make_pod(f"filler{i}").req({"cpu": "3"}).obj()
        p.spec.node_name = nn
        fillers.append(p)
    return nodes, fillers


def test_gang_binds_contiguous_slice():
    nodes, fillers = _fragmented_cluster()
    sides = _sched_both(nodes, bound=fillers)
    try:
        for s in sides:
            s[0].sentinel.every = 1  # judge every carve
        _drive_both(sides, _slice_gang("g1", (2, 2, 1)))
        out = []
        for sched, _c, _q, log, _rec in sides:
            sched.sentinel.drain()
            with sched._carve_lock:
                stats = dict(sched._carve_stats)
            out.append((sorted(log), sched.sentinel.samples["carve"],
                        sched.sentinel.divergences, stats,
                        sched.topology_status()))
        assert out[1] == out[0]
        log, samples, div, stats, topo = out[1]
        assert len(log) == 4 and samples >= 1 and div == 0
        by_name = {n.metadata.name: n for n in nodes}
        placed = [coords_of_labels(by_name[nn].metadata.labels)
                  for _p, nn in log]
        assert is_contiguous_slice(placed, (2, 2, 1), (4, 4, 1)), placed
        assert topo["grid"] == "4x4x1" and topo["nodes"] == 16
        assert topo["carves"]["carved"] == 1 and "2x2x1" in topo["shapes"]
    finally:
        _close(sides)


def test_failed_carve_emits_origin_breakdown_and_explanation():
    nodes = _grid_nodes(2, 1, 1)
    fillers = []
    for i, n in enumerate(nodes):
        p = make_pod(f"filler{i}").req({"cpu": "3"}).obj()
        p.spec.node_name = n.metadata.name
        fillers.append(p)
    sides = _sched_both(nodes, bound=fillers)
    gang = _slice_gang("g1", (2, 1, 1))  # prio 0: no preemption
    try:
        _drive_both(sides, gang, rounds=1)
        out = []
        for sched, _c, _q, log, rec in sides:
            sched.explainer.drain()
            with sched._carve_lock:
                stats = dict(sched._carve_stats)
            out.append((log, sorted(rec.events),
                        {p.key: _no_ts(sched.explainer.explain_of(p.key))
                         for p in gang}, stats))
        assert out[1] == out[0]
        log, events, exps, stats = out[1]
        want = ("0/2 origins can host a 2x1x1 slice: 0 free cell(s) on the "
                "2x1x1 torus are too fragmented; freeing the cheapest "
                "origin costs 2 eviction(s)")
        assert log == []
        assert events and all(e[2:] == ("FailedScheduling", want)
                              for e in events)
        exp = exps[gang[0].key]
        assert exp["mode"] == "carve" and exp["message"] == want
        assert exp["filters"] == {"SliceCarve": 2}
        assert stats["failed"] >= 1
    finally:
        _close(sides)


def test_slice_preemption_evicts_contiguous_victim_set():
    nodes = _grid_nodes(2, 2, 1)
    victims = []
    for i, n in enumerate(nodes):
        p = make_pod(f"victim{i}").req({"cpu": "3"}).obj()
        p.spec.node_name = n.metadata.name
        victims.append(p)
    sides = _sched_both(nodes, bound=victims)
    evicted = ([], [])
    try:
        for (sched, _c, _q, _l, _r), ev in zip(sides, evicted):
            orig = sched._evict
            sched._evict = (lambda v, ev=ev, orig=orig:
                            ev.append(v.key) or orig(v))
        _drive_both(sides, _slice_gang("hi", (2, 2, 1), prio=100))
        out = []
        for (sched, cache, _q, log, rec), ev in zip(sides, evicted):
            with sched._carve_lock:
                stats = dict(sched._carve_stats)
            out.append((sorted(log), ev,
                        [cache.is_bound(v.key) for v in victims], stats,
                        sched.topology_status()))
        assert out[1] == out[0]
        log, ev, still, stats, _topo = out[1]
        assert not any(still) and sorted(ev) == sorted(v.key for v in victims)
        assert len(log) == 4 and stats["slicePreempts"] == 1
        by_name = {n.metadata.name: n for n in nodes}
        placed = [coords_of_labels(by_name[nn].metadata.labels)
                  for _p, nn in log]
        assert is_contiguous_slice(placed, (2, 2, 1), (2, 2, 1))
    finally:
        _close(sides)


def test_slice_fail_message_short_circuit_order():
    pod = make_pod("p").obj()
    plans = [
        {"res": None, "dims": (4, 4, 1), "shape": (2, 2, 1), "nodes": [],
         "members": [pod]},
        {"res": None, "dims": None, "shape": (2, 2, 1), "nodes": [],
         "members": [pod] * 4},
        {"res": None, "dims": (1, 1, 1), "shape": (2, 2, 1), "nodes": [],
         "members": [pod] * 4},
    ]
    for plan in plans:
        assert port_scheduler.Scheduler._slice_fail_message(plan) == \
            ref_scheduler.Scheduler._slice_fail_message(plan)


def test_slice_chunks_keep_gangs_whole():
    nodes = _grid_nodes(2, 2, 1)
    sides = _sched_both(nodes, batch_size=4)
    try:
        g1 = _slice_gang("a", (2, 1, 1))
        g2 = _slice_gang("b", (2, 1, 1))
        big = _slice_gang("c", (2, 2, 2))  # 8 > batch_size
        got = []
        for (sched, *_r), pods in zip(
                sides, (g1 + g2 + big,
                        _port_objs(g1 + g2 + big, port_types.Pod))):
            chunks = sched._slice_chunks([(p, 0) for p in pods])
            got.append([[p.metadata.name for p, _a in c] for c in chunks])
        assert got[1] == got[0]
        assert [len(c) for c in got[1]] == [4, 8]
    finally:
        _close(sides)


def test_oversize_gang_grows_the_pod_bucket():
    """A 512-member gang with batch_size 256 rides one chunk: the
    encoder grows the pod bucket past min_p, as the reference's does."""
    nodes = _grid_nodes(2, 2, 1)
    gang = _slice_gang("big", (8, 8, 8), cpu="100m")
    shapes = []
    for cmod, pods, ns in ((ref_cache, gang, nodes),
                           (port_cache, _port_objs(gang, port_types.Pod),
                            _port_objs(nodes, port_types.Node))):
        cache = cmod.SchedulerCache()
        for n in ns:
            cache.add_node(n)
        _n, _ct, meta = cache.snapshot(pending_pods=pods, slot_headroom=0)
        pb = cache.encode_pods(pods, meta, min_p=256)
        shapes.append(np.asarray(pb.pod_valid).shape)
    assert shapes[1] == shapes[0] and shapes[1][0] >= 512


def test_oracle_schedule_all_places_slice_first():
    nodes = _grid_nodes(2, 2, 1)
    gang = sorted(_slice_gang("g", (2, 2, 1)), key=lambda p: p.key)
    plain = make_pod("plain").req({"cpu": "1"}).obj()
    ref_out = RefOracle(nodes, []).schedule_all(gang + [plain])
    pn = _port_objs(nodes, port_types.Node)
    pg = _port_objs(gang + [plain], port_types.Pod)
    port_out = PortOracle(pn, []).schedule_all(pg)
    assert port_out == ref_out and all(ni is not None for ni in port_out)
    assert PortOracle(pn, []).plan_slices(pg[:4]) == \
        RefOracle(nodes, []).plan_slices(gang)


def test_oracle_slice_unavailable_reason_through_explainer():
    """Nodes outside every carveable placement report the SliceCarve
    pseudo-filter, on both packages' explainers."""
    nodes = [_grid_node("a", 0, 0, 0).obj(), _grid_node("b", 2, 0, 0).obj()]
    filler = make_pod("filler").req({"cpu": "4"}).obj()
    filler.spec.node_name = "a"
    pod = _slice_gang("g", (2, 1, 1))[0]
    got = []
    for cmod, emod, cfg_mod, conv, kw in (
            (ref_cache, ref_explainer, ref_config, lambda o, c: o, {}),
            (port_cache, port_explainer, port_config,
             lambda o, c: c.from_dict(o.to_dict()), {"device": "cpu"})):
        cache = cmod.SchedulerCache()
        for n in nodes:
            cache.add_node(conv(n, port_types.Node))
        cache.add_pod(conv(filler, port_types.Pod))
        rec = _Recorder()
        cfg = cfg_mod.SchedulerConfiguration()
        ex = emod.SchedulingExplainer(cfg, lambda rec=rec: rec, **kw)
        assert ex.submit(cache, cfg.profiles[0], "single",
                         [conv(pod, port_types.Pod)])
        ex.drain()
        got.append((_no_ts(ex.explain_of(pod.key)), rec.events))
        ex.close()
    assert got[1] == got[0]
    exp = got[1][0]
    assert exp["mode"] == "oracle" and exp["filters"] == {"SliceCarve": 2}


def test_verify_carve_assignments_refutes_tampering():
    nodes = _grid_nodes(2, 2, 1)
    gang = sorted(_slice_gang("g", (2, 1, 1)), key=lambda p: p.key)
    plans = RefOracle(nodes, []).plan_slices(gang, validate=False)
    good = {"g": plans["g"]}
    bad = {"g": {k: ("n110" if v != "n110" else "n000")
                 for k, v in plans["g"].items()}}
    pn, pg = _port_objs(nodes, port_types.Node), _port_objs(gang,
                                                            port_types.Pod)
    for asg in (good, bad):
        assert port_sentinel.verify_carve_assignments(pn, [], asg, pg) == \
            ref_sentinel.verify_carve_assignments(nodes, [], asg, gang)
    assert port_sentinel.verify_carve_assignments(pn, [], good, pg) == []
    problems = port_sentinel.verify_carve_assignments(pn, [], bad, pg)
    assert problems and "diverged" in problems[0]


def test_sentinel_carve_divergence_is_a_parity_error(tmp_path):
    """A refuted carve sample is the sentinel's fault: the scheduler
    raises it at its next pop."""
    nodes = _port_objs(_grid_nodes(2, 2, 1), port_types.Node)
    gang = _port_objs(_slice_gang("g", (2, 1, 1)), port_types.Pod)
    sentinel = port_sentinel.ParitySentinel(every=1,
                                            audit_dir=str(tmp_path))
    sentinel.maybe_submit_carve(nodes, [], {"g": {gang[0].key: "n110",
                                                  gang[1].key: "n000"}},
                                gang)
    sentinel.drain()
    sentinel.close()
    assert sentinel.samples["carve"] == 1 and sentinel.divergences == 1
    assert isinstance(sentinel.fault, ParityError)


def _store_with(cmod, smod, nodes, pods):
    store = smod.ObjectStore()
    client = cmod.DirectClient(store)
    for n in nodes:
        client.nodes().create(n.to_dict())
    for p in pods:
        client.pods().create(p.to_dict())
    return client


def test_slice_contiguity_invariant(tmp_path):
    nodes = _grid_nodes(4, 1, 1)

    def bound_gang(xs):
        pods = _slice_gang("g", (2, 1, 1), cpu="1")
        for p, x in zip(pods, xs):
            p.spec.node_name = f"n{x}00"
        return pods

    for xs, n_bad in (([0, 1], 0), ([0, 2], 1), ([3, 0], 0)):
        got = []
        for cmod, smod, amod in ((ref_clientset, ref_store, RefAuditor),
                                 (port_clientset, port_store, PortAuditor)):
            client = _store_with(cmod, smod, nodes, bound_gang(xs))
            auditor = amod(client=client, audit_dir=str(tmp_path))
            got.append([(v.invariant, v.detail) for v in auditor.run_once()
                        if v.invariant == "slice_contiguity"])
        assert got[1] == got[0] and len(got[1]) == n_bad


def test_runner_carves_like_the_reference():
    """Both runners over a DirectClient: a fragmented 4x4x1 grid, two
    slice gangs and a plain pod; the store's bindings equal, the port's
    status ConfigMap carries the topology block."""
    nodes, fillers = _fragmented_cluster()
    pending = (_slice_gang("ga", (2, 2, 1)) + _slice_gang("gb", (2, 1, 1))
               + [make_pod("plain").req({"cpu": "1"}).obj()])
    gate = ref_features.DEFAULT_FEATURE_GATE
    was = gate.enabled("PreemptionSimulation")
    gate.set_from_map({"PreemptionSimulation": False})
    out = []
    try:
        for pkg in ("ref", "port"):
            cmod, smod, cfg_mod = ((ref_clientset, ref_store, ref_config)
                                   if pkg == "ref" else
                                   (port_clientset, port_store, port_config))
            client = _store_with(cmod, smod, nodes, fillers + pending)
            cfg = cfg_mod.SchedulerConfiguration(
                batch_size=16, explainer_enabled=False,
                parity_sample_every=1, backoff_initial_s=LONG,
                backoff_max_s=LONG, assume_ttl_s=LONG, audit_interval_s=LONG)
            if pkg == "ref":
                runner = ref_runner.SchedulerRunner(client, cfg)
            else:
                pg = port_features.FeatureGate()
                pg.set_from_map({"PreemptionSimulation": False})
                runner = port_runner.SchedulerRunner(client, cfg,
                                                     feature_gate=pg,
                                                     device="cpu")
            try:
                runner.start(start_loop=False)
                deadline = time.time() + 30
                while runner.queue.stats()["active"] < len(pending):
                    assert time.time() < deadline, "informer sync"
                    time.sleep(0.01)
                sched = runner.scheduler
                for _ in range(8):
                    sched.run_once(wait=0.01)
                    sched.sentinel.drain(30.0)
                    if (runner.queue.stats()["active"] == 0
                            and not sched._pending):
                        break
                sched._resolve_pending()
                sched.wait_for_bindings()
                bindings = {p["metadata"]["name"]: p["spec"].get("nodeName")
                            for p in client.pods(None).list()}
                status = None
                if pkg == "port":
                    runner.publish_status()
                    cm = client.resource("configmaps",
                                         runner.status_namespace).get(
                        runner.status_name)
                    status = json.loads(cm["data"]["status"])["topology"]
                out.append((bindings, sched.topology_status(),
                            sched.sentinel.stats()["samples"]["carve"],
                            sched.sentinel.divergences, status))
            finally:
                runner.stop()
    finally:
        gate.set_from_map({"PreemptionSimulation": was})
    assert out[1][:4] == out[0][:4]
    bindings, topo, samples, div, status = out[1]
    assert all(bindings[p.metadata.name] for p in pending)
    assert samples >= 1 and div == 0
    assert status == topo and topo["carves"]["carved"] == 2


def _wait_until(cond, what, timeout=60.0):
    deadline = time.time() + timeout
    while not cond():
        assert time.time() < deadline, what
        time.sleep(0.01)


@pytest.mark.parametrize("arrival", ["whole", "split"])
def test_runner_loop_carves_a_gang_only_when_it_arrives_whole(arrival):
    """Both packages' own scheduling loops (``SchedulerRunner.start``),
    each fed by its informer from a ``DirectClient`` store: a 4x2x2 gang
    (16 members, batch_size 4) on an empty 4x4x2 grid.

    ``whole``: the gang is in the store before the loop starts, so one pop
    holds it; both loops bind it on the same cells. ``split``: member 0
    arrives first and the loop pops it alone, the 15 others once that
    carve has failed. Each fragment fails its carve on the member count
    ("gang has k member(s), the shape needs 16") and backs off as a
    whole-gang failure; nothing binds. The backoff here outlasts the test;
    at the default backoff the fragments retry out of step (ROADMAP
    Queue C, ``tests/torch_gang_fragment_probe.py``)."""
    nodes = _grid_nodes(4, 4, 2)
    gang = _slice_gang("g", (4, 2, 2), cpu="1")
    out = []
    for pkg in ("ref", "port"):
        cmod, smod, cfg_mod = ((ref_clientset, ref_store, ref_config)
                               if pkg == "ref" else
                               (port_clientset, port_store, port_config))
        client = _store_with(cmod, smod, nodes,
                             gang if arrival == "whole" else gang[:1])
        cfg = cfg_mod.SchedulerConfiguration(
            batch_size=4, explainer_enabled=False, parity_sample_every=1,
            backoff_initial_s=LONG, backoff_max_s=LONG, assume_ttl_s=LONG,
            audit_interval_s=LONG)
        runner = (ref_runner.SchedulerRunner(client, cfg) if pkg == "ref"
                  else port_runner.SchedulerRunner(client, cfg,
                                                   device="cpu"))
        sched = runner.scheduler
        rec = _Recorder()
        sched.recorder = rec
        queue = runner.queue

        def failed(sched=sched):
            with sched._carve_lock:
                return sched._carve_stats["failed"]

        def bindings(client=client):
            return {p["metadata"]["name"]: p["spec"].get("nodeName")
                    for p in client.pods(None).list()}

        try:
            runner.start()
            if arrival == "whole":
                _wait_until(lambda: all(bindings().values()),
                            f"{pkg}: the whole gang was not bound")
            else:
                _wait_until(lambda: failed() >= 1,
                            f"{pkg}: member 0 was not popped")
                for p in gang[1:]:
                    client.pods().create(p.to_dict())
                _wait_until(lambda: (queue.stats()["backoff"] == len(gang)
                                     and not queue.stats()["active"]),
                            f"{pkg}: the fragments did not all back off")
            sched.wait_for_bindings()
            sched.sentinel.drain(30.0)
            with sched._carve_lock:
                stats = dict(sched._carve_stats)
            out.append((bindings(), stats,
                        sorted(e for e in rec.events
                               if e[2] == "FailedScheduling"),
                        sched.sentinel.divergences))
        finally:
            runner.stop()
    assert out[1][0] == out[0][0]
    for binds, stats, events, divergences in out:
        assert divergences == 0
        if arrival == "whole":
            assert all(binds.values()) and not events
            assert stats == {"carved": 1, "failed": 0, "slicePreempts": 0}
            continue
        assert not any(binds.values()) and stats["carved"] == 0
        sizes = []
        for key, type_, _reason, msg in events:
            assert type_ == "Warning"
            k = int(msg.split("gang has ")[1].split(" ")[0])
            assert msg == (f"0/0 origins can host a 4x2x2 slice: gang has "
                           f"{k} member(s), the shape needs 16")
            sizes.append(k)
        # one event a member a failed pop: member 0 alone first, then the
        # other 15 in as many pops as their arrival took
        assert sorted(key for key, *_ in events) == sorted(
            p.key for p in gang) and sizes.count(1) >= 1
        assert stats["failed"] >= 2 and stats["slicePreempts"] == 0
    assert [e for e in out[1][2] if "gang has 1 " in e[3]][:1] == \
        [e for e in out[0][2] if "gang has 1 " in e[3]][:1]


# ---- no fallback hides the device ----------------------------------------

def _port_sched_on(nodes):
    cache = port_cache.SchedulerCache()
    for n in _port_objs(nodes, port_types.Node):
        cache.add_node(n)
    queue = port_queue.SchedulingQueue(backoff_initial=LONG,
                                       backoff_max=LONG)
    log = []
    sched = port_scheduler.Scheduler(
        port_config.SchedulerConfiguration(batch_size=8), cache, queue,
        lambda p, n: log.append((p.metadata.name, n)) or True, device="cpu")
    return sched, queue, log


@pytest.mark.parametrize("exc", [KernelError("carve did not launch"),
                                 ParityError("refuted"),
                                 NotImplementedError("item 11"),
                                 RuntimeError("device lost")],
                         ids=["kernel", "parity", "not_ported", "runtime"])
def test_carve_error_leaves_run_once(monkeypatch, exc):
    """A carve that fails on the device is not carved by the oracle or the
    numpy twin instead: the error leaves run_once, the breaker counts
    nothing, nothing binds, and the popped pods are back in a queue."""
    sched, queue, log = _port_sched_on(_grid_nodes(2, 2, 1))

    def broken(*a, **k):
        raise exc
    monkeypatch.setattr(port_carve, "carve_step", broken)
    oracle, twin = [], []
    monkeypatch.setattr(sched, "_schedule_oracle",
                        lambda *a: oracle.append(a) or 0)
    monkeypatch.setattr(port_carve, "numpy_grids",
                        lambda *a, **k: twin.append(a))
    errs = port_registry.LOOP_ERRORS
    base = errs.get({"site": "device_gang"})
    try:
        for p in _port_objs(_slice_gang("g", (2, 1, 1)), port_types.Pod):
            queue.add(p)
        with pytest.raises(type(exc)):
            sched.run_once(wait=0.01)
        assert not oracle and not twin and log == []
        assert sched.breaker.mode == "single" and sched.breaker.trips == 0
        assert errs.get({"site": "device_gang"}) == base
        assert sum(queue.stats().values()) == 2
    finally:
        queue.close()
        sched.close()


@pytest.mark.parametrize("exc", [KernelError("CUDA error 700"),
                                 ParityError("CUDA error 700"),
                                 NotImplementedError("CUDA error 700")],
                         ids=["kernel", "parity", "not_ported"])
def test_carve_fatal_error_stops_the_runner(monkeypatch, exc):
    """The runner's _FATAL errors raised in the carve end the loop for
    good: no revive, no oracle, nothing bound, and stop() raises them."""
    nodes = _grid_nodes(2, 2, 1)
    client = _store_with(port_clientset, port_store, nodes,
                         _slice_gang("g", (2, 1, 1)))
    pg = port_features.FeatureGate()
    pg.set_from_map({"PreemptionSimulation": False})
    runner = port_runner.SchedulerRunner(
        client, port_config.SchedulerConfiguration(
            batch_size=8, explainer_enabled=False, watchdog_interval_s=0.05,
            breaker_threshold=1, backoff_initial_s=LONG, backoff_max_s=LONG),
        feature_gate=pg, device="cpu")

    def broken(*a, **k):
        raise exc
    monkeypatch.setattr(port_carve, "carve_step", broken)
    oracle = []
    monkeypatch.setattr(runner.scheduler, "_schedule_oracle",
                        lambda *a: oracle.append(a) or 0)
    runner.start()
    try:
        deadline = time.time() + 30
        while runner.loop_error is None:
            assert time.time() < deadline, "the loop error"
            time.sleep(0.01)
        time.sleep(0.3)
        assert runner.loop_error is exc and not oracle
        assert not runner._loop_thread.is_alive()
        assert runner._watchdog.restarts == 0
        assert all(not p["spec"].get("nodeName")
                   for p in client.pods(None).list())
    finally:
        with pytest.raises(type(exc), match="CUDA error 700"):
            runner.stop()


def _tpu_slice_claim(name, shape="2x1x1"):
    return {"apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
            "metadata": {"name": name, "namespace": "default"},
            "spec": {"devices": {"requests": [
                {"name": "tpu", "deviceClassName": "tpu.google.com",
                 "sliceShape": shape}]}}}


def _tpu_topo_slice(node, coords):
    return {"apiVersion": "resource.k8s.io/v1", "kind": "ResourceSlice",
            "metadata": {"name": f"{node}-tpu"},
            "spec": {"nodeName": node, "devices": [{
                "name": "chip0", "deviceClassName": "tpu.google.com",
                "attributes": {a: {"int": c} for a, c in zip(
                    ("topology-x", "topology-y", "topology-z"), coords)}}]}}


def test_slice_pod_with_resource_claims_waits_for_dra():
    """DRA is ported: a gang whose members ask for their slice through a
    slice-shaped ResourceClaim (no slice-shape label) is carved and bound
    as the reference carves and binds it, one device a member from the
    nodes' slices, and the sentinel's carve sample (judged with the DRA
    catalog) agrees; the oracle takes a catalog."""
    nodes = _grid_nodes(2, 1, 1)
    gang = []
    for m in range(2):
        p = make_pod(f"g-{m}").req({"cpu": "2"}).labels(
            {GANG_LABEL: "g"}).obj()
        p.spec.resource_claims = [{"name": "tpu",
                                   "resourceClaimName": f"c{m}"}]
        gang.append(p)
    sides = _sched_both(nodes)
    try:
        for sched, cache, _q, _l, _r in sides:
            sched.sentinel.every = 1
            for n in nodes:
                cache.update_dra_object("ResourceSlice", _tpu_topo_slice(
                    n.metadata.name, coords_of_labels(n.metadata.labels)))
            for m in range(2):
                cache.update_dra_object("ResourceClaim",
                                        _tpu_slice_claim(f"c{m}"))
        _drive_both(sides, gang)
        out = []
        for sched, _c, _q, log, _rec in sides:
            sched.sentinel.drain()
            with sched._carve_lock:
                stats = dict(sched._carve_stats)
            out.append((sorted(log), sched.sentinel.samples["carve"],
                        sched.sentinel.divergences, stats))
        assert out[1] == out[0]
        log, samples, div, stats = out[1]
        assert sorted(n for _p, n in log) == ["n000", "n100"]
        assert samples >= 1 and div == 0 and stats["carved"] == 1
        assert PortOracle([], [], dra=sides[1][1].dra_catalog).dra \
            is sides[1][1].dra_catalog
    finally:
        _close(sides)
