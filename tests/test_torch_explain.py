"""The port's scheduling explainer against the JAX package's, on the CPU.

The same nodes and pods (built with the reference's wrappers or its fuzz
generators from a seed, parsed by each package from the same dicts) go
through both packages:

- ``explain_step``: verdicts [F,P,N], ``valid`` and ``first_fail``
  bit-equal to the reference's, and the port's first-fail verdicts equal to
  the port's numpy oracle, on every fixture of ``tests/test_explainer.py``
  and its fuzz; the histograms and ``failed_scheduling_message`` strings
  string-equal;
- ``SchedulingExplainer``: the thread's verdict at level single (tensor)
  and oracle (oracle), the throttle, a full backlog, a cluster that became
  feasible, the oracle's unjudged nodes, the scheduler's failure path and
  the score breakdown — equal explanation dicts (``ts`` apart), events and
  stats;
- no fallback hides the device: a failing tensor judge is counted
  (``LOOP_ERRORS{site=device_explain}``) and its pod gets the generic
  event and no verdict (the oracle is not run); a ``KernelError``,
  ``ParityError`` or
  ``NotImplementedError`` there gets no verdict and is raised by the
  scheduler's next pop;
- the runner end to end over the port's HTTP ``APIServer``: the
  ``scheduler-explanations`` ConfigMap and the ``FailedScheduling`` event
  carry the reference's message for a pod no tainted node takes.
"""

from __future__ import annotations

import json
import random
import time

import jax
import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as ref_types
from kubernetes_tpu.config import types as ref_config
from kubernetes_tpu.encode.snapshot import SnapshotEncoder as RefEncoder
from kubernetes_tpu.models import explain as ref_explain
from kubernetes_tpu.sched import cache as ref_cache
from kubernetes_tpu.sched import explainer as ref_explainer_mod
from kubernetes_tpu.sched import queue as ref_queue
from kubernetes_tpu.sched import scheduler as ref_scheduler
from kubernetes_tpu.testing.wrappers import make_node, make_pod
from kubernetes_tpu_torch.api import types as port_types
from kubernetes_tpu_torch.audit.sentinel import ParityError
from kubernetes_tpu_torch.config import types as port_config
from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder as PortEncoder
from kubernetes_tpu_torch.metrics import registry as port_registry
from kubernetes_tpu_torch.models import explain as port_explain
from kubernetes_tpu_torch.ops.kernels import KernelError
from kubernetes_tpu_torch.sched import cache as port_cache
from kubernetes_tpu_torch.sched import explainer as port_explainer_mod
from kubernetes_tpu_torch.sched import queue as port_queue
from kubernetes_tpu_torch.sched import scheduler as port_scheduler
from kubernetes_tpu_torch.sched.oracle import OracleScheduler as PortOracle

from test_filters_parity import random_node, random_pod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port(objs, cls):
    """Reference objects -> the port's, through the same dicts."""
    return [cls.from_dict(o.to_dict()) for o in objs]


# ------------------------------------------------------------ explain_step

def _ref_run(nodes, pods, bound, enabled):
    enc = RefEncoder()
    ct, meta = enc.encode_cluster(nodes, bound or [], pending_pods=pods)
    pb = enc.encode_pods(pods, meta)
    v, valid = jax.device_get(ref_explain.explain_step(
        ct, pb, topo_keys=meta.topo_keys, enabled=enabled))
    return np.asarray(v), np.asarray(valid)


def _port_run(nodes, pods, bound, enabled):
    enc = PortEncoder()
    ct, meta = enc.encode_cluster(nodes, bound or [], pending_pods=pods)
    pb = enc.encode_pods(pods, meta)
    v, valid = port_explain.explain_step(ct.to("cpu"), pb.to("cpu"),
                                         topo_keys=meta.topo_keys,
                                         enabled=enabled)
    return v.numpy(), valid.numpy()


def assert_explain_parity(nodes, pods, bound=None, enabled=None):
    """Verdicts, valid and first_fail bit-equal to the reference; every
    row's histogram and message string-equal; the port's first-fail
    verdict equal to the port's oracle (all filters enabled). -> the
    port's first_fail [P,N] over the real pods and nodes."""
    bound = bound or []
    pn, pp, pbnd = (_port(nodes, port_types.Node), _port(pods, port_types.Pod),
                    _port(bound, port_types.Pod))
    rv, rvalid = _ref_run(nodes, pods, bound, enabled)
    tv, tvalid = _port_run(pn, pp, pbnd, enabled)
    assert port_explain.EXPLAIN_FILTERS == ref_explain.EXPLAIN_FILTERS
    np.testing.assert_array_equal(tv, rv)
    np.testing.assert_array_equal(tvalid, rvalid)
    rff = ref_explain.first_fail(rv, rvalid)
    tff = port_explain.first_fail(tv, tvalid)
    np.testing.assert_array_equal(tff, rff)
    tff = tff[:len(pods), :len(nodes)]
    for row in tff:
        hist = port_explain.reject_histogram(row)
        assert hist == ref_explain.reject_histogram(row)
        feasible = int((row == -1).sum())
        assert (port_explain.failed_scheduling_message(len(nodes), hist,
                                                       feasible)
                == ref_explain.failed_scheduling_message(len(nodes), hist,
                                                         feasible))
    if enabled is None:
        orc = PortOracle(pn, pbnd)
        for pi, pod in enumerate(pp):
            mask, reasons = orc.feasible(pod)
            for ni, node in enumerate(pn):
                got = tff[pi, ni]
                if mask[ni]:
                    assert got == -1, (pod.key, node.metadata.name)
                else:
                    want = port_explain.REASON_TO_FILTER[
                        reasons[node.metadata.name]]
                    assert port_explain.EXPLAIN_FILTERS[got] == want, (
                        pod.key, node.metadata.name)
    return tff


def test_first_fail_order_matches_oracle_short_circuit():
    nodes = [make_node("bad").capacity({"cpu": "1", "pods": "10"})
             .taint("dedicated", "ml", "NoSchedule").unschedulable().obj()]
    pods = [make_pod("p0").req({"cpu": "4"}).obj()]
    ff = assert_explain_parity(nodes, pods)
    assert port_explain.EXPLAIN_FILTERS[ff[0, 0]] == "NodeUnschedulable"


def test_taint_and_resources_histogram():
    nodes = [make_node("t0").capacity({"cpu": "8", "pods": "10"})
             .taint("dedicated", "ml", "NoSchedule").obj(),
             make_node("t1").capacity({"cpu": "8", "pods": "10"})
             .taint("dedicated", "ml", "NoSchedule").obj(),
             make_node("small").capacity({"cpu": "1", "pods": "10"}).obj()]
    pods = [make_pod("p0").req({"cpu": "4"}).obj()]
    ff = assert_explain_parity(nodes, pods)
    hist = port_explain.reject_histogram(ff[0])
    assert hist == {"TaintToleration": 2, "NodeResourcesFit": 1}
    assert port_explain.failed_scheduling_message(len(nodes), hist) == (
        "0/3 nodes are available: 2 node(s) had untolerated taint, "
        "1 Insufficient resources.")


@pytest.mark.parametrize("n_nodes,hist,feasible,unjudged", [
    (9, {"NodeResourcesFit": 2, "TaintToleration": 2, "NodeAffinity": 5},
     0, 0),
    (3, {"NodeName": 2}, 1, 0),
    (0, {}, 0, 0),
    (4, {}, 0, 0),
    (2, {"SliceCarve": 2}, 0, 0),
    (5, {"TaintToleration": 1}, 2, 2),
])
def test_message_counts_and_tiebreak_order(n_nodes, hist, feasible,
                                           unjudged):
    got = port_explain.failed_scheduling_message(n_nodes, hist, feasible,
                                                 unjudged)
    assert got == ref_explain.failed_scheduling_message(
        n_nodes, hist, feasible, unjudged)


def test_message_tables_equal():
    assert port_explain.FILTER_MESSAGES == ref_explain.FILTER_MESSAGES
    assert port_explain.REASON_TO_FILTER == ref_explain.REASON_TO_FILTER


def test_relational_filters_explained():
    nodes = [make_node("za").capacity({"cpu": "8", "pods": "10"})
             .label("zone", "a").obj(),
             make_node("zb").capacity({"cpu": "8", "pods": "10"})
             .label("zone", "b").obj()]
    bound = [make_pod(f"b{i}").label("app", "web").node("za").obj()
             for i in range(2)]
    pod = (make_pod("p0").label("app", "web")
           .spread(1, "zone", "DoNotSchedule", {"app": "web"}).obj())
    ff = assert_explain_parity(nodes, [pod], bound)
    assert port_explain.EXPLAIN_FILTERS[ff[0, 0]] == "PodTopologySpread"
    assert ff[0, 1] == -1
    anti = (make_pod("anti").label("app", "db")
            .pod_affinity("zone", {"app": "db"}, anti=True).obj())
    bound2 = [make_pod("b-db").label("app", "db").node("za").obj()]
    ff2 = assert_explain_parity(nodes, [anti], bound2)
    assert port_explain.EXPLAIN_FILTERS[ff2[0, 0]] == "InterPodAffinity"


def test_disabled_filters_pass_everywhere():
    nodes = [make_node("t0").capacity({"cpu": "8", "pods": "10"})
             .taint("dedicated", "ml", "NoSchedule").obj()]
    pods = [make_pod("p0").req({"cpu": "1"}).obj()]
    enabled = tuple(sorted(set(port_explain.EXPLAIN_FILTERS)
                           - {"TaintToleration"}))
    ff = assert_explain_parity(nodes, pods, enabled=enabled)
    assert ff[0, 0] == -1


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_explain_parity(seed):
    """``tests/test_explainer.py``'s randomized clusters (same seeds)."""
    rng = random.Random(1000 + seed)
    n_nodes = rng.randint(1, 12)
    n_bound = rng.randint(0, 8)
    n_pods = rng.randint(1, 10)
    nodes = [random_node(rng, i) for i in range(n_nodes)]
    names = [n.metadata.name for n in nodes]
    bound = []
    for i in range(n_bound):
        p = random_pod(rng, 100 + i, names)
        p.spec.node_name = rng.choice(names)
        bound.append(p)
    pods = [random_pod(rng, i, names) for i in range(n_pods)]
    assert_explain_parity(nodes, pods, bound)


def test_relational_mix_explain_parity():
    """The port's own relational generator: every filter and relational
    path, a second namespace, padded pod and node buckets."""
    from kubernetes_tpu_torch.testing.workloads import relational_mix
    nodes, bound, pending, ns_labels = relational_mix(pods=24, nodes=12,
                                                      bound=12, seed=3)
    ref_nodes = [ref_types.Node.from_dict(n.to_dict()) for n in nodes]
    ref_bound = [ref_types.Pod.from_dict(p.to_dict()) for p in bound]
    ref_pods = [ref_types.Pod.from_dict(p.to_dict()) for p in pending]
    r = RefEncoder()
    r.set_namespaces(ns_labels)
    ct, meta = r.encode_cluster(ref_nodes, ref_bound, pending_pods=ref_pods)
    pb = r.encode_pods(ref_pods, meta)
    rv, rvalid = (np.asarray(x) for x in jax.device_get(
        ref_explain.explain_step(ct, pb, topo_keys=meta.topo_keys)))
    t = PortEncoder()
    t.set_namespaces(ns_labels)
    ct, meta = t.encode_cluster(nodes, bound, pending_pods=pending)
    pb = t.encode_pods(pending, meta)
    tv, tvalid = port_explain.explain_step(ct.to("cpu"), pb.to("cpu"),
                                           topo_keys=meta.topo_keys)
    np.testing.assert_array_equal(tv.numpy(), rv)
    np.testing.assert_array_equal(tvalid.numpy(), rvalid)
    ff = port_explain.first_fail(tv.numpy(), tvalid.numpy())
    assert (ff[:len(pending), :len(nodes)] >= 0).any()


# ---------------------------------------------- explainer (threaded), both

class _Recorder:
    def __init__(self):
        self.events = []

    def event(self, obj, type_, reason, message):
        self.events.append((obj.key, type_, reason, message))


def _caches(nodes, bound=()):
    """(reference cache, port cache) over the same nodes and bound pods."""
    rc, pc = ref_cache.SchedulerCache(), port_cache.SchedulerCache()
    for n in nodes:
        rc.update_node(n)
        pc.update_node(port_types.Node.from_dict(n.to_dict()))
    for p in bound:
        rc.add_pod(p)
        pc.add_pod(port_types.Pod.from_dict(p.to_dict()))
    return rc, pc


def _explainers(profiles=None):
    """(reference, port) explainers over equal configurations, each with
    its own recorder and publisher log."""
    out = []
    for cfg_mod, mod, kw in ((ref_config, ref_explainer_mod, {}),
                             (port_config, port_explainer_mod,
                              {"device": "cpu"})):
        cfg = (cfg_mod.SchedulerConfiguration(profiles=profiles(cfg_mod))
               if profiles else cfg_mod.SchedulerConfiguration())
        rec = _Recorder()
        ex = mod.SchedulingExplainer(cfg, lambda rec=rec: rec, **kw)
        published = []
        ex.publisher = published.append
        out.append((cfg, ex, rec, published))
    return out


def _no_ts(d):
    return {k: v for k, v in d.items() if k != "ts"}


def _submit_both(nodes, pod, level, bound=(), profiles=None):
    """Submit one pod to both explainers, drain them. -> the two
    (explanation, events, stats, published, explainer) tuples."""
    rc, pc = _caches(nodes, bound)
    sides = []
    for (cfg, ex, rec, pub), cache, p in zip(
            _explainers(profiles), (rc, pc),
            (pod, port_types.Pod.from_dict(pod.to_dict()))):
        assert ex.submit(cache, cfg.profiles[0], level, [p])
        ex.drain()
        sides.append((ex.explain_of(p.key), rec.events, ex.stats(), pub, ex))
    for s in sides:
        s[4].close()
    (r_exp, r_ev, r_st, r_pub, _), (t_exp, t_ev, t_st, t_pub, _) = sides
    assert _no_ts(t_exp) == _no_ts(r_exp)
    assert t_ev == r_ev
    assert t_st == r_st
    assert ([{k: _no_ts(v) for k, v in s.items()} for s in t_pub]
            == [{k: _no_ts(v) for k, v in s.items()} for s in r_pub])
    return sides[1]


def _tainted():
    return [make_node("t0").capacity({"cpu": "8", "pods": "10"})
            .taint("dedicated", "ml", "NoSchedule").obj()]


@pytest.mark.parametrize("level,mode", [("single", "tensor"),
                                        ("oracle", "oracle")])
def test_explainer_thread_verdict(level, mode):
    reasons = port_registry.UNSCHEDULABLE_REASONS
    samples = port_registry.EXPLAIN_SAMPLES
    base = reasons.get({"filter": "TaintToleration"})
    base_mode = samples.get({"mode": mode})
    pod = make_pod("p0").req({"cpu": "1"}).obj()
    exp, events, stats, published, _ = _submit_both(_tainted(), pod, level)
    assert exp["mode"] == mode
    assert exp["filters"] == {"TaintToleration": 1}
    assert exp["message"] == ("0/1 nodes are available: 1 node(s) had "
                              "untolerated taint.")
    assert events == [(pod.key, "Warning", "FailedScheduling",
                       exp["message"])]
    assert reasons.get({"filter": "TaintToleration"}) == base + 1
    assert samples.get({"mode": mode}) == base_mode + 1
    assert published and pod.key in published[-1]
    assert stats["podsExplained"] == 1 and stats["errors"] == 0


def test_explainer_throttles_reexplanation():
    nodes = [make_node("n0").capacity({"cpu": "1", "pods": "10"}).obj()]
    rc, pc = _caches(nodes)
    pod = make_pod("p0").req({"cpu": "4"}).obj()
    for (cfg, ex, _rec, _pub), cache, p in zip(
            _explainers(), (rc, pc),
            (pod, port_types.Pod.from_dict(pod.to_dict()))):
        assert ex.submit(cache, cfg.profiles[0], "single", [p])
        assert ex.submit(cache, cfg.profiles[0], "single", [p])
        assert ex.samples == 1
        ex.drain()
        ex.close()


def test_explainer_backlog_full_falls_back(monkeypatch):
    nodes = [make_node("n0").capacity({"cpu": "1", "pods": "10"}).obj()]
    rc, pc = _caches(nodes)
    pod = make_pod("p0").req({"cpu": "4"}).obj()
    for (cfg, ex, _rec, _pub), cache, p in zip(
            _explainers(), (rc, pc),
            (pod, port_types.Pod.from_dict(pod.to_dict()))):
        if isinstance(ex, port_explainer_mod.SchedulingExplainer):
            monkeypatch.setattr(port_explainer_mod, "MAX_BACKLOG", 0)
        else:
            ex._max_backlog = 0
        assert not ex.submit(cache, cfg.profiles[0], "single", [p])
        assert ex.skipped == 1
        ex.close()


def test_explainer_feasible_now_raced_cluster():
    nodes = [make_node("n0").capacity({"cpu": "8", "pods": "10"}).obj()]
    pod = make_pod("p0").req({"cpu": "1"}).obj()
    exp, *_ = _submit_both(nodes, pod, "single")
    assert exp["feasibleNow"] == 1 and exp["filters"] == {}
    assert "became feasible" in exp["message"]


def test_oracle_mode_disabled_filter_rejections_become_unjudged():
    pod = make_pod("p0").req({"cpu": "1"}).obj()
    exp, *_ = _submit_both(
        _tainted(), pod, "oracle",
        profiles=lambda m: [m.Profile(disabled_filters=["TaintToleration"])])
    assert exp["mode"] == "oracle"
    assert exp["filters"] == {} and exp["unjudged"] == 1
    assert "not judged" in exp["message"]


def test_tensor_mode_disabled_filter_passes():
    """The tensor judge honours a profile's disabled filters natively."""
    pod = make_pod("p0").req({"cpu": "1"}).obj()
    exp, *_ = _submit_both(
        _tainted(), pod, "single",
        profiles=lambda m: [m.Profile(disabled_filters=["TaintToleration"])])
    assert exp["mode"] == "tensor" and exp["feasibleNow"] == 1


def test_explainer_relational_bound_pods():
    """A capture with bound pods: the hard-spread and anti-affinity
    verdicts ride the relational masks (count_pn's plain version here)."""
    nodes = [make_node("za").capacity({"cpu": "8", "pods": "10"})
             .label("zone", "a").obj(),
             make_node("zb").capacity({"cpu": "8", "pods": "10"})
             .label("zone", "b").taint("dedicated", "ml", "NoSchedule")
             .obj()]
    bound = [make_pod("b-db").label("app", "db").node("za").obj()]
    pod = (make_pod("anti").label("app", "db")
           .pod_affinity("zone", {"app": "db"}, anti=True).obj())
    exp, *_ = _submit_both(nodes, pod, "single", bound=bound)
    assert exp["filters"] == {"InterPodAffinity": 1, "TaintToleration": 1}


def test_submit_direct_records_a_ready_verdict():
    """The carve path's ready-made verdict (its caller arrives with slice
    carving): stored, published and counted as the reference does."""
    pod = make_pod("s0").obj()
    got = []
    for (_cfg, ex, rec, pub), p in zip(
            _explainers(), (pod, port_types.Pod.from_dict(pod.to_dict()))):
        msg = "0/4 origins can host a 2x2x1 slice."
        assert ex.submit_direct(p, msg, {"SliceCarve": 4}, 4, "default")
        assert ex.submit_direct(p, msg, {"SliceCarve": 4}, 4, "default")
        ex.drain()
        ex.close()
        got.append((_no_ts(ex.explain_of(p.key)), ex.stats(), rec.events,
                    [{k: _no_ts(v) for k, v in s.items()} for s in pub]))
    assert got[1] == got[0]
    assert got[1][0]["mode"] == "carve" and got[1][1]["samples"] == 1


def test_slice_shaped_pod_waits_for_slice_carving():
    """A slice-shaped pod that no carveable slice can host waits for slice
    carving: its verdict is the SliceCarve gate's, from the oracle judge
    (the gate is oracle-only), in the reference and here: the same
    verdict, no tensor judge, no device_explain count."""
    from kubernetes_tpu.topology.slicing import SLICE_SHAPE_LABEL
    errs = port_registry.LOOP_ERRORS
    base = errs.get({"site": "device_explain"})
    pod = make_pod("s0").req({"cpu": "1"}).label(SLICE_SHAPE_LABEL,
                                                 "1x1x1").obj()
    rc, pc = _caches(_tainted())
    (rcfg, rex, _r, _p), (tcfg, tex, _r2, _p2) = _explainers()
    called = []
    tex._judge_tensor = lambda *a, **k: called.append(1)
    for cfg, ex, cache, p in ((rcfg, rex, rc, pod),
                              (tcfg, tex, pc,
                               port_types.Pod.from_dict(pod.to_dict()))):
        assert ex.submit(cache, cfg.profiles[0], "single", [p])
        ex.drain()
        ex.close()
    assert rex.explain_of(pod.key)["mode"] == "oracle"
    assert rex.explain_of(pod.key)["filters"] == {"SliceCarve": 1}
    assert tex.fault is None and not called
    assert _no_ts(tex.explain_of(pod.key)) == _no_ts(rex.explain_of(pod.key))
    assert errs.get({"site": "device_explain"}) == base


def test_scheduler_failure_path_routes_through_explainer():
    """Both Schedulers: an unschedulable batch gets the explainer's
    upstream-style event, not the generic one."""
    nodes = _tainted()
    rc, pc = _caches(nodes)
    pod = make_pod("p0").req({"cpu": "1"}).obj()
    got = []
    for cache, qmod, smod, cfg_mod, p, kw in (
            (rc, ref_queue, ref_scheduler, ref_config, pod, {}),
            (pc, port_queue, port_scheduler, port_config,
             port_types.Pod.from_dict(pod.to_dict()), {"device": "cpu"})):
        queue = qmod.SchedulingQueue()
        sched = smod.Scheduler(cfg_mod.SchedulerConfiguration(), cache,
                               queue, binder=lambda p, n: True, **kw)
        rec = _Recorder()
        sched.recorder = rec
        assert sched.explainer is not None
        queue.add(p)
        try:
            sched.run_once(wait=0.5)
            sched.explainer.drain()
            got.append((rec.events, _no_ts(sched.explainer.explain_of(p.key))))
        finally:
            queue.close()
            sched.close()
    assert got[1] == got[0]
    events, exp = got[1]
    assert [e[2:] for e in events] == [("FailedScheduling", exp["message"])]
    assert "untolerated taint" in exp["message"] and exp["mode"] == "tensor"


def test_score_breakdown_for_scheduled_pod():
    nodes = [make_node("n0").capacity({"cpu": "8", "pods": "10"}).obj(),
             make_node("n1").capacity({"cpu": "2", "pods": "10"}).obj()]
    bound = [make_pod("busy").req({"cpu": "1"}).node("n1").obj()]
    pod = make_pod("p0").req({"cpu": "1"}).obj()
    pod.spec.node_name = "n0"
    (_c, rex, _r, _p), (_c2, tex, _r2, _p2) = _explainers()
    want = rex.score_breakdown(nodes, bound, pod)
    bd = tex.score_breakdown(_port(nodes, port_types.Node),
                             _port(bound, port_types.Pod),
                             port_types.Pod.from_dict(pod.to_dict()))
    assert bd["feasible"] == want["feasible"] == 2
    assert bd["chosen"] == want["chosen"] == "n0"
    assert [n for n, _ in bd["top"]] == [n for n, _ in want["top"]]
    np.testing.assert_allclose([s for _, s in bd["top"]],
                               [s for _, s in want["top"]], rtol=1e-6)


# ------------------------------------------------ no fallback that hides it

def _port_explainer_on(nodes):
    _rc, pc = _caches(nodes)
    (_c, _ex, _r, _p), (cfg, ex, rec, pub) = _explainers()
    return cfg, ex, rec, pc


def test_failed_tensor_judge_is_counted_and_left_unjudged():
    """A failure of the tensor judge is counted; the oracle does not judge
    in its place: the pod gets the generic event and no entry."""
    cfg, ex, rec, cache = _port_explainer_on(_tainted())

    def broken(*a, **k):
        raise RuntimeError("device lost")
    ex._judge_tensor = broken
    oracle_calls = []
    ex._judge_oracle = lambda *a, **k: oracle_calls.append(1)
    errs = port_registry.LOOP_ERRORS
    base = errs.get({"site": "device_explain"})
    pod = port_types.Pod.from_dict(make_pod("p0").req({"cpu": "1"})
                                   .obj().to_dict())
    assert ex.submit(cache, cfg.profiles[0], "single", [pod])
    ex.drain()
    ex.close()
    assert errs.get({"site": "device_explain"}) == base + 1
    assert not oracle_calls
    assert ex.explain_of(pod.key) is None
    assert ex.pods_explained == 0
    assert rec.events == [(pod.key, "Warning", "FailedScheduling",
                           port_explainer_mod.GENERIC_MESSAGE)]
    assert ex.fault is None and ex.errors == 1


def test_oracle_level_does_not_count_a_device_error():
    cfg, ex, rec, cache = _port_explainer_on(_tainted())
    called = []
    ex._judge_tensor = lambda *a, **k: called.append(1)
    errs = port_registry.LOOP_ERRORS
    base = errs.get({"site": "device_explain"})
    pod = port_types.Pod.from_dict(make_pod("p0").obj().to_dict())
    assert ex.submit(cache, cfg.profiles[0], "oracle", [pod])
    ex.drain()
    ex.close()
    assert not called
    assert errs.get({"site": "device_explain"}) == base
    assert ex.explain_of(pod.key)["mode"] == "oracle"


@pytest.mark.parametrize("exc", [
    KernelError("count_pn did not launch"), ParityError("refuted"),
    NotImplementedError("item 11"),
    getattr(torch, "AcceleratorError", RuntimeError)(
        "CUDA error: an illegal memory access was encountered")],
    ids=["kernel", "parity", "not_ported", "cuda"])
def test_fatal_tensor_judge_errors_propagate(exc):
    """No verdict, no oracle, no device_explain count: the scheduler raises
    the error at its next pop."""
    nodes = _tainted()
    _rc, pc = _caches(nodes)
    queue = port_queue.SchedulingQueue()
    sched = port_scheduler.Scheduler(port_config.SchedulerConfiguration(),
                                     pc, queue, lambda p, n: True,
                                     device="cpu")
    rec = _Recorder()
    sched.recorder = rec

    def broken(*a, **k):
        raise exc
    sched.explainer._judge_tensor = broken
    errs = port_registry.LOOP_ERRORS
    base = errs.get({"site": "device_explain"})
    pod = port_types.Pod.from_dict(make_pod("p0").req({"cpu": "1"})
                                   .obj().to_dict())
    queue.add(pod)
    try:
        sched.run_once(wait=0.5)
        sched.explainer.drain()
        assert sched.explainer.fault is exc
        assert sched.explainer.explain_of(pod.key) is None
        assert errs.get({"site": "device_explain"}) == base
        assert rec.events == []  # neither verdict nor generic event
        with pytest.raises(type(exc)):
            sched.run_once(wait=0.01)
    finally:
        queue.close()
        sched.close()


# ----------------------------------------------------- the runner, over HTTP

def _wait_for(pred, timeout=30.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(interval)
    return None


def test_runner_publishes_explanations_and_events():
    """The port's APIServer + SchedulerRunner over HTTP: the
    ``scheduler-explanations`` ConfigMap and the ``FailedScheduling`` event
    carry the message ``tests/test_explain_e2e.py`` reads through
    ``ktpu why``; the status ConfigMap carries the explainer's stats."""
    from kubernetes_tpu_torch.client.clientset import HTTPClient
    from kubernetes_tpu_torch.sched.runner import (EXPLAIN_CONFIGMAP,
                                                   SchedulerRunner)
    from kubernetes_tpu_torch.store.apiserver import APIServer
    from kubernetes_tpu_torch.testing.wrappers import (make_node as pnode,
                                                       make_pod as ppod)
    server = APIServer().start()
    client = HTTPClient(server.url)
    runner = SchedulerRunner(client, port_config.SchedulerConfiguration(
        backoff_initial_s=0.05, backoff_max_s=0.2), device="cpu")
    try:
        runner.start()
        for i in range(2):
            client.nodes().create(
                pnode(f"tainted-{i}")
                .capacity({"cpu": "4", "memory": "8Gi", "pods": "10"})
                .taint("dedicated", "ml", "NoSchedule").obj().to_dict())
        pods = client.pods("default")
        pods.create(ppod("ok").req({"cpu": "100m"})
                    .toleration(key="dedicated", operator="Exists")
                    .obj().to_dict())
        pods.create(ppod("stuck").req({"cpu": "100m"}).obj().to_dict())
        assert _wait_for(lambda: pods.get("ok")["spec"].get("nodeName"))
        want = "0/2 nodes are available: 2 node(s) had untolerated taint."

        def explained():
            try:
                cm = client.resource("configmaps", "default").get(
                    EXPLAIN_CONFIGMAP)
            except Exception:
                return None
            doc = json.loads((cm.get("data") or {}).get("explanations")
                             or "{}")
            return doc.get("default/stuck")
        got = _wait_for(explained)
        assert got, "no explanation was published"
        assert got["filters"] == {"TaintToleration": 2}
        assert got["message"] == want and got["mode"] == "tensor"

        runner.scheduler.recorder.flush()

        def event_msg():
            for e in client.resource("events", "default").list():
                if (e.get("reason") == "FailedScheduling"
                        and (e.get("involvedObject") or {}).get("name")
                        == "stuck"):
                    return e.get("message")
            return None
        assert _wait_for(event_msg) == want
        runner.publish_status()
        cm = client.resource("configmaps", "default").get(runner.status_name)
        status = json.loads(cm["data"]["status"])
        assert status["explain"]["podsExplained"] >= 1
        assert status["explain"]["errors"] == 0
    finally:
        runner.stop()
        server.stop()
