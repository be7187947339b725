"""The port's scheduler extenders against the JAX package's, on the CPU.

Every scenario of ``tests/test_extender.py`` runs through both packages
against the same scriptable HTTP extender (``FakeExtender``) or through
each package's own ``TPUExtenderServer``:

- ``run_extenders``: masks, scores and error sets equal (filter and
  prioritize, managed resources, error policies, duplicate names,
  prioritize errors), and ``extender_binder``'s delegation;
- the ``Scheduler`` with an extender: equal placements (the veto and the
  score overlay reach ``gang_schedule``), also on a seeded
  MixedHeterogeneous cluster whose extender vetoes nodes by label; a
  transport error is an attempt error, requeued and never preempted for;
- ``TPUExtenderServer`` in both wire forms (``nodenames`` and full node
  objects): equal responses, and round-tripped through each package's
  scheduler;
- the parity sentinel skips a drain that has extenders, the drain path is
  off with extenders, and at the breaker's oracle level pods are
  requeued rather than bound past a veto — as in the reference.
"""

from __future__ import annotations

import json
import urllib.request

import numpy as np
import pytest
import torch

from kubernetes_tpu.config import features as ref_features
from kubernetes_tpu.config import types as ref_config
from kubernetes_tpu.sched import cache as ref_cache
from kubernetes_tpu.sched import extender as ref_ext
from kubernetes_tpu.sched import extender_server as ref_srv
from kubernetes_tpu.sched import queue as ref_queue
from kubernetes_tpu.sched import scheduler as ref_scheduler
from kubernetes_tpu.testing.wrappers import make_node, make_pod
from kubernetes_tpu_torch.api import types as port_types
from kubernetes_tpu_torch.config import features as port_features
from kubernetes_tpu_torch.config import types as port_config
from kubernetes_tpu_torch.metrics import registry as port_registry
from kubernetes_tpu_torch.sched import cache as port_cache
from kubernetes_tpu_torch.sched import extender as port_ext
from kubernetes_tpu_torch.sched import extender_server as port_srv
from kubernetes_tpu_torch.sched import queue as port_queue
from kubernetes_tpu_torch.sched import scheduler as port_scheduler

from test_extender import FakeExtender

LONG = 3600.0

# (extender module, config module, cache, queue, scheduler, features,
#  pod parser, scheduler kwargs) per package
REF = (ref_ext, ref_config, ref_cache, ref_queue, ref_scheduler,
       ref_features, lambda p: p, {})
PORT = (port_ext, port_config, port_cache, port_queue, port_scheduler,
        port_features, lambda p: port_types.Pod.from_dict(p.to_dict()),
        {"device": "cpu"})
SIDES = (REF, PORT)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _both_run(exts_of, pods, nodes):
    """run_extenders on both packages; asserts equal masks, scores and
    errors. ``exts_of(ext_module)`` -> that package's extender list."""
    out = []
    for side in SIDES:
        mod, parse = side[0], side[6]
        out.append(mod.run_extenders(exts_of(mod), [parse(p) for p in pods],
                                     nodes))
    (rm, rs, re), (tm, ts, te) = out
    for r, t in ((rm, tm), (rs, ts)):
        assert (r is None) == (t is None)
        if r is not None:
            assert t.dtype == r.dtype
            np.testing.assert_array_equal(t, r)
    assert te == re
    return out[1]


def test_extender_filter_and_prioritize():
    fake = FakeExtender(banned=["n1"], boost="n2")
    try:
        mask, scores, errs = _both_run(
            lambda m: [m.HTTPExtender(m.ExtenderConfig(
                url_prefix=fake.url, filter_verb="filter",
                prioritize_verb="prioritize", weight=2.0,
                node_cache_capable=True))],
            [make_pod("p0").obj()], ["n0", "n1", "n2"])
        assert not errs
        np.testing.assert_array_equal(mask, [[True, False, True]])
        np.testing.assert_array_equal(scores, [[0.0, 0.0, 20.0]])
    finally:
        fake.stop()


def test_extender_managed_resources_gating():
    fake = FakeExtender(banned=["n0"])
    try:
        plain = make_pod("plain").req({"cpu": "1"}).obj()
        managed = make_pod("managed").req({"example.com/tpu": "1"}).obj()
        mask, _, errs = _both_run(
            lambda m: [m.HTTPExtender(m.ExtenderConfig(
                url_prefix=fake.url, filter_verb="filter",
                node_cache_capable=True,
                managed_resources=["example.com/tpu"]))],
            [plain, managed], ["n0", "n1"])
        assert not errs
        np.testing.assert_array_equal(mask, [[True, True], [False, True]])
    finally:
        fake.stop()


@pytest.mark.parametrize("ignorable", [True, False])
def test_extender_error_policies(ignorable):
    fake = FakeExtender(fail=True)
    try:
        mask, _, errs = _both_run(
            lambda m: [m.HTTPExtender(m.ExtenderConfig(
                url_prefix=fake.url, filter_verb="filter",
                ignorable=ignorable, node_cache_capable=True,
                timeout_s=2.0))],
            [make_pod("p0").obj()], ["n0"])
        assert mask is None
        assert errs == (set() if ignorable else {0})
    finally:
        fake.stop()


def test_extender_duplicate_names_still_filter():
    def dup(m):
        class DupExtender(m.HTTPExtender):
            def filter(self, pod, node_names):
                return ["n0", "n0"]  # drops n1, padded with a duplicate
        return [DupExtender(m.ExtenderConfig(url_prefix="http://unused",
                                             filter_verb="filter"))]
    mask, _, _ = _both_run(dup, [make_pod("p0").obj()], ["n0", "n1"])
    np.testing.assert_array_equal(mask, [[True, False]])


def test_prioritize_errors_are_ignored():
    fake = FakeExtender(fail=True)
    try:
        mask, scores, errs = _both_run(
            lambda m: [m.HTTPExtender(m.ExtenderConfig(
                url_prefix=fake.url, prioritize_verb="prioritize",
                node_cache_capable=True, timeout_s=2.0))],
            [make_pod("p0").obj()], ["n0"])
        assert not errs and mask is None and scores is None
    finally:
        fake.stop()


def test_extender_bind_delegation():
    for side in SIDES:
        mod, parse = side[0], side[6]
        fake = FakeExtender()
        try:
            ext = mod.HTTPExtender(mod.ExtenderConfig(
                url_prefix=fake.url, bind_verb="bind",
                node_cache_capable=True))
            pod = parse(make_pod("p0").obj())
            assert mod.extender_binder([ext])(pod, "n3") is True
            assert fake.bound == [("p0", "n3")]
            gated = mod.HTTPExtender(mod.ExtenderConfig(
                url_prefix=fake.url, bind_verb="bind",
                managed_resources=["example.com/tpu"]))
            assert mod.extender_binder([gated])(pod, "n3") is None
        finally:
            fake.stop()


def test_extender_config_from_dict():
    d = {"urlPrefix": "http://x", "filterVerb": "filter",
         "prioritizeVerb": "prioritize", "bindVerb": "bind", "weight": 3,
         "nodeCacheCapable": True, "ignorable": True, "httpTimeout": 7,
         "managedResources": [{"name": "example.com/tpu"}, "nvidia.com/gpu"]}
    r = ref_config.SchedulerConfiguration.from_dict({"extenders": [d]})
    t = port_config.SchedulerConfiguration.from_dict({"extenders": [d]})
    assert vars(t.extenders[0]) == vars(r.extenders[0])
    with pytest.raises(ValueError):
        port_ext.ExtenderConfig.from_dict({"managedResources": [{}]})


# ------------------------------------------------- scheduler-in-the-loop

def _scheduler(side, cfg_kw, nodes, bound=(), gates=None, binder=None):
    """A Scheduler of ``side`` over its own cache and queue, the nodes and
    bound pods parsed by its package. -> (scheduler, binder log)."""
    _e, cfg_mod, cache_mod, queue_mod, sched_mod, feat_mod, parse, kw = side
    cache = cache_mod.SchedulerCache(assume_ttl=LONG)
    for n in nodes:
        cache.add_node(n if side is REF
                       else port_types.Node.from_dict(n.to_dict()))
    for p in bound:
        cache.add_pod(parse(p))
    queue = queue_mod.SchedulingQueue(backoff_initial=LONG,
                                      backoff_max=LONG)
    log = {}
    gate = feat_mod.FeatureGate()
    gate.set_from_map(gates or {"PreemptionSimulation": False})
    sched = sched_mod.Scheduler(
        cfg_mod.SchedulerConfiguration(**dict(
            dict(explainer_enabled=False, parity_sample_every=0),
            **cfg_kw)),
        cache, queue,
        binder or (lambda p, n: log.setdefault(p.key, n) or True),
        feature_gate=gate, **kw)
    return sched, log


def _drive(sched, pods, parse, pops=4):
    for p in pods:
        sched.queue.add(parse(p))
    for _ in range(pops):
        sched.run_once(wait=0.05)
    sched.wait_for_bindings()


def _ext_cfg(side, **kw):
    return [side[0].ExtenderConfig(**kw)]


def test_scheduler_respects_extender():
    fake = FakeExtender(banned=["n0"], boost="n2")
    nodes = [make_node(f"n{i}").capacity({"cpu": "8", "pods": "10"}).obj()
             for i in range(3)]
    try:
        logs = []
        for side in SIDES:
            sched, log = _scheduler(side, {"extenders": _ext_cfg(
                side, url_prefix=fake.url, filter_verb="filter",
                prioritize_verb="prioritize", weight=100.0,
                node_cache_capable=True)}, nodes)
            try:
                _drive(sched, [make_pod("p0").req({"cpu": "1"}).obj()],
                       side[6], pops=1)
            finally:
                sched.close()
            logs.append(log)
        assert logs[1] == logs[0] == {"default/p0": "n2"}
    finally:
        fake.stop()


def _label_ext_server(banned: set, table: dict):
    """A scriptable extender: filter drops ``banned``, prioritize scores
    by ``table`` (node -> 0..10). -> FakeExtender-like object."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            payload = json.loads(self.rfile.read(n) or b"{}")
            names = payload.get("nodenames") or []
            if self.path.endswith("/filter"):
                body = {"nodenames": [x for x in names if x not in banned]}
            else:
                body = [{"host": x, "score": table.get(x, 0)} for x in names]
            data = json.dumps(body).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    class Server(ThreadingHTTPServer):
        # run_extenders fans a batch out on 16 threads: the default listen
        # backlog of 5 would refuse some of their connections
        request_queue_size = 128
        daemon_threads = True

    httpd = Server(("127.0.0.1", 0), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def test_placements_equal_with_extender_on_mixed_heterogeneous():
    """48 MixedHeterogeneous pods on 24 nodes in pops of 16 (the group
    path: extenders turn the drain off), an extender vetoing the seeded
    third of the nodes and scoring the rest: equal placements, none on a
    vetoed node."""
    from kubernetes_tpu_torch.testing.workloads import mixed_heterogeneous
    nodes_p, pods_p = mixed_heterogeneous(pods=48, nodes=24, seed=5)
    from kubernetes_tpu.api.types import Node as RNode, Pod as RPod
    nodes = [RNode.from_dict(n.to_dict()) for n in nodes_p]
    pods = [RPod.from_dict(p.to_dict()) for p in pods_p]
    rng = np.random.default_rng(5)
    names = [n.metadata.name for n in nodes]
    banned = {n for n in names if rng.random() < 1 / 3}
    table = {n: int(rng.integers(0, 11)) for n in names}
    httpd = _label_ext_server(banned, table)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        logs = []
        for side in SIDES:
            sched, log = _scheduler(side, {
                "batch_size": 16, "max_drain_batches": 2,
                "extenders": _ext_cfg(
                    side, url_prefix=url, filter_verb="filter",
                    prioritize_verb="prioritize", weight=5.0,
                    node_cache_capable=True)}, nodes)
            try:
                _drive(sched, pods, side[6], pops=6)
                assert sched.ctx_stats["rebuilds"] == 0  # no drain ran
            finally:
                sched.close()
            logs.append(log)
        assert logs[1] == logs[0]
        assert len(logs[1]) == len(pods)
        assert not set(logs[1].values()) & banned
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_transport_error_is_an_attempt_error():
    """A non-ignorable extender that fails: the pod is requeued with
    backoff as an attempt error, never bound and never preempted for."""
    fake = FakeExtender(fail=True)
    nodes = [make_node("n0").capacity({"cpu": "8", "pods": "10"}).obj()]
    try:
        results = []
        for side in SIDES:
            calls = []
            sched, log = _scheduler(
                side, {"extenders": _ext_cfg(
                    side, url_prefix=fake.url, filter_verb="filter",
                    node_cache_capable=True, timeout_s=2.0)}, nodes,
                gates={"PreemptionSimulation": True})
            sched.preemptor = lambda pod: calls.append(pod.key)
            sched._custom_preemptor = True
            try:
                _drive(sched, [make_pod("hi").priority(100)
                               .req({"cpu": "1"}).obj()], side[6], pops=1)
                results.append((log, calls, sched.queue.stats()))
            finally:
                sched.close()
        assert results[1] == results[0]
        log, calls, stats = results[1]
        assert log == {} and calls == []
        assert stats["backoff"] + stats["unschedulable"] == 1
    finally:
        fake.stop()


def test_oracle_level_requeues_instead_of_bypassing_the_veto():
    fake = FakeExtender(banned=["n0"])
    nodes = [make_node("n0").capacity({"cpu": "8", "pods": "10"}).obj()]
    try:
        out = []
        for side in SIDES:
            sched, log = _scheduler(side, {"extenders": _ext_cfg(
                side, url_prefix=fake.url, filter_verb="filter",
                node_cache_capable=True)}, nodes)
            sched.breaker.attempt_level = lambda: "oracle"
            try:
                _drive(sched, [make_pod("p0").req({"cpu": "1"}).obj()],
                       side[6], pops=1)
                out.append((log, sched.queue.stats()))
            finally:
                sched.close()
        assert out[1] == out[0]
        assert out[1][0] == {}
        assert sum(out[1][1].values()) == 1
    finally:
        fake.stop()


def test_extenders_turn_the_drain_and_its_parity_sample_off():
    """A pop wider than batch_size takes the group path when extenders are
    configured; and a drain that has extenders is never sampled by the
    parity sentinel (the reference skips it: the oracle cannot consult
    the extender)."""
    fake = FakeExtender()
    nodes = [make_node(f"n{i}").capacity({"cpu": "8", "pods": "20"}).obj()
             for i in range(4)]
    pods = [make_pod(f"p{i}").req({"cpu": "100m"}).obj() for i in range(12)]
    try:
        for side in SIDES:
            cfg = {"batch_size": 4, "max_drain_batches": 3,
                   "parity_sample_every": 1,
                   "extenders": _ext_cfg(side, url_prefix=fake.url,
                                         filter_verb="filter",
                                         node_cache_capable=True)}
            sched, log = _scheduler(side, cfg, nodes)
            try:
                _drive(sched, pods, side[6], pops=2)
                assert len(log) == 12
                assert sched.ctx_stats["rebuilds"] == 0
                assert sched.sentinel.samples["drain"] == 0
                # the drain called directly: no parity capture
                more = [side[6](make_pod(f"q{i}").req({"cpu": "100m"}).obj())
                        for i in range(8)]
                sched._schedule_drain(sched.cfg.profiles[0],
                                      [(p, 0) for p in more])
                sched._resolve_pending()
                sched.wait_for_bindings()
                assert sched.sentinel.samples["drain"] == 0
                assert sched.ctx_stats["rebuilds"] == 1
            finally:
                sched.close()
        # without extenders the same direct drain is sampled
        sched, _log = _scheduler(PORT, {"batch_size": 4,
                                        "max_drain_batches": 3,
                                        "parity_sample_every": 1}, nodes)
        try:
            more = [PORT[6](make_pod(f"q{i}").req({"cpu": "100m"}).obj())
                    for i in range(8)]
            sched._schedule_drain(sched.cfg.profiles[0],
                                  [(p, 0) for p in more])
            sched._resolve_pending()
            sched.sentinel.drain(30.0)
            assert sched.sentinel.samples["drain"] == 1
        finally:
            sched.close()
    finally:
        fake.stop()


def test_scheduler_bind_delegation():
    """An interested extender with a bindVerb owns the binding; the
    default binder is not called for it."""
    fake = FakeExtender()
    nodes = [make_node("n0").capacity({"cpu": "8", "pods": "10"}).obj()]
    try:
        for side in SIDES:
            fake.bound.clear()
            sched, log = _scheduler(side, {"extenders": _ext_cfg(
                side, url_prefix=fake.url, bind_verb="bind",
                node_cache_capable=True)}, nodes)
            try:
                _drive(sched, [make_pod("p0").req({"cpu": "1"}).obj()],
                       side[6], pops=1)
                sched.wait_for_bindings()
            finally:
                sched.close()
            assert log == {}
            assert fake.bound == [("p0", "n0")]
    finally:
        fake.stop()


# ------------------------------------------------- tensor-backed server

def _servers():
    return (ref_srv.TPUExtenderServer().start(),
            port_srv.TPUExtenderServer(device="cpu").start())


def _post(url, verb, payload):
    req = urllib.request.Request(
        url + "/" + verb, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _server_cluster():
    nodes = [make_node("big").capacity({"cpu": "8", "pods": "10"}).obj(),
             make_node("small").capacity({"cpu": "1", "pods": "10"}).obj(),
             make_node("mid").capacity({"cpu": "4", "pods": "10"})
             .label("zone", "a").obj()]
    bound = [make_pod("hog").req({"cpu": "2"}).node("mid").obj()]
    return nodes, bound


@pytest.mark.parametrize("wire", ["nodenames", "nodes"])
def test_extender_server_responses_equal(wire):
    """Both servers answer /filter and /prioritize alike in both wire
    forms (the full-objects form is what a stock kube-scheduler sends)."""
    nodes, bound = _server_cluster()
    ref, port = _servers()
    try:
        ref.set_cluster(nodes, bound)
        port.set_cluster([port_types.Node.from_dict(n.to_dict())
                          for n in nodes],
                         [port_types.Pod.from_dict(p.to_dict())
                          for p in bound])
        for pod in (make_pod("p0").req({"cpu": "4"}).obj(),
                    make_pod("p1").req({"cpu": "1"}).obj(),
                    make_pod("p2").req({"cpu": "100m"})
                    .node_selector({"zone": "a"}).obj()):
            payload = {"pod": pod.to_dict()}
            if wire == "nodenames":
                payload["nodenames"] = [n.metadata.name for n in nodes]
            else:
                payload["nodes"] = {"items": [n.to_dict() for n in nodes]}
            for verb in ("filter", "prioritize"):
                assert _post(port.url, verb, payload) \
                    == _post(ref.url, verb, payload)
    finally:
        ref.stop()
        port.stop()


def test_extender_server_filter_and_prioritize():
    server = port_srv.TPUExtenderServer(device="cpu").start()
    try:
        nodes = [make_node("big").capacity({"cpu": "8", "pods": "10"}).obj(),
                 make_node("small").capacity({"cpu": "1", "pods": "10"})
                 .obj()]
        server.set_cluster([port_types.Node.from_dict(n.to_dict())
                            for n in nodes], [])
        ext = port_ext.HTTPExtender(port_ext.ExtenderConfig(
            url_prefix=server.url, filter_verb="filter",
            prioritize_verb="prioritize", node_cache_capable=True,
            timeout_s=60.0))
        pod = port_types.Pod.from_dict(
            make_pod("p0").req({"cpu": "4"}).obj().to_dict())
        assert ext.filter(pod, ["big", "small"]) == ["big"]
        assert ext.prioritize(pod, ["big", "small"])["big"] > 0
    finally:
        server.stop()


def test_extender_server_full_node_objects_mode():
    server = port_srv.TPUExtenderServer(device="cpu").start()
    try:
        nodes = [port_types.Node.from_dict(n.to_dict()) for n in (
            make_node("big").capacity({"cpu": "8", "pods": "10"}).obj(),
            make_node("small").capacity({"cpu": "1", "pods": "10"}).obj())]
        server.set_cluster(nodes, [])
        ext = port_ext.HTTPExtender(port_ext.ExtenderConfig(
            url_prefix=server.url, filter_verb="filter",
            prioritize_verb="prioritize", timeout_s=60.0))
        pod = port_types.Pod.from_dict(
            make_pod("p0").req({"cpu": "4"}).obj().to_dict())
        assert ext.filter(pod, nodes) == ["big"]
        assert ext.prioritize(pod, nodes)["big"] > 0
        raw = ext._args(pod, nodes)
        assert raw["nodes"]["items"][0]["status"]["allocatable"]["cpu"] == "8"
    finally:
        server.stop()


def test_extender_server_round_trip_through_scheduler():
    """Each package's scheduler consuming its own extender server: the
    server's filter vetoes the node that is full in the server's view."""
    nodes = [make_node("n0").capacity({"cpu": "2", "pods": "10"}).obj(),
             make_node("n1").capacity({"cpu": "2", "pods": "10"}).obj()]
    hog = make_pod("hog").req({"cpu": "2"}).node("n0").obj()
    servers = _servers()
    try:
        logs = []
        for side, server in zip(SIDES, servers):
            if side is REF:
                server.set_cluster(nodes, [hog])
            else:
                server.set_cluster(
                    [port_types.Node.from_dict(n.to_dict()) for n in nodes],
                    [port_types.Pod.from_dict(hog.to_dict())])
            sched, log = _scheduler(side, {"extenders": _ext_cfg(
                side, url_prefix=server.url, filter_verb="filter",
                node_cache_capable=True, timeout_s=60.0)}, nodes)
            try:
                _drive(sched, [make_pod("p0").req({"cpu": "1"}).obj()],
                       side[6], pops=1)
            finally:
                sched.close()
            logs.append(log)
        assert logs[1] == logs[0] == {"default/p0": "n1"}
    finally:
        for s in servers:
            s.stop()


def test_extender_span_and_attempt_metrics():
    """The extender pass is traced (``scheduler/extenders``) and a
    transport error counts as an ``error`` attempt."""
    from kubernetes_tpu_torch.utils.tracing import TRACER
    fake = FakeExtender(fail=True)
    nodes = [make_node("n0").capacity({"cpu": "8", "pods": "10"}).obj()]
    try:
        sched, _log = _scheduler(PORT, {"extenders": _ext_cfg(
            PORT, url_prefix=fake.url, filter_verb="filter",
            node_cache_capable=True, timeout_s=2.0)}, nodes)
        attempts = port_registry.SCHEDULE_ATTEMPTS
        base = attempts.get({"result": "error"})
        n_spans = len(TRACER.spans("scheduler/extenders"))
        try:
            _drive(sched, [make_pod("p0").obj()], PORT[6], pops=1)
        finally:
            sched.close()
        assert attempts.get({"result": "error"}) == base + 1
        assert len(TRACER.spans("scheduler/extenders")) == n_spans + 1
    finally:
        fake.stop()
