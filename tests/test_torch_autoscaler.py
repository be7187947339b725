"""The port's cluster autoscaler against the JAX package's, on the CPU.

``tests/test_autoscaler.py``'s cases that need no kubemark (ROADMAP
Queue A item 15; ``ktpu autoscale status`` is in tests/test_torch_cli.py),
each run through both
packages on the same objects (every port device call on ``device="cpu"``):
the reference's assertions hold on the port, and the two packages' results
are equal (options, masks, plans, blocked reasons, reclaimed nodes, the
status ConfigMap). Plus the port's own refusal: ``HollowNodeGroupProvider``
raises item 15. A group with DRA ``deviceCapacity`` loads as the
reference's does.
"""

from __future__ import annotations

import functools
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import kubernetes_tpu.autoscaler as ref_autoscaler
import kubernetes_tpu_torch.autoscaler as port_autoscaler
from benchmarks.plannerloop import _norm_scale_down, _norm_scale_up
from kubernetes_tpu.autoscaler import expander as ref_expander
from kubernetes_tpu.autoscaler import simulator as ref_simulator
from kubernetes_tpu.client import clientset as ref_clientset
from kubernetes_tpu.encode.snapshot import SnapshotEncoder as RefEncoder
from kubernetes_tpu.ops.filters import run_filters as ref_run_filters
from kubernetes_tpu.store import store as ref_store
from kubernetes_tpu.testing import wrappers as ref_wrappers
from kubernetes_tpu.utils import clock as ref_clock
from kubernetes_tpu.utils import sanity as ref_sanity
from kubernetes_tpu_torch.autoscaler import expander as port_expander
from kubernetes_tpu_torch.autoscaler import simulator as port_simulator
from kubernetes_tpu_torch.client import clientset as port_clientset
from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
from kubernetes_tpu_torch.ops.filters import run_filters
from kubernetes_tpu_torch.store import store as port_store
from kubernetes_tpu_torch.testing import wrappers as port_wrappers
from kubernetes_tpu_torch.utils import clock as port_clock
from kubernetes_tpu_torch.utils import sanity as port_sanity

D = "cpu"


def _port_run_filters(ct, pb, enabled=None):
    return run_filters(ct.to(D), pb.to(D), enabled).numpy()


REF = SimpleNamespace(
    name="ref", make_node=ref_wrappers.make_node,
    make_pod=ref_wrappers.make_pod, pkg=ref_autoscaler, sim=ref_simulator,
    expander=ref_expander, Encoder=RefEncoder,
    run_filters=lambda ct, pb: np.asarray(ref_run_filters(ct, pb)),
    scale_up=ref_simulator.simulate_scale_up,
    scale_down=ref_simulator.simulate_scale_down,
    client=lambda: ref_clientset.DirectClient(ref_store.ObjectStore()),
    ApiError=ref_clientset.ApiError, sanity=ref_sanity,
    FakeClock=ref_clock.FakeClock, kw={})
PORT = SimpleNamespace(
    name="port", make_node=port_wrappers.make_node,
    make_pod=port_wrappers.make_pod, pkg=port_autoscaler,
    sim=port_simulator, expander=port_expander, Encoder=SnapshotEncoder,
    run_filters=_port_run_filters,
    scale_up=functools.partial(port_simulator.simulate_scale_up, device=D),
    scale_down=functools.partial(port_simulator.simulate_scale_down,
                                 device=D),
    client=lambda: port_clientset.DirectClient(port_store.ObjectStore()),
    ApiError=port_clientset.ApiError, sanity=port_sanity,
    FakeClock=port_clock.FakeClock, kw={"device": D})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def both(scenario):
    """-> (reference result, port result) of ``scenario(P)``."""
    return scenario(REF), scenario(PORT)


def _group(P, name, min_size, max_size, caps, taints=(), labels=(), **kw):
    tpl = P.make_node(f"{name}-tpl").capacity(dict(caps))
    for k, v in dict(labels).items():
        tpl = tpl.label(k, v)
    for key, value, effect in taints:
        tpl = tpl.taint(key, value, effect)
    return P.pkg.NodeGroup(name, min_size, max_size, tpl.obj(), **kw)


# ---------------------------------------------------------------- overlay

def test_hypothetical_overlay_feasibility():
    def scenario(P):
        enc = P.Encoder()
        real = P.make_node("real").capacity({"cpu": "1", "pods": "10"}).obj()
        blocker = P.make_pod("blocker").req({"cpu": "900m"}) \
            .node("real").obj()
        want_ssd = (P.make_pod("want-ssd").req({"cpu": "500m"})
                    .node_selector({"disk": "ssd"}).obj())
        plain = P.make_pod("plain").req({"cpu": "500m"}).obj()
        pending = [want_ssd, plain]
        ct, meta = enc.encode_cluster([real], [blocker], pending_pods=pending,
                                      pending_slots=False)
        ssd = P.make_node("hypo-ssd").capacity({"cpu": "4", "pods": "10"}) \
            .label("disk", "ssd").obj()
        tainted = P.make_node("hypo-taint").capacity(
            {"cpu": "4", "pods": "10"}).taint("dedicated", "infra").obj()
        ct2, rows = enc.with_hypothetical(ct, meta, [ssd, tainted])
        return P.run_filters(ct2, enc.encode_pods(pending, meta)), rows

    (want, rrows), (mask, rows) = both(scenario)
    assert rows == rrows and len(rows) == 2
    np.testing.assert_array_equal(mask, want)
    assert not mask[0, 0] and not mask[1, 0]
    assert mask[0, rows[0]] and mask[1, rows[0]]
    assert not mask[0, rows[1]] and not mask[1, rows[1]]


def test_overlay_empty_is_identity():
    enc = SnapshotEncoder()
    ct, meta = enc.encode_cluster(
        [port_wrappers.make_node("n").capacity({"cpu": "1"}).obj()], [])
    ct2, rows = enc.with_hypothetical(ct, meta, [])
    assert rows == [] and ct2 is ct


# ----------------------------------------------------- batched simulation

def test_scale_up_is_one_batched_evaluation(monkeypatch):
    """K candidate groups evaluate via ONE run_filters call over the
    hypothetical-node overlay, on the device passed in."""
    calls = []
    real = port_simulator.run_filters

    def counting(ct, pb, enabled=None):
        calls.append(str(ct.node_valid.device))
        return real(ct, pb, enabled)

    monkeypatch.setattr(port_simulator, "run_filters", counting)

    def scenario(P):
        nodes = [P.make_node("full").capacity({"cpu": "1", "pods": "10"})
                 .obj()]
        bound = [P.make_pod("b").req({"cpu": "900m"}).node("full").obj()]
        pending = [P.make_pod(f"p{i}").req({"cpu": "600m"}).obj()
                   for i in range(6)]
        groups = [_group(P, "g-small", 0, 10, {"cpu": "1", "pods": "10"}),
                  _group(P, "g-med", 0, 10, {"cpu": "2", "pods": "10"}),
                  _group(P, "g-big", 0, 10, {"cpu": "8", "pods": "10"})]
        return _norm_scale_up(P.scale_up(nodes, bound, pending, groups))

    want, got = both(scenario)
    assert calls == ["cpu"], "candidate evaluation must be one batched call"
    assert got == want
    by_name = {g: (placed, n) for g, placed, n, _w in got}
    assert len(by_name["g-small"][0]) == 6 and by_name["g-small"][1] == 6
    assert by_name["g-med"][1] == 2 and by_name["g-big"][1] == 1


def test_scale_up_skips_pods_that_fit_existing_nodes():
    def scenario(P):
        nodes = [P.make_node("roomy").capacity({"cpu": "4", "pods": "10"})
                 .obj()]
        pending = [P.make_pod("p").req({"cpu": "500m"}).obj()]
        return P.scale_up(nodes, [], pending,
                          [_group(P, "g", 0, 5, {"cpu": "8"})])

    assert both(scenario) == ([], [])


def test_scale_up_headroom_caps_expansion():
    def scenario(P):
        nodes = [P.make_node("full").capacity({"cpu": "1", "pods": "10"})
                 .obj()]
        bound = [P.make_pod("b").req({"cpu": "1"}).node("full").obj()]
        pending = [P.make_pod(f"p{i}").req({"cpu": "900m"}).obj()
                   for i in range(5)]
        g = _group(P, "g", 0, 5, {"cpu": "1", "pods": "10"})
        return _norm_scale_up(P.scale_up(nodes, bound, pending, [g],
                                         headroom={"g": 2}))

    want, got = both(scenario)
    assert got == want
    assert len(got) == 1 and got[0][2] == 2 and len(got[0][1]) == 2


def test_scale_up_respects_template_taints_and_selectors():
    def scenario(P):
        nodes = [P.make_node("full").capacity({"cpu": "1", "pods": "10"})
                 .obj()]
        bound = [P.make_pod("b").req({"cpu": "1"}).node("full").obj()]
        tolerant = (P.make_pod("tol").req({"cpu": "500m"})
                    .toleration("dedicated", "Equal", "infra", "NoSchedule")
                    .obj())
        intolerant = P.make_pod("plain").req({"cpu": "500m"}).obj()
        g = _group(P, "dedicated", 0, 5, {"cpu": "8", "pods": "10"},
                   taints=[("dedicated", "infra", "NoSchedule")])
        return _norm_scale_up(P.scale_up(nodes, bound,
                                         [tolerant, intolerant], [g]))

    want, got = both(scenario)
    assert got == want
    assert len(got) == 1 and got[0][1] == [0]


# -------------------------------------------------------------- expanders

def _opt(P, name, waste, placed, nodes_needed=1, prio=0):
    return P.sim.ScaleUpOption(
        group=_group(P, name, 0, 10, {"cpu": "1"}, priority=prio),
        pod_indices=list(range(placed)), nodes_needed=nodes_needed,
        waste=waste)


def test_expanders():
    def scenario(P):
        a = _opt(P, "a", waste=0.8, placed=4, nodes_needed=4)
        b = _opt(P, "b", waste=0.2, placed=4, nodes_needed=1)
        c = _opt(P, "c", waste=0.5, placed=6, nodes_needed=2, prio=7)
        tie1, tie2 = _opt(P, "t1", 0.5, 3), _opt(P, "t2", 0.5, 3)
        return {
            name: fn([a, b, c]).group.name
            for name, fn in P.expander.EXPANDERS.items()
        }, [P.expander.random_expander([tie1, tie2], seed=s).group.name
            for s in range(8)], P.expander.least_waste([])

    want, got = both(scenario)
    assert got == want
    picks, ties, empty = got
    assert picks["least-waste"] == "b"
    assert picks["most-pods"] == "c" and picks["priority"] == "c"
    assert set(ties) == {"t1", "t2"} and empty is None


# ------------------------------------------------------------- scale-down

def _three_nodes(P):
    caps = {"cpu": "4", "memory": "8Gi", "pods": "10"}
    return [P.make_node(n).capacity(caps).obj() for n in ("m0", "m1", "m2")]


def test_scale_down_replacement_proof():
    def scenario(P):
        nodes = _three_nodes(P)
        bound = [P.make_pod("r0").req({"cpu": "500m"}).node("m1").obj(),
                 P.make_pod("r1").req({"cpu": "3500m"}).node("m2").obj(),
                 P.make_pod("r2").req({"cpu": "3"}).node("m0").obj()]
        return _norm_scale_down(P.scale_down(nodes, bound, ["m1", "m2"],
                                             utilization_threshold=0.95))

    want, got = both(scenario)
    assert got == want
    removable, placements, blocked = got
    assert removable == ["m1"]
    assert placements["m1"] == [("default/r0", "m0")]
    assert "fits nowhere else" in blocked["m2"]


def test_scale_down_utilization_gate():
    def scenario(P):
        bound = [P.make_pod("busy").req({"cpu": "3"}).node("m1").obj()]
        return _norm_scale_down(P.scale_down(_three_nodes(P), bound, ["m1"],
                                             utilization_threshold=0.5))

    want, got = both(scenario)
    assert got == want
    assert got[0] == [] and "utilization" in got[2]["m1"]


def test_scale_down_shared_ledger_no_double_booking():
    def scenario(P):
        caps = {"cpu": "4", "pods": "10"}
        nodes = [P.make_node(n).capacity(caps).obj() for n in ("a", "b", "t")]
        bound = [P.make_pod("pa").req({"cpu": "3"}).node("a").obj(),
                 P.make_pod("pb").req({"cpu": "3"}).node("b").obj()]
        return _norm_scale_down(P.scale_down(nodes, bound, ["a", "b"],
                                             utilization_threshold=0.95))

    want, got = both(scenario)
    assert got == want
    assert got[0] == ["a"] and "pb" in got[2]["b"]


def _web_pods(P, n):
    pods = [P.make_pod(f"web-{i}").req({"cpu": "100m"}).node("m1")
            .label("app", "web").obj() for i in range(n)]
    dicts = []
    for p in pods:
        d = p.to_dict()
        d.setdefault("status", {})["phase"] = "Running"
        d["status"]["conditions"] = [{"type": "Ready", "status": "True"}]
        dicts.append(d)
    return pods, dicts


_PDB = {"apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
        "metadata": {"name": "web-pdb", "namespace": "default"},
        "spec": {"minAvailable": 1,
                 "selector": {"matchLabels": {"app": "web"}}}}


@pytest.mark.parametrize("n_pods", [1, 2])
def test_scale_down_pdb_blocks_and_charges(n_pods):
    """One guarded pod with minAvailable 1 blocks; two guarded pods with
    ONE disruption left must not both pass (the budget is charged)."""
    def scenario(P):
        pods, dicts = _web_pods(P, n_pods)
        return _norm_scale_down(P.scale_down(
            _three_nodes(P), pods, ["m1"], utilization_threshold=0.95,
            pdbs=[_PDB], all_pod_dicts=dicts))

    want, got = both(scenario)
    assert got == want
    assert got[0] == [] and "PDB" in got[2]["m1"]


def test_scale_down_ignores_daemonset_and_mirror_pods():
    def scenario(P):
        ds_pod = P.make_pod("ds-x").req({"cpu": "100m"}).node("m1").obj()
        ds_pod.metadata.owner_references.append(
            {"kind": "DaemonSet", "name": "ds"})
        mirror = P.make_pod("mirror-x").req({"cpu": "100m"}).node("m1").obj()
        mirror.metadata.annotations["kubernetes.io/config.mirror"] = "abc"
        return _norm_scale_down(P.scale_down(_three_nodes(P),
                                             [ds_pod, mirror], ["m1"],
                                             utilization_threshold=0.95))

    want, got = both(scenario)
    assert got == want
    assert got[0] == ["m1"] and got[1]["m1"] == []


# ----------------------------------------------------- the control loop

def test_scale_down_reclaims_multiple_nodes_to_min_in_one_pass():
    def scenario(P):
        client = P.client()
        provider = P.pkg.StaticNodeGroupProvider(
            client, [_group(P, "idle-pool", 1, 5, {"cpu": "2",
                                                   "pods": "10"})])
        provider.scale_up("idle-pool", 3)
        ca = P.pkg.ClusterAutoscaler(client, provider,
                                     scale_down_unneeded_s=0.0, **P.kw)
        summary = ca.run_once()
        return (sorted(summary["scaled_down"]),
                provider.target_size("idle-pool"),
                sorted(n["metadata"]["name"] for n in client.nodes().list()))

    want, got = both(scenario)
    assert got == want
    assert len(got[0]) == 2 and got[1] == 1 and len(got[2]) == 1


def test_scale_up_run_once_and_status_configmap():
    """One RunOnce that scales a group up, on both packages: the same
    decision, nodes and ``cluster-autoscaler-status`` ConfigMap (what
    ``ktpu autoscale status`` would render; timestamps aside)."""
    def scenario(P):
        client = P.client()
        client.nodes().create(P.make_node("full").capacity(
            {"cpu": "1", "pods": "10"}).obj().to_dict())
        client.pods("default").create(P.make_pod("b").req(
            {"cpu": "900m"}).node("full").obj().to_dict())
        for i in range(3):
            client.pods("default").create(P.make_pod(f"p{i}").req(
                {"cpu": "900m"}).obj().to_dict())
        provider = P.pkg.StaticNodeGroupProvider(
            client, [_group(P, "pool", 0, 5, {"cpu": "2", "pods": "10"})])
        ca = P.pkg.ClusterAutoscaler(client, provider,
                                     clock=P.FakeClock(1000.0), **P.kw)
        summary = ca.run_once()
        cm = client.resource("configmaps", "default").get(
            P.pkg.STATUS_CONFIGMAP)
        status = json.loads(cm["data"]["status"])
        return summary, status, sorted(
            n["metadata"]["name"] for n in client.nodes().list())

    want, got = both(scenario)
    assert got == want
    summary, status, names = got
    assert summary["scaled_up"] == ["pool-0", "pool-1"]
    assert status["groups"]["pool"]["size"] == 2
    assert status["lastScaleUp"]["pods"] == 3
    assert names == ["full", "pool-0", "pool-1"]


def test_cluster_autoscaler_note_drained():
    clock = port_clock.FakeClock(500.0)
    client = PORT.client()
    provider = port_autoscaler.StaticNodeGroupProvider(
        client, [_group(PORT, "g", 0, 4, {"cpu": "2"})])
    ca = port_autoscaler.ClusterAutoscaler(client, provider, clock=clock,
                                           device=D)
    ca.note_drained(["n0", "n1"])
    assert ca._unneeded_since == {"n0": 500.0, "n1": 500.0}
    clock.advance(10.0)
    ca.note_drained(["n0"])
    assert ca._unneeded_since["n0"] == 500.0


# ----------------------------------------------- config sanity + loading

def test_check_node_groups_fails_fast():
    def scenario(P):
        bad = _group(P, "bad", 5, 2, {"cpu": "1"})
        no_alloc = P.pkg.NodeGroup("empty", 0, 1, P.make_node("t").obj())
        dup = _group(P, "bad", 0, 1, {"cpu": "1"})
        return (P.sanity.check_node_groups([bad, no_alloc, dup]),
                P.sanity.check_node_groups([_group(P, "ok", 0, 3,
                                                   {"cpu": "1"})]))

    want, got = both(scenario)
    assert got == want
    problems, clean = got
    assert any("min_size 5 > max_size 2" in p for p in problems)
    assert any("no allocatable" in p for p in problems)
    assert any("duplicate" in p for p in problems)
    assert clean == []


def test_autoscaler_rejects_bad_groups_at_construction():
    client = PORT.client()
    provider = port_autoscaler.StaticNodeGroupProvider(
        client, [_group(PORT, "bad", 9, 1, {"cpu": "1"})])
    with pytest.raises(ValueError, match="min_size 9 > max_size 1"):
        port_autoscaler.ClusterAutoscaler(client, provider, device=D)
    with pytest.raises(ValueError, match="unknown expander"):
        port_autoscaler.ClusterAutoscaler(
            client, port_autoscaler.StaticNodeGroupProvider(
                client, [_group(PORT, "ok", 0, 1, {"cpu": "1"})]),
            expander="does-not-exist", device=D)


def _plain(d: dict) -> dict:
    """An object dict without what each process stamps on its own."""
    md = {k: v for k, v in d["metadata"].items()
          if k not in ("uid", "creationTimestamp")}
    return {**d, "metadata": md}


@pytest.mark.parametrize("name", ["node-group-default", "node-group-large"])
def test_load_node_group(name):
    """``load_node_group`` takes the dict the YAML template parses to (the
    port reads no YAML); the stamped template equals the reference's."""
    import yaml
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmarks", "config", "templates",
        f"{name}.yaml")
    with open(path) as f:
        d = yaml.safe_load(f)
    g = port_autoscaler.load_node_group(d)
    r = ref_autoscaler.load_node_group(d)
    assert (g.name, g.min_size, g.max_size, g.priority) == \
        (r.name, r.min_size, r.max_size, r.priority)
    stamped = g.template_node(f"{g.name}-0")
    assert _plain(stamped.to_dict()) == \
        _plain(r.template_node(f"{r.name}-0").to_dict())
    assert stamped.metadata.labels[port_autoscaler.NODE_GROUP_LABEL] == \
        g.name
    assert port_sanity.check_node_groups([g]) == []


def test_hollow_provider_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 15"):
        port_autoscaler.HollowNodeGroupProvider(
            PORT.client(), [_group(PORT, "g", 0, 1, {"cpu": "1"})])


def test_dra_device_capacity_group_loads_as_reference():
    """DRA is ported: a group with ``deviceCapacity`` loads as the
    reference loads it, and its template node carries the devices as
    ``dra:<class>`` allocatable (tests/test_torch_dra.py scales one up for
    a claim pod)."""
    d = {"name": "gpu-pool", "maxSize": 2, "deviceCapacity": {"gpu": 8},
         "template": port_wrappers.make_node("t").capacity(
             {"cpu": "8"}).obj().to_dict()}
    port_g = port_autoscaler.load_node_group(d)
    ref_g = ref_autoscaler.load_node_group(d)
    assert port_g.device_capacity == ref_g.device_capacity == {"gpu": 8}
    assert (port_g.template_node("x").to_dict()
            == ref_g.template_node("x").to_dict())
    assert port_g.template_node("x").status.allocatable["dra:gpu"] == "8"
