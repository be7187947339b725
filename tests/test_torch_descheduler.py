"""The port's descheduler against the JAX package's, on the CPU.

``tests/test_descheduler.py``'s cases that need no kubemark (ROADMAP
Queue A item 15; ``ktpu deschedule`` is in tests/test_torch_cli.py), each
run through both
packages on the same objects (every port device call on ``device="cpu"``):
the reference's assertions hold on the port, and the two packages' plans
are equal (accepted sets, moves, blocked reasons, gang moves, evictions,
nominations, the status ConfigMap). Plus the strategies the reference
tests elsewhere (SliceDefrag against the port's carver twin), PyYAML
imported by ``from_yaml`` alone, and the gang-defrag end-to-end through the
port's runner.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import kubernetes_tpu.descheduler as ref_desched
import kubernetes_tpu_torch.descheduler as port_desched
from benchmarks.plannerloop import _norm_evictions, _norm_gang
from kubernetes_tpu.client import clientset as ref_clientset
from kubernetes_tpu.descheduler import planner as ref_planner
from kubernetes_tpu.descheduler import strategies as ref_strategies
from kubernetes_tpu.encode.snapshot import SnapshotEncoder as RefEncoder
from kubernetes_tpu.ops.filters import run_filters as ref_run_filters
from kubernetes_tpu.store import store as ref_store
from kubernetes_tpu.testing import wrappers as ref_wrappers
from kubernetes_tpu_torch.client import clientset as port_clientset
from kubernetes_tpu_torch.descheduler import planner as port_planner
from kubernetes_tpu_torch.descheduler import strategies as port_strategies
from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
from kubernetes_tpu_torch.ops.filters import run_filters
from kubernetes_tpu_torch.store import store as port_store
from kubernetes_tpu_torch.testing import wrappers as port_wrappers

D = "cpu"
ROOT = Path(__file__).resolve().parent.parent
GANG_LABEL = port_desched.GANG_LABEL


def _with_device(mod):
    """The port module's planning entry points with ``device="cpu"``."""
    return SimpleNamespace(**{
        name: functools.partial(getattr(mod, name), device=D)
        for name in ("plan_evictions", "plan_evictions_naive",
                     "plan_gang_defrag")})


REF = SimpleNamespace(
    name="ref", make_node=ref_wrappers.make_node,
    make_pod=ref_wrappers.make_pod, pkg=ref_desched, planner=ref_planner,
    plans=ref_planner, strategies=ref_strategies, Encoder=RefEncoder,
    run_filters=lambda ct, pb: np.asarray(ref_run_filters(ct, pb)),
    client=lambda: ref_clientset.DirectClient(ref_store.ObjectStore()),
    node_affinity=ref_strategies.pods_violating_node_affinity, kw={})
PORT = SimpleNamespace(
    name="port", make_node=port_wrappers.make_node,
    make_pod=port_wrappers.make_pod, pkg=port_desched, planner=port_planner,
    plans=_with_device(port_planner), strategies=port_strategies,
    Encoder=SnapshotEncoder,
    run_filters=lambda ct, pb: run_filters(ct.to(D), pb.to(D)).numpy(),
    client=lambda: port_clientset.DirectClient(port_store.ObjectStore()),
    node_affinity=functools.partial(
        port_strategies.pods_violating_node_affinity, device=D),
    kw={"device": D})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def both(scenario):
    """-> (reference result, port result) of ``scenario(P)``."""
    return scenario(REF), scenario(PORT)


def _fragmented(P, n=4, node_cpu="2", filler_cpu="1"):
    nodes = [P.make_node(f"n{i}")
             .capacity({"cpu": node_cpu, "memory": "4Gi", "pods": "10"})
             .obj() for i in range(n)]
    bound = [P.make_pod(f"filler-{i}").req({"cpu": filler_cpu})
             .node(f"n{i}").obj() for i in range(n)]
    return nodes, bound


def _gang(P, name, n=2, cpu="1500m", prio=None):
    out = []
    for i in range(n):
        w = P.make_pod(f"{name}{i}").label(GANG_LABEL, name).req({"cpu": cpu})
        if prio is not None:
            w = w.priority(prio)
        out.append(w.obj())
    return out


def _populate(client, nodes, pods):
    for n in nodes:
        client.nodes().create(n.to_dict())
    for p in pods:
        client.pods(p.metadata.namespace).create(p.to_dict())


# --------------------------------------------------------------- planner

def test_plan_is_one_batched_evaluation(monkeypatch):
    calls = []
    real = port_planner.run_filters

    def counting(ct, pb, enabled=None):
        calls.append(str(ct.node_valid.device))
        return real(ct, pb, enabled)

    monkeypatch.setattr(port_planner, "run_filters", counting)

    def scenario(P):
        nodes, bound = _fragmented(P)
        sets = P.strategies.high_node_utilization(nodes, bound,
                                                  threshold=0.6)
        return _norm_evictions(P.plans.plan_evictions(nodes, bound, sets))

    want, got = both(scenario)
    assert calls == ["cpu"], "candidate validation must be one batched call"
    assert got == want
    assert got[2:] == (4, 4)


def test_batched_vs_naive_parity():
    def scenario(P):
        nodes, bound = _fragmented(P, n=6)
        sets = P.strategies.high_node_utilization(nodes, bound,
                                                  threshold=0.6)
        sets.append(P.pkg.CandidateSet(name="solo", strategy="Test",
                                       victims=[bound[5]],
                                       exclude_targets=set()))
        batched = P.plans.plan_evictions(nodes, bound, sets)
        naive = P.plans.plan_evictions_naive(nodes, bound, sets)
        return ([(s.name, s.moves) for s in batched.accepted],
                [(s.name, s.moves) for s in naive.accepted],
                batched.blocked, naive.blocked, batched.batch_victims)

    want, got = both(scenario)
    assert got == want
    assert got[0] == got[1] and got[2] == got[3] and got[4] == 6


def test_shared_ledger_no_double_booking():
    def scenario(P):
        nodes = [P.make_node(f"n{i}").capacity({"cpu": "2", "pods": "10"})
                 .obj() for i in range(3)]
        bound = [P.make_pod("a").req({"cpu": "1"}).node("n0").obj(),
                 P.make_pod("b").req({"cpu": "1"}).node("n1").obj(),
                 P.make_pod("c").req({"cpu": "1"}).node("n2").obj()]
        CS = P.pkg.CandidateSet
        sets = [CS("drain/n0", "T", [bound[0]], {"n0"}),
                CS("drain/n1", "T", [bound[1]], {"n1"})]
        return _norm_evictions(P.plans.plan_evictions(nodes, bound, sets))

    want, got = both(scenario)
    assert got == want
    assert len(got[0]) == 1 and len(got[1]) == 1


def _guarded(P, min_available):
    nodes, bound = _fragmented(P)
    for p in bound:
        p.metadata.labels["app"] = "guarded"
    pdb = {"apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
           "metadata": {"name": "pdb", "namespace": "default"},
           "spec": {"minAvailable": min_available,
                    "selector": {"matchLabels": {"app": "guarded"}}}}
    return nodes, bound, pdb


@pytest.mark.parametrize("min_available", [4, 3])
def test_pdb_blocks_and_charges_across_sets(min_available):
    """minAvailable 4 blocks every set; minAvailable 3 leaves ONE
    disruption, which the first covered eviction spends."""
    def scenario(P):
        nodes, bound, pdb = _guarded(P, min_available)
        sets = P.strategies.high_node_utilization(nodes, bound,
                                                  threshold=0.6)
        return _norm_evictions(P.plans.plan_evictions(nodes, bound, sets,
                                                      pdbs=[pdb]))

    want, got = both(scenario)
    assert got == want
    accepted, blocked = got[0], got[1]
    if min_available == 4:
        assert not accepted
        assert all("PDB" in why for why in blocked.values())
    else:
        assert len(accepted) == 1 and len(accepted[0][2]) == 1
        assert len(blocked) == 3
        assert sum("PDB" in why for why in blocked.values()) >= 2


def test_max_evictions_budget():
    def scenario(P):
        nodes, bound = _fragmented(P, n=4)
        sets = P.strategies.high_node_utilization(nodes, bound,
                                                  threshold=0.6)
        plan = P.plans.plan_evictions(nodes, bound, sets, max_evictions=1)
        return _norm_evictions(plan), plan.evictions

    want, got = both(scenario)
    assert got == want
    assert got[1] == 1
    assert sum("budget" in why for why in got[0][1].values()) >= 1


def test_victims_fitting_nowhere_block_the_set():
    def scenario(P):
        nodes = [P.make_node("n0").capacity({"cpu": "2", "pods": "10"}).obj(),
                 P.make_node("n1").capacity({"cpu": "2", "pods": "10"}).obj()]
        bound = [P.make_pod("big-a").req({"cpu": "1500m"}).node("n0").obj(),
                 P.make_pod("big-b").req({"cpu": "1500m"}).node("n1").obj()]
        return _norm_evictions(P.plans.plan_evictions(nodes, bound, [
            P.pkg.CandidateSet("drain/n0", "T", [bound[0]], {"n0"})]))

    want, got = both(scenario)
    assert got == want
    assert not got[0] and "fits nowhere else" in got[1]["drain/n0"]


def test_daemonset_and_mirror_pods_are_not_victims():
    def scenario(P):
        nodes, bound = _fragmented(P)
        ds = P.make_pod("ds-0").req({"cpu": "100m"}).node("n0").obj()
        ds.metadata.owner_references = [{"kind": "DaemonSet", "name": "d",
                                         "controller": True}]
        mirror = P.make_pod("mirror-0").req({"cpu": "100m"}).node("n1").obj()
        mirror.metadata.annotations["kubernetes.io/config.mirror"] = "x"
        sets = P.strategies.high_node_utilization(nodes, bound + [ds, mirror],
                                                  threshold=0.9)
        return sorted(p.key for cs in sets for p in cs.victims)

    want, got = both(scenario)
    assert got == want
    assert "default/ds-0" not in got and "default/mirror-0" not in got


def test_without_pods_overlay_validates_the_ledger_proof():
    """Every move the host ledger approved is feasible per the FULL filter
    set (fit included) against ``without_pods`` of the post-eviction
    cluster, on the port's host path and on its tensor path."""
    import dataclasses

    def scenario(P):
        nodes, bound = _fragmented(P)
        sets = P.strategies.high_node_utilization(nodes, bound,
                                                  threshold=0.6)
        plan = P.plans.plan_evictions(nodes, bound, sets)
        victims = [p for s in plan.accepted for p in s.victims]
        enc = P.Encoder()
        ct, meta = enc.encode_cluster(nodes, bound, pending_pods=victims,
                                      pending_slots=False)
        masked = enc.without_pods(ct, meta, [p.key for p in victims])
        survivors = [p for p in bound
                     if p.key not in {v.key for v in victims}]
        ct2, _ = P.Encoder().encode_cluster(nodes, survivors,
                                            pending_pods=victims,
                                            pending_slots=False)
        unpinned = [dataclasses.replace(
            p, spec=dataclasses.replace(p.spec, node_name=""))
            for p in victims]
        pb = enc.encode_pods(unpinned, meta)
        out = {"plan": _norm_evictions(plan),
               "requested": np.asarray(masked.requested),
               "fresh": np.asarray(ct2.requested),
               "mask": P.run_filters(masked, pb),
               "unknown": enc.without_pods(ct, meta, ["default/nobody"])}
        if P is PORT:
            on_tensors = enc.without_pods(ct.to(D), meta,
                                          [p.key for p in victims])
            out["tensor_requested"] = on_tensors.requested.numpy()
            out["tensor_mask"] = P.run_filters(on_tensors, pb)
        return out, plan, meta, victims

    (want, *_), (got, plan, meta, victims) = both(scenario)
    assert got["plan"] == want["plan"] and plan.accepted
    real_n = len(meta.node_names)
    for key in ("requested", "fresh", "mask"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_array_equal(got["requested"][:real_n],
                                  got["fresh"][:real_n])
    np.testing.assert_array_equal(got["tensor_requested"], got["requested"])
    np.testing.assert_array_equal(got["tensor_mask"], got["mask"])
    row = {p.key: i for i, p in enumerate(victims)}
    for s in plan.accepted:
        for key, target in s.moves:
            assert got["mask"][row[key], meta.node_index[target]]
    assert got["unknown"] is None and want["unknown"] is None


# ------------------------------------------------------------ strategies

def test_low_node_utilization_rebalances_hot_nodes():
    def scenario(P):
        nodes = [P.make_node(f"n{i}").capacity({"cpu": "2", "pods": "10"})
                 .obj() for i in range(3)]
        bound = ([P.make_pod(f"hot-{i}").req({"cpu": "600m"}).node("n0")
                  .obj() for i in range(3)]
                 + [P.make_pod("lukewarm").req({"cpu": "1"}).node("n1")
                    .obj()])
        sets = P.strategies.low_node_utilization(nodes, bound, low=0.2,
                                                 high=0.8)
        warm = bound + [P.make_pod("warm").req({"cpu": "1"}).node("n2")
                        .obj()]
        return ([(cs.name, len(cs.victims), cs.exclude_targets)
                 for cs in sets],
                _norm_evictions(P.plans.plan_evictions(nodes, bound, sets)),
                P.strategies.low_node_utilization(nodes, warm, low=0.2,
                                                  high=0.8))

    want, got = both(scenario)
    assert got == want
    assert got[0] == [("rebalance/n0", 1, {"n0"})]
    assert got[1][0] and got[1][0][0][3][0][1] in ("n1", "n2")
    assert got[2] == []


def test_node_affinity_violation_detected_in_one_pass():
    def scenario(P):
        nodes = [P.make_node("ssd").capacity({"cpu": "4", "pods": "10"})
                 .label("disk", "ssd").obj(),
                 P.make_node("hdd").capacity({"cpu": "4", "pods": "10"})
                 .obj()]
        stale = (P.make_pod("wants-ssd").req({"cpu": "100m"})
                 .node_selector({"disk": "ssd"}).node("hdd").obj())
        fine = (P.make_pod("placed-right").req({"cpu": "100m"})
                .node_selector({"disk": "ssd"}).node("ssd").obj())
        plain = P.make_pod("plain").req({"cpu": "100m"}).node("hdd").obj()
        pods = [stale, fine, plain]
        sets = P.node_affinity(nodes, pods)
        return ([cs.victims[0].key for cs in sets],
                _norm_evictions(P.plans.plan_evictions(nodes, pods, sets)))

    want, got = both(scenario)
    assert got == want
    assert got[0] == ["default/wants-ssd"]
    assert got[1][0][0][3] == [("default/wants-ssd", "ssd")]


def test_node_affinity_sets_over_tenants_and_plain_pods():
    """The port encodes only the pods whose row can fail at their own node
    (a nodeSelector, required node affinity, a tenant of their own or of
    their node): the same sets as the reference's encode of every pod."""
    from kubernetes_tpu_torch.encode.snapshot import TENANT_LABEL

    def scenario(P):
        nodes = [P.make_node("ssd").capacity({"cpu": "8", "pods": "20"})
                 .label("disk", "ssd").obj(),
                 P.make_node("hdd").capacity({"cpu": "8", "pods": "20"})
                 .obj(),
                 P.make_node("t1").capacity({"cpu": "8", "pods": "20"})
                 .label(TENANT_LABEL, "a").obj(),
                 P.make_node("t2").capacity({"cpu": "8", "pods": "20"})
                 .label(TENANT_LABEL, "b").obj()]
        pods = [P.make_pod(f"plain-{n}").req({"cpu": "100m"}).node(n).obj()
                for n in ("ssd", "hdd")]
        pods += [
            P.make_pod("aff-stale").req({"cpu": "100m"})
            .node_affinity_in("disk", ["ssd"]).node("hdd").obj(),
            P.make_pod("aff-fine").req({"cpu": "100m"})
            .node_affinity_in("disk", ["ssd"]).node("ssd").obj(),
            P.make_pod("tenant-right").req({"cpu": "100m"})
            .label(TENANT_LABEL, "a").node("t1").obj(),
            P.make_pod("tenant-wrong").req({"cpu": "100m"})
            .label(TENANT_LABEL, "a").node("t2").obj(),
            P.make_pod("untenanted-on-tenant").req({"cpu": "100m"})
            .node("t1").obj(),
            P.make_pod("tenant-on-plain").req({"cpu": "100m"})
            .label(TENANT_LABEL, "b").node("hdd").obj(),
            P.make_pod("gone-node").req({"cpu": "100m"})
            .node_selector({"disk": "ssd"}).node("elsewhere").obj()]
        return sorted(cs.victims[0].key for cs in P.node_affinity(nodes,
                                                                  pods))

    want, got = both(scenario)
    assert got == want
    assert "default/aff-stale" in got and "default/aff-fine" not in got
    assert not any(k.startswith("default/plain") for k in got)


def test_topology_spread_violation_sheds_excess():
    def scenario(P):
        nodes = [P.make_node(f"n{i}")
                 .capacity({"cpu": "8", "pods": "20"})
                 .label("topology.kubernetes.io/zone", f"z{i % 2}")
                 .obj() for i in range(4)]
        pods = [P.make_pod(f"s{i}").label("app", "web")
                .req({"cpu": "100m"})
                .spread(1, "topology.kubernetes.io/zone", "DoNotSchedule",
                        {"app": "web"})
                .node("n0").obj() for i in range(5)]
        pods.append(P.make_pod("s-z1").label("app", "web")
                    .req({"cpu": "100m"})
                    .spread(1, "topology.kubernetes.io/zone",
                            "DoNotSchedule", {"app": "web"})
                    .node("n1").obj())
        sets = P.strategies.pods_violating_topology_spread(nodes, pods)
        return ([(cs.name, len(cs.victims), cs.exclude_targets)
                 for cs in sets],
                _norm_evictions(P.plans.plan_evictions(nodes, pods, sets)))

    want, got = both(scenario)
    assert got == want
    assert got[0] == [("spread/topology.kubernetes.io/zone=z0", 3,
                       {"n0", "n2"})]
    assert got[1][0] and all(t in ("n1", "n3")
                             for _k, t in got[1][0][0][3])


def test_remove_duplicates():
    def scenario(P):
        nodes = [P.make_node(f"n{i}").capacity({"cpu": "4", "pods": "10"})
                 .obj() for i in range(2)]
        ref = [{"kind": "ReplicaSet", "name": "web-abc", "controller": True}]
        dup = []
        for i in range(3):
            p = P.make_pod(f"web-{i}").req({"cpu": "100m"}).node("n0").obj()
            p.metadata.owner_references = list(ref)
            dup.append(p)
        bare = P.make_pod("solo").req({"cpu": "100m"}).node("n0").obj()
        sets = P.strategies.remove_duplicates(nodes, dup + [bare])
        return ([(cs.name, len(cs.victims), cs.exclude_targets)
                 for cs in sets],
                _norm_evictions(P.plans.plan_evictions(nodes, dup + [bare],
                                                       sets)))

    want, got = both(scenario)
    assert got == want
    assert got[0][0][1:] == (2, {"n0"})
    assert all(t == "n1" for _k, t in got[1][0][0][3])


def test_slice_defrag_frees_the_carvers_box():
    """SliceDefrag pools through the port's carver twin
    (``topology.numpy_grids`` / ``select_eviction``): the same box, the
    same victims as the reference."""
    from kubernetes_tpu.topology import slicing as ref_slicing
    from kubernetes_tpu_torch.topology import slicing as port_slicing

    def scenario(P):
        sl = ref_slicing if P is REF else port_slicing
        nodes, bound = [], []
        for x in range(4):
            for y in range(4):
                name = f"c{x}{y}"
                w = P.make_node(name).capacity({"cpu": "8", "pods": "10"})
                for k, v in sl.topology_labels(x, y, 0).items():
                    w = w.label(k, v)
                nodes.append(w.obj())
                # every cell busy (no free box), some twice: the
                # cheapest box is a choice
                for k in range(1 + (x * y) % 2):
                    bound.append(P.make_pod(f"bg-{name}-{k}")
                                 .req({"cpu": "1"}).node(name).obj())
        pending = [P.make_pod(f"s{i}").req({"cpu": "1"})
                   .label(GANG_LABEL, "slice-a")
                   .label(sl.SLICE_SHAPE_LABEL, "2x2x1").obj()
                   for i in range(4)]
        sets = P.strategies.slice_defrag_candidates(nodes, bound, pending)
        return [(cs.name, sorted(p.key for p in cs.victims),
                 sorted(cs.exclude_targets), cs.reason) for cs in sets]

    want, got = both(scenario)
    assert got == want and got
    assert got[0][0] == "slicedefrag/slice-a"


# ----------------------------------------------------------- gang defrag

def test_gang_defrag_picks_fewest_evictions(monkeypatch):
    calls = []
    real = port_planner.run_filters

    def counting(ct, pb, enabled=None):
        calls.append(1)
        return real(ct, pb, enabled)

    monkeypatch.setattr(port_planner, "run_filters", counting)

    def scenario(P):
        nodes, bound = _fragmented(P)
        cands = P.strategies.gang_consolidation_candidates(nodes, bound)
        gp = P.plans.plan_gang_defrag(nodes, bound, _gang(P, "g"), "train",
                                      cands)
        return _norm_gang(gp), gp

    (want, _), (got, gp) = both(scenario)
    assert calls == [1]
    assert got == want
    assert not gp.fits_without_evictions
    assert gp.accepted is not None and len(gp.accepted.victims) == 2
    assert len(gp.gang_moves) == 2
    assert {m[1] for m in gp.gang_moves}.isdisjoint(
        {t for _, t in gp.accepted.moves})
    assert "no-evictions" in gp.blocked


@pytest.mark.parametrize("case", ["fits", "budget"])
def test_gang_fits_or_hits_budget(case):
    def scenario(P):
        nodes, bound = _fragmented(P)
        cands = P.strategies.gang_consolidation_candidates(nodes, bound)
        if case == "fits":
            gang = _gang(P, "small", n=1, cpu="500m")
            return _norm_gang(P.plans.plan_gang_defrag(nodes, bound, gang,
                                                       "small", cands))
        return _norm_gang(P.plans.plan_gang_defrag(
            nodes, bound, _gang(P, "g"), "train", cands, max_evictions=1))

    want, got = both(scenario)
    assert got == want
    _gang_name, acc, _moves, fits, blocked = got
    assert acc is None
    if case == "fits":
        assert fits
    else:
        assert any("over budget" in why for why in blocked.values())


def test_two_gangs_share_one_cycle_ledger():
    def scenario(P):
        nodes, bound = _fragmented(P)
        cands = P.strategies.gang_consolidation_candidates(nodes, bound)
        gp_a = P.plans.plan_gang_defrag(nodes, bound, _gang(P, "a"), "a",
                                        cands)
        gp_b = P.plans.plan_gang_defrag(nodes, bound, _gang(P, "b"), "b",
                                        cands, ledger=gp_a.ledger)
        gp_b_alone = P.plans.plan_gang_defrag(nodes, bound, _gang(P, "b"),
                                              "b", cands)
        return _norm_gang(gp_a), _norm_gang(gp_b), _norm_gang(gp_b_alone)

    want, got = both(scenario)
    assert got == want
    a, b, b_alone = got
    assert a[1] is not None and len(a[2]) == 2
    assert b[1] is None and not b[3]
    seats = {t for _k, t in a[2]}
    assert {t for _k, t in b_alone[2]} & seats


@pytest.mark.parametrize("protect", ["priority", "gang_seat"])
def test_gang_consolidation_protects(protect):
    def scenario(P):
        nodes, bound = _fragmented(P)
        if protect == "priority":
            bound[0].spec.priority = 150
            bound[1].spec.priority = 100
        else:
            bound[0].metadata.labels[GANG_LABEL] = "train"
            bound[0].spec.priority = 100
        cands = P.strategies.gang_consolidation_candidates(
            nodes, bound, max_victim_priority=100)
        return [(cs.name, sorted(p.key for p in cs.victims),
                 sorted(cs.exclude_targets)) for cs in cands]

    want, got = both(scenario)
    assert got == want
    assert got and all("n0" not in excl for _n, _v, excl in got)
    if protect == "priority":
        assert any("n1" in excl for _n, _v, excl in got) and len(got) == 3
    else:
        assert all("default/filler-0" not in v for _n, v, _e in got)


def test_cycle_threads_claimed_victims_through_gang_plans(monkeypatch):
    from kubernetes_tpu_torch.descheduler import descheduler as dmod

    client = PORT.client()
    nodes, bound = _fragmented(PORT)
    _populate(client, nodes, bound)
    for g, i in (("a", 0), ("a", 1), ("b", 0)):
        client.pods("default").create(
            port_wrappers.make_pod(f"{g}{i}").label(GANG_LABEL, g)
            .req({"cpu": "1500m"}).obj().to_dict())
    calls = []

    def fake_gang_plan(nodes, bound, members, gang, cands, **kw):
        calls.append((gang, set(kw.get("claimed") or ())))
        gp = port_planner.GangDefragPlan(gang=gang)
        if gang == "a":
            gp.accepted = port_planner.AcceptedSet(
                name="consolidate/1-nodes", strategy="GangDefrag",
                victims=[bound[1]])
        return gp

    monkeypatch.setattr(dmod, "plan_gang_defrag", fake_gang_plan)
    d = port_desched.Descheduler(client, port_desched.DeschedulerConfiguration(
        strategies={"HighNodeUtilization": {"threshold": 0.6}}), device=D)
    plan, _gang_plans = d.plan()
    strategy_victims = {p.key for s in plan.accepted for p in s.victims}
    assert strategy_victims
    assert [g for g, _ in calls] == ["a", "b"]
    assert calls[0][1] == strategy_victims
    assert calls[1][1] == strategy_victims | {bound[1].key}


# ------------------------------------------------- control loop

def _cycle(P, strategies, gang_prio=None, filler_prio=None, dry_run=False,
           autoscaler=None):
    client = P.client()
    nodes, bound = _fragmented(P)
    if filler_prio is not None:
        for p in bound:
            p.spec.priority = filler_prio
    _populate(client, nodes, bound + _gang(P, "g", prio=gang_prio))
    cfg = P.pkg.DeschedulerConfiguration(strategies=strategies)
    d = P.pkg.Descheduler(client, cfg, autoscaler=autoscaler, **P.kw)
    return client, d


def test_gang_defrag_never_inverts_priority():
    def scenario(P):
        _client, d = _cycle(P, {}, filler_prio=1000)
        _plan, gang_plans = d.plan()
        return [_norm_gang(gp) for gp in gang_plans]

    want, got = both(scenario)
    assert got == want
    assert len(got) == 1 and got[0][1] is None and not got[0][3]


def _store_view(client):
    return sorted((p["metadata"]["name"], (p.get("spec") or {}).get(
        "nodeName") or "", (p.get("status") or {}).get(
        "nominatedNodeName", "")) for p in client.pods("default").list())


def test_run_once_evicts_and_requeues_bare_pods():
    def scenario(P):
        client, d = _cycle(P, {})
        summary = d.run_once()
        cm = client.resource("configmaps", "default").get(
            P.pkg.STATUS_CONFIGMAP)
        status = json.loads(cm["data"]["status"])
        status.pop("lastCycle")
        return summary, status, _store_view(client)

    want, got = both(scenario)
    assert got == want
    summary, status, view = got
    assert len(summary["evicted"]) == 2
    assert summary["gangs"][0]["evictions"] == 2
    evicted = {k.split("/", 1)[1] for k in summary["evicted"]}
    assert all(node == "" for name, node, _n in view if name in evicted)
    assert status["lastLoop"]["gangs"][0]["gang"] == "g"
    from kubernetes_tpu_torch.metrics.registry import (
        DESCHEDULER_EVICTIONS, DESCHEDULER_PLAN_BATCH)
    assert DESCHEDULER_EVICTIONS.get(
        {"strategy": "GangDefrag", "result": "evicted"}) >= 2
    assert DESCHEDULER_PLAN_BATCH.get({"phase": "gangDefrag"}) >= 2


def test_gang_defrag_nominates_gang_pods():
    def scenario(P):
        client, d = _cycle(P, {}, gang_prio=100)
        plan, gang_plans = d.plan()
        moves = dict(gang_plans[0].gang_moves)
        d._execute(plan, gang_plans)
        nominated = _store_view(client)
        d._unnominate_gang(gang_plans[0])
        return moves, nominated, _store_view(client)

    want, got = both(scenario)
    assert got == want
    moves, nominated, cleared = got
    assert {f"default/{n}": nom for n, _node, nom in nominated
            if n.startswith("g")} == moves
    assert len(set(moves.values())) == 2
    assert all(nom == "" for n, _node, nom in cleared if n.startswith("g"))


def test_dry_run_plans_but_does_not_evict():
    def scenario(P):
        client = P.client()
        nodes, bound = _fragmented(P)
        _populate(client, nodes, bound)
        cfg = P.pkg.DeschedulerConfiguration(
            strategies={"HighNodeUtilization": {"threshold": 0.6}},
            gang_defrag=False)
        summary = P.pkg.Descheduler(client, cfg, **P.kw).run_once(
            dry_run=True)
        return summary, _store_view(client)

    want, got = both(scenario)
    assert got == want
    summary, view = got
    assert summary["planned"] and "evicted" not in summary
    assert len(view) == 4


def test_autoscaler_handoff_seeds_unneeded_window():
    class FakeAutoscaler:
        def __init__(self):
            self.noted = []

        def note_drained(self, names):
            self.noted.extend(names)

    def scenario(P):
        ca = FakeAutoscaler()
        _client, d = _cycle(P, {}, autoscaler=ca)
        d.run_once()
        return sorted(ca.noted)

    want, got = both(scenario)
    assert got == want and len(got) == 2


def test_configuration_from_dict_and_yaml(tmp_path):
    text = """
deschedulerInterval: 30
maxEvictionsPerCycle: 5
gangDefrag: true
tenantDrainQuotas: {acme: 2}
profiles:
- name: defrag
  strategies:
    HighNodeUtilization: {threshold: 0.4}
    RemoveDuplicates: {}
"""
    p = tmp_path / "policy.yaml"
    p.write_text(text)
    cfg = port_desched.DeschedulerConfiguration.from_yaml(str(p))
    ref = ref_desched.DeschedulerConfiguration.from_yaml(str(p))
    assert vars(cfg) == vars(ref)
    assert cfg.interval_s == 30.0 and cfg.max_evictions_per_cycle == 5
    assert cfg.strategies == {"HighNodeUtilization": {"threshold": 0.4},
                              "RemoveDuplicates": {}}


def test_descheduler_imports_without_yaml():
    """The module imports without PyYAML; only ``from_yaml`` needs it."""
    code = ("import sys; sys.modules['yaml'] = None; sys.modules['jax'] = "
            "None\nfrom kubernetes_tpu_torch.descheduler import "
            "DeschedulerConfiguration as C\n"
            "print(C.from_dict({'maxEvictionsPerCycle': 3})"
            ".max_evictions_per_cycle)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin"})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "3"


# ------------------------------------------------------------------ e2e

def test_gang_defrag_e2e_schedules_gang_without_scale_up():
    """A fragmented cluster (every node half-full) and a pending gang no
    node can host, through the port's runner on the CPU: descheduler
    evictions consolidate the fillers, the gang binds, the fillers re-bind,
    and the node set never grows."""
    from kubernetes_tpu_torch.client.clientset import HTTPClient
    from kubernetes_tpu_torch.config.features import FeatureGate
    from kubernetes_tpu_torch.config.types import SchedulerConfiguration
    from kubernetes_tpu_torch.sched.runner import SchedulerRunner
    from kubernetes_tpu_torch.store.apiserver import APIServer

    make_pod = port_wrappers.make_pod
    server = APIServer().start()
    runner = None
    # preemption off: the descheduler's evictions alone must suffice
    gate = FeatureGate()
    gate.set("PreemptionSimulation", False)
    try:
        client = HTTPClient(server.url)
        nodes, _ = _fragmented(PORT, n=4, node_cpu="2")
        for n in nodes:
            client.nodes().create(n.to_dict())
        runner = SchedulerRunner(
            HTTPClient(server.url),
            SchedulerConfiguration(backoff_initial_s=0.05,
                                   backoff_max_s=0.2, assume_ttl_s=2.0),
            feature_gate=gate, device=D)
        runner.queue.unschedulable_timeout = 1.0
        runner.start()
        pods = client.pods("default")
        for i in range(4):
            pods.create(make_pod(f"filler-{i}").req({"cpu": "1"})
                        .node(f"n{i}").obj().to_dict())
        pods.create_many([make_pod(f"gang-{i}").label(GANG_LABEL, "train")
                          .priority(100).req({"cpu": "2"}).obj().to_dict()
                          for i in range(2)])
        time.sleep(1.0)
        assert not any(p["spec"].get("nodeName") for p in pods.list()
                       if p["metadata"]["name"].startswith("gang-"))
        d = port_desched.Descheduler(
            HTTPClient(server.url),
            port_desched.DeschedulerConfiguration(strategies={}), device=D)
        last_cycle = [0.0]

        def converged():
            live = pods.list()
            done = (sum(1 for p in live
                        if p["metadata"]["name"].startswith("gang-")
                        and p["spec"].get("nodeName")) == 2
                    and sum(1 for p in live
                            if p["metadata"]["name"].startswith("filler-")
                            and p["spec"].get("nodeName")) == 4)
            if not done and time.time() - last_cycle[0] > 2.0:
                last_cycle[0] = time.time()
                d.run_once()
            return done

        deadline = time.time() + 150.0
        while not converged() and time.time() < deadline:
            time.sleep(0.25)
        assert converged(), [(p["metadata"]["name"],
                              p["spec"].get("nodeName"))
                             for p in pods.list()]
        assert {n["metadata"]["name"] for n in client.nodes().list()} == \
            {f"n{i}" for i in range(4)}
        by_node = {}
        for p in pods.list():
            by_node.setdefault(p["spec"]["nodeName"], []).append(
                p["metadata"]["name"])
        for names in by_node.values():
            if any(n.startswith("gang-") for n in names):
                assert len(names) == 1
    finally:
        if runner is not None:
            runner.stop()
        server.stop()
