"""The autoscaler's and the descheduler's own loops (``start``/``stop``) on
both packages, on the CPU.

Each package's ``ClusterAutoscaler.start(interval)`` scales a node group
up for a pending pod on its own thread, and ``Descheduler.start()`` runs
every ``config.interval_s``; both publish their status ConfigMap, and the
two packages end in the same state. A failed iteration is logged and the
loop goes on, on both. A fatal error (``sched/faults.is_fatal``: here a
``KernelError``) stops the port's loop for good and is kept as
``loop_error``, where the reference's loop logs it and goes on: a
deliberate difference, shown on both packages.
"""

from __future__ import annotations

import json
import time
from types import SimpleNamespace

import pytest

import kubernetes_tpu.autoscaler as ref_autoscaler
import kubernetes_tpu.descheduler as ref_desched
import kubernetes_tpu_torch.autoscaler as port_autoscaler
import kubernetes_tpu_torch.descheduler as port_desched
from kubernetes_tpu.client import clientset as ref_clientset
from kubernetes_tpu.store import store as ref_store
from kubernetes_tpu.testing import wrappers as ref_wrappers
from kubernetes_tpu_torch.client import clientset as port_clientset
from kubernetes_tpu_torch.ops.kernels import KernelError
from kubernetes_tpu_torch.store import store as port_store
from kubernetes_tpu_torch.testing import wrappers as port_wrappers

REF = SimpleNamespace(
    name="ref", autoscaler=ref_autoscaler, desched=ref_desched,
    wrappers=ref_wrappers, kw={},
    client=lambda: ref_clientset.DirectClient(ref_store.ObjectStore()))
PORT = SimpleNamespace(
    name="port", autoscaler=port_autoscaler, desched=port_desched,
    wrappers=port_wrappers, kw={"device": "cpu"},
    client=lambda: port_clientset.DirectClient(port_store.ObjectStore()))
INTERVAL_S = 0.05


def wait_for(fn, timeout: float = 20.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        got = fn()
        if got:
            return got
        time.sleep(0.02)
    return fn()


def _autoscaler(P):
    """A ClusterAutoscaler over an empty group and one pending pod."""
    client = P.client()
    tpl = P.wrappers.make_node("pool-tpl").capacity({"cpu": "2",
                                                     "pods": "10"})
    provider = P.autoscaler.StaticNodeGroupProvider(
        client, [P.autoscaler.NodeGroup("pool", 0, 3, tpl.obj())])
    client.pods("default").create(
        P.wrappers.make_pod("p0").req({"cpu": "1"}).obj().to_dict())
    return client, provider, P.autoscaler.ClusterAutoscaler(
        client, provider, **P.kw)


def _status(client, name) -> dict:
    cm = client.resource("configmaps", "default").get(name)
    return json.loads(cm["data"]["status"])


def test_autoscaler_loop_scales_up_and_stops():
    got = []
    for P in (REF, PORT):
        client, provider, ca = _autoscaler(P)
        ca.start(interval=INTERVAL_S)
        try:
            assert wait_for(lambda: provider.target_size("pool") == 1)
            assert wait_for(lambda: any(
                c["metadata"]["name"] == P.autoscaler.STATUS_CONFIGMAP
                for c in client.resource("configmaps", "default").list()))
        finally:
            ca.stop()
        assert not ca._thread.is_alive()
        status = _status(client, P.autoscaler.STATUS_CONFIGMAP)
        got.append((sorted(n["metadata"]["name"].split("-")[0]
                           for n in client.nodes().list()),
                    status["groups"]["pool"]["size"],
                    sorted(status["lastLoop"])))
    assert got[1] == got[0]
    assert got[1][:2] == (["pool"], 1)


def test_descheduler_loop_reads_interval_s_and_publishes():
    got = []
    for P in (REF, PORT):
        client = P.client()
        for i in range(2):
            client.nodes().create(P.wrappers.make_node(f"n{i}").capacity(
                {"cpu": "4", "pods": "10"}).obj().to_dict())
        cfg = P.desched.DeschedulerConfiguration(interval_s=INTERVAL_S)
        d = P.desched.Descheduler(client, cfg, **P.kw)
        calls = []
        run_once = d.run_once

        def counted(run_once=run_once, calls=calls):
            calls.append(time.monotonic())
            return run_once()

        d.run_once = counted
        d.start()
        try:
            assert wait_for(lambda: len(calls) >= 3)
        finally:
            d.stop()
        assert not d._thread.is_alive()
        status = _status(client, P.desched.STATUS_CONFIGMAP)
        got.append((status["strategies"], status["gangDefrag"],
                    sorted(status["lastLoop"])))
        # every interval_s, not the default of 60 s
        assert calls[2] - calls[0] < 10.0
    assert got[1] == got[0]


def _looped(P, kind: str, errors: list):
    """A started loop of ``kind`` whose ``run_once`` raises the queued
    errors, then returns -> (planner, call times)."""
    if kind == "autoscaler":
        _client, _provider, planner = _autoscaler(P)
    else:
        planner = P.desched.Descheduler(
            P.client(), P.desched.DeschedulerConfiguration(
                interval_s=INTERVAL_S), **P.kw)
    calls = []

    def run_once():
        calls.append(time.monotonic())
        if errors:
            raise errors.pop(0)
        return {}

    planner.run_once = run_once
    planner.start(interval=INTERVAL_S)
    return planner, calls


@pytest.mark.parametrize("kind", ["autoscaler", "descheduler"])
def test_failed_iteration_is_logged_and_the_loop_goes_on(kind, caplog):
    for P in (REF, PORT):
        planner, calls = _looped(P, kind, [RuntimeError("boom"),
                                           ValueError("bad")])
        try:
            assert wait_for(lambda: len(calls) >= 4)
        finally:
            planner.stop()
        assert getattr(planner, "loop_error", None) is None
    failed = [r for r in caplog.records if r.exc_info]
    assert len(failed) >= 4  # two a package
    assert {str(r.exc_info[1]) for r in failed} == {"boom", "bad"}


@pytest.mark.parametrize("kind", ["autoscaler", "descheduler"])
def test_fatal_error_stops_only_the_ports_loop(kind):
    fatal = KernelError("count_pn launch failed")
    ref, ref_calls = _looped(REF, kind, [fatal])
    port, port_calls = _looped(PORT, kind, [fatal])
    try:
        # the reference logs it and goes on
        assert wait_for(lambda: len(ref_calls) >= 3)
        assert wait_for(lambda: not port._thread.is_alive(), 5.0)
        time.sleep(5 * INTERVAL_S)
    finally:
        ref.stop()
        port.stop()
    assert len(port_calls) == 1
    assert port.loop_error is fatal
    assert not hasattr(ref, "loop_error")
