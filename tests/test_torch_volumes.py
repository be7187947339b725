"""Volume scheduling and the volume binder in the port against the JAX
package, on the CPU.

- Every case of ``tests/test_volumes.py`` runs on both packages through
  ``tests/torch_store_parity.py``: both pass, and their records are equal.
  Its two end-to-end cases run the ``pvbinder`` controller of the port's
  ``ControllerManager`` beside the port's ``SchedulerRunner``, which the
  loader binds to the CPU.
- The connected runner binds pods that name PVCs (``sched/runner._bind`` →
  ``sched/volumebinding.VolumeBinder``): an unbound WaitForFirstConsumer
  claim gets the selected-node annotation, an Immediate claim bound to a
  zone-a volume holds its pod in zone a. Both runners place and annotate
  alike, and the port counts no loop error at ``bind_lifecycle``.
- A volume binding that fails after the pod's DRA claim was allocated
  unreserves the claim, and the pod stays unbound.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

import torch_store_parity as parity
from kubernetes_tpu.client import clientset as ref_clientset
from kubernetes_tpu.sched import runner as ref_runner
from kubernetes_tpu.store import store as ref_store
from kubernetes_tpu_torch.api import types as port_types
from kubernetes_tpu_torch.client import clientset as port_clientset
from kubernetes_tpu_torch.config.types import SchedulerConfiguration
from kubernetes_tpu_torch.metrics import registry as port_registry
from kubernetes_tpu_torch.sched import runner as port_runner
from kubernetes_tpu_torch.sched.volumebinding import (
    SELECTED_NODE_ANNOTATION,
    WAIT_FOR_FIRST_CONSUMER,
)
from kubernetes_tpu_torch.store import store as port_store
from kubernetes_tpu_torch.testing import workloads
from kubernetes_tpu_torch.testing.wrappers import make_node, make_pod

NAME = "test_volumes"
CASES = parity.cases(NAME)
ZONE = "topology.kubernetes.io/zone"

REF = SimpleNamespace(name="ref", store=ref_store, clientset=ref_clientset,
                      runner=ref_runner, kw={})
PORT = SimpleNamespace(name="port", store=port_store,
                       clientset=port_clientset, runner=port_runner,
                       kw={"device": "cpu"})


@pytest.fixture(scope="module")
def shared():
    yield from parity.shared_fixtures()


@pytest.mark.parametrize("fname,params", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_reference_case_on_both_packages(fname, params, tmp_path, shared):
    ref, port = parity.both(NAME, fname, params, tmp_path, shared)
    assert port == ref


def test_volume_cases_are_selected():
    assert len(CASES) == 15


def _wait_until(fn, timeout=20.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if fn():
            return True
        time.sleep(0.05)
    return fn()


def _node(name, zone):
    return make_node(name).label(ZONE, zone).allocatable(
        {"cpu": "4", "memory": "8Gi", "pods": "20"}).obj().to_dict()


def _pvc(name, sc="", volume_name=""):
    spec = {"accessModes": ["ReadWriteOnce"],
            "resources": {"requests": {"storage": "5Gi"}},
            "storageClassName": sc}
    if volume_name:
        spec["volumeName"] = volume_name
    return {"apiVersion": "v1", "kind": "PersistentVolumeClaim",
            "metadata": {"name": name, "namespace": "default"},
            "spec": spec, "status": {"phase": "Bound"} if volume_name else {}}


def _zone_pv(name, zone, claim):
    return {"apiVersion": "v1", "kind": "PersistentVolume",
            "metadata": {"name": name, "labels": {ZONE: zone}},
            "spec": {"capacity": {"storage": "10Gi"},
                     "accessModes": ["ReadWriteOnce"],
                     "storageClassName": "",
                     "claimRef": {"namespace": "default", "name": claim},
                     "nodeAffinity": {"required": {"nodeSelectorTerms": [
                         {"matchExpressions": [{"key": ZONE, "operator": "In",
                                                "values": [zone]}]}]}}},
            "status": {"phase": "Bound"}}


def _pvc_pod(name, claim, dra_claim=""):
    p = make_pod(name).req({"cpu": "100m"}).obj().to_dict()
    p["spec"]["volumes"] = [{"name": "v0", "persistentVolumeClaim":
                             {"claimName": claim}}]
    return workloads.with_claim(p, dra_claim) if dra_claim else p


def _bind_pvc_pods(P) -> dict:
    client = P.clientset.DirectClient(P.store.ObjectStore())
    for z in ("a", "b"):
        client.nodes().create(_node(f"vn-{z}", z))
    client.resource("storageclasses", None).create({
        "apiVersion": "storage.k8s.io/v1", "kind": "StorageClass",
        "metadata": {"name": "fast"}, "provisioner": "csi.example.com",
        "volumeBindingMode": WAIT_FOR_FIRST_CONSUMER})
    client.resource("persistentvolumeclaims").create(_pvc("data", sc="fast"))
    client.resource("persistentvolumes", None).create(
        _zone_pv("static-a", "a", "disk"))
    client.resource("persistentvolumeclaims").create(
        _pvc("disk", volume_name="static-a"))
    runner = P.runner.SchedulerRunner(client, **P.kw).start()
    try:
        assert _wait_until(lambda: runner.cache.volume_catalog is not None
                           and len(runner.cache.volume_catalog.pvcs) == 2)
        client.pods().create(_pvc_pod("late", "data"))
        client.pods().create(_pvc_pod("pinned", "disk"))
        assert _wait_until(lambda: all(
            client.pods().get(n)["spec"].get("nodeName")
            for n in ("late", "pinned")))
    finally:
        runner.stop()
    pvcs = client.resource("persistentvolumeclaims")
    return {"late": client.pods().get("late")["spec"]["nodeName"],
            "pinned": client.pods().get("pinned")["spec"]["nodeName"],
            "selected": (pvcs.get("data")["metadata"].get("annotations")
                         or {}).get(SELECTED_NODE_ANNOTATION),
            "disk": pvcs.get("disk")["spec"].get("volumeName")}


def test_connected_runner_binds_pods_with_volume_claims():
    errors = port_registry.LOOP_ERRORS
    before = errors.get({"site": "bind_lifecycle"})
    port = _bind_pvc_pods(PORT)
    assert errors.get({"site": "bind_lifecycle"}) == before
    assert port["selected"] == port["late"]
    assert port["late"] in ("vn-a", "vn-b")
    assert port["pinned"] == "vn-a"
    assert port["disk"] == "static-a"
    assert _bind_pvc_pods(REF) == port


def test_volume_bind_failure_unreserves_claim():
    """The pod's PVC matches no volume and no class can provision it, so
    ``VolumeBinder`` refuses after the runner allocated the pod's DRA
    claim: the claim is released and the pod is not bound."""
    client = port_clientset.DirectClient(port_store.ObjectStore())
    cfg = SchedulerConfiguration(explainer_enabled=False,
                                 parity_sample_every=0)
    runner = port_runner.SchedulerRunner(client, cfg, device="cpu")
    try:
        client.nodes().create(_node("n0", "a"))
        client.resource("resourceslices", None).create(
            workloads.resource_slice("n0", 2, name="s0"))
        client.resource("resourceclaims", "default").create(
            workloads.resource_claim("c0"))
        client.resource("persistentvolumeclaims").create(_pvc("nowhere"))
        client.pods().create(_pvc_pod("p", "nowhere", dra_claim="c0"))
        runner.start(start_loop=False)
        assert _wait_until(
            lambda: runner.cache.dra_catalog is not None
            and len(runner.cache.dra_catalog.claims) == 1
            and runner.cache.volume_catalog is not None
            and len(runner.cache.volume_catalog.pvcs) == 1)
        writes = []
        client.prepend_reactor("update", "resourceclaims", lambda obj: (
            writes.append(bool((obj.get("status") or {}).get("allocation")))
            or obj))
        pod = port_types.Pod.from_dict(client.pods().get("p"))
        assert runner._bind(pod, "n0") is False
        assert writes == [True, False]  # the allocation, then its release
        status = client.resource("resourceclaims", "default").get(
            "c0").get("status") or {}
        assert not status.get("allocation")
        assert not status.get("reservedFor")
        assert not client.pods().get("p")["spec"].get("nodeName")
    finally:
        runner.stop()
