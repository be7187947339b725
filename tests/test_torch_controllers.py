"""The port's controllers (``kubernetes_tpu_torch/controllers/``) against
the JAX package's, on the CPU.

Every case of ``tests/test_controllers.py`` (ReplicaSet, Deployment, Job,
DaemonSet, StatefulSet, Endpoints, node lifecycle, the garbage collector,
the controller manager), ``tests/test_controllers_breadth.py`` (CronJob,
TTL-after-finished, HPA, namespace, pod GC, ReplicationController, the
service-account and token controllers, EndpointSlice and its mirroring,
the root-CA publisher) and ``tests/test_controllers_quota_ttl_agg.py``
(ResourceQuota, node TTL, ClusterRole aggregation) runs on both packages
through ``tests/torch_store_parity.py``: both pass, and their records (the
stores their clients wrote, once the controllers are quiet) are equal.

The manager itself: the same controller names, default and cloud, and the
same exports. A deliberate difference: the port's ``HTTPClient`` keeps its
URLs as ``urls``, so the endpoints controller works over HTTP; the
reference's ``endpoints`` list hides the ``endpoints(ns)`` handle.
"""

from __future__ import annotations

import time

import pytest

import torch_store_parity as parity
from kubernetes_tpu import controllers as ref_controllers
from kubernetes_tpu.client import clientset as ref_clientset
from kubernetes_tpu.controllers import manager as ref_manager
from kubernetes_tpu.store import apiserver as ref_apiserver
from kubernetes_tpu_torch import controllers as port_controllers
from kubernetes_tpu_torch.client import clientset as port_clientset
from kubernetes_tpu_torch.controllers import manager as port_manager
from kubernetes_tpu_torch.store import apiserver as port_apiserver

NAMES = ("test_controllers", "test_controllers_breadth",
         "test_controllers_quota_ttl_agg")
CASES = [(name, *c) for name in NAMES for c in parity.cases(name)]


@pytest.fixture(scope="module")
def shared():
    yield from parity.shared_fixtures()


@pytest.mark.parametrize("name,fname,params", [c[:1] + c[2:] for c in CASES],
                         ids=[f"{c[0]}::{c[1]}" for c in CASES])
def test_reference_case_on_both_packages(name, fname, params, tmp_path,
                                         shared):
    ref, port = parity.both(name, fname, params, tmp_path, shared)
    assert port == ref


def test_controller_cases_are_selected():
    assert [sum(c[0] == n for c in CASES) for n in NAMES] == [14, 17, 5]


def test_manager_starts_the_reference_controllers():
    assert port_manager.DEFAULT_CONTROLLERS == ref_manager.DEFAULT_CONTROLLERS
    assert port_manager.CLOUD_CONTROLLERS == ref_manager.CLOUD_CONTROLLERS
    assert port_controllers.__all__ == ref_controllers.__all__
    assert len(port_manager.DEFAULT_CONTROLLERS) == 31


def _endpoints_over_http(apiserver, clientset, manager, done) -> list:
    """A Service and one ready pod behind an APIServer, the endpoints
    controller in a manager over HTTP -> the Endpoints objects written once
    ``done(controller, endpoints)`` (at most 30 s)."""
    server = apiserver.APIServer().start()
    mgr = None
    try:
        client = clientset.HTTPClient(server.url, wire="json")
        mgr = manager.ControllerManager(
            clientset.HTTPClient(server.url, wire="json"),
            controllers=("endpoints",), gc_enabled=False).start()
        client.services("default").create({
            "apiVersion": "v1", "kind": "Service",
            "metadata": {"name": "web", "namespace": "default"},
            "spec": {"selector": {"app": "web"},
                     "ports": [{"port": 80, "targetPort": 8080}]}})
        client.pods("default").create({
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": "w0", "namespace": "default",
                         "labels": {"app": "web"}},
            "spec": {"nodeName": "n0", "containers": [{"name": "c"}]},
            "status": {"phase": "Running", "podIP": "10.0.0.1",
                       "conditions": [{"type": "Ready", "status": "True"}]}})
        end = time.monotonic() + 30.0
        while time.monotonic() < end and not done(
                mgr.controllers[0],
                client.resource("endpoints", "default").list()):
            time.sleep(0.05)
        return client.resource("endpoints", "default").list()
    finally:
        if mgr is not None:
            mgr.stop()
        server.stop()


def test_endpoints_controller_over_http():
    # the Service's first sync may run before the informer saw the pod and
    # write an Endpoints with no address: wait for the address
    got = _endpoints_over_http(
        port_apiserver, port_clientset, port_manager,
        lambda ctrl, eps: any(s.get("addresses") for e in eps
                              for s in e.get("subsets") or []))
    assert [[a["ip"] for s in e["subsets"] for a in s["addresses"]]
            for e in got] == [["10.0.0.1"]]
    # the reference's client: the URL list hides the handle, and its
    # controller's sync of the Service raises TypeError, writing nothing
    assert not callable(ref_clientset.HTTPClient("http://127.0.0.1:9")
                        .endpoints)
    assert _endpoints_over_http(
        ref_apiserver, ref_clientset, ref_manager,
        lambda ctrl, eps: ctrl.queue.num_requeues("default/web")) == []


def test_label_and_controller_indexes_answer_as_a_walk():
    """The port's informer indexes (``controllers/base.LABEL_INDEX``,
    ``CONTROLLER_INDEX``) give the controllers the pods a walk of the whole
    cache gives, in its order, through a seeded run of adds, relabels,
    re-owners and deletes; an indexer added to a filled store indexes what
    it holds."""
    import random
    from kubernetes_tpu_torch.client.informer import ThreadSafeStore
    from kubernetes_tpu_torch.controllers import base
    rng = random.Random(0)
    store = ThreadSafeStore()
    owners = ["u0", "u1", "u2"]

    def pod(i):
        labels = {k: rng.choice(["a", "b"]) for k in ("app", "tier")
                  if rng.random() < 0.8}
        md = {"name": f"p{i}", "namespace": rng.choice(["ns0", "ns1"]),
              "labels": labels}
        if rng.random() < 0.7:
            md["ownerReferences"] = [{"uid": rng.choice(owners),
                                      "controller": rng.random() < 0.9}]
        return {"metadata": md}

    for step in range(400):
        i = rng.randrange(60)
        if rng.random() < 0.2:
            store.delete(f"k{i}")
        else:
            store.add(f"k{i}", pod(i))
        if step == 50:
            store.add_indexers({base.LABEL_INDEX: base.namespace_labels,
                                base.CONTROLLER_INDEX: base.controller_uid})
        if step < 50:
            # a store without an indexer keeps no order bookkeeping (the
            # scheduler's informers pay nothing for the controllers' index)
            assert not store._order
            continue
        for ns in ("ns0", "ns1"):
            for sel in ({"app": "a"}, {"app": "b", "tier": "a"},
                        {"tier": "b"}):
                walk = [p for p in store.list()
                        if p["metadata"]["namespace"] == ns
                        and all(p["metadata"]["labels"].get(k) == v
                                for k, v in sel.items())]
                assert base.selected(store, ns, sel) == walk
        for uid in owners:
            walk = [p for p in store.list()
                    if (base.controller_of(p) or {}).get("uid") == uid]
            assert store.by_index(base.CONTROLLER_INDEX, uid) == walk
