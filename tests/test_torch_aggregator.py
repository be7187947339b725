"""API aggregation in the port (``store/aggregator.py``) against the JAX
package's, on the CPU.

- Every case of ``tests/test_aggregation_scheme.py`` (delegation, an
  APIService proxying a group, the 503 of a dead backend, the HPA's
  multi-version conversion over GET, list, watch, server-side apply and
  status, authentication before proxying, a watch streamed through the
  proxy) runs on both packages through ``tests/torch_store_parity.py``:
  both pass, and their records (requests and answers, both servers'
  stores) are equal.
- Routing across the packages: the port's aggregator in front of the JAX
  package's APIServer, and the other way round, land the same objects in
  the backend, and answer the same for the groups they do not proxy.
"""

from __future__ import annotations

import pytest

import torch_store_parity as parity
from kubernetes_tpu.client import clientset as ref_clientset
from kubernetes_tpu.store import aggregator as ref_aggregator
from kubernetes_tpu.store import apiserver as ref_apiserver
from kubernetes_tpu_torch.client import clientset as port_clientset
from kubernetes_tpu_torch.store import aggregator as port_aggregator
from kubernetes_tpu_torch.store import apiserver as port_apiserver

NAME = "test_aggregation_scheme"
CASES = parity.cases(NAME)


@pytest.fixture(scope="module")
def shared():
    yield from parity.shared_fixtures()


@pytest.mark.parametrize("fname,params", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_reference_case_on_both_packages(fname, params, tmp_path, shared):
    ref, port = parity.both(NAME, fname, params, tmp_path, shared)
    assert port == ref


def _route(aggregator_mod, clientset_mod, backend_mod) -> dict:
    backend = backend_mod.APIServer().start()
    front = aggregator_mod.AggregatedAPIServer().start()
    try:
        front.register_api_service("apps", "v1", backend.url)
        c = clientset_mod.HTTPClient(front.url, wire="json")
        c.resource("deployments", "default").create(
            {"kind": "Deployment", "metadata": {"name": "d1"},
             "spec": {"replicas": 2}})
        c.pods("default").create({"kind": "Pod", "metadata": {"name": "p1"},
                                  "spec": {"containers": []}})
        in_backend = sorted(
            (o["kind"], o["metadata"]["name"])
            for kind in ("Deployment", "Pod")
            for o in backend.store.list(kind)[0])
        in_front = sorted(
            (o["kind"], o["metadata"]["name"])
            for kind in ("Deployment", "Pod")
            for o in front.core.store.list(kind)[0])
        return {"backend": in_backend, "front": in_front,
                "read": c.resource("deployments", "default").get("d1")[
                    "spec"]["replicas"]}
    finally:
        front.stop()
        backend.stop()


def test_routing_across_packages():
    want = {"backend": [("Deployment", "d1")], "front": [("Pod", "p1")],
            "read": 2}
    assert _route(port_aggregator, port_clientset, ref_apiserver) == want
    assert _route(ref_aggregator, ref_clientset, port_apiserver) == want
    assert _route(port_aggregator, port_clientset, port_apiserver) == want
