"""Admission in the port (``store/admission.py``, ``store/podsecurity.py``,
``store/webhooks.py``) against the JAX package's, on the CPU.

- Every admission case of ``tests/test_admission_apf.py`` and every case of
  ``tests/test_podsecurity.py`` and ``tests/test_webhooks.py`` runs on both
  packages through ``tests/torch_store_parity.py``: both pass, and their
  records (requests and answers with the admitted and mutated objects, the
  servers' stored objects) are equal.
- ``check_pod`` at the three levels on seeded pods built with the JAX
  package's wrappers, hardened or broken at random: the same violations.
- ``apply_json_patch`` on seeded patches: the same objects, the same
  refusals.
- The default chain: the same plugins in the same order.
- The dry-run gate, a deliberate difference (ROADMAP "Deliberate
  differences"): a ``?dryRun=All`` create matched by a webhook whose
  ``sideEffects`` is not ``None`` or ``NoneOnDryRun`` is refused with 400 by
  the port and the webhook is never called; the JAX package calls it and
  admits the request. With ``None`` or ``NoneOnDryRun`` both call it.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest

import torch_store_parity as parity
from kubernetes_tpu.client import clientset as ref_clientset
from kubernetes_tpu.store import admission as ref_admission
from kubernetes_tpu.store import apiserver as ref_apiserver
from kubernetes_tpu.store import podsecurity as ref_podsecurity
from kubernetes_tpu.store import store as ref_store
from kubernetes_tpu.store import webhooks as ref_webhooks
from kubernetes_tpu.testing.wrappers import make_pod
from kubernetes_tpu_torch.client import clientset as port_clientset
from kubernetes_tpu_torch.store import admission as port_admission
from kubernetes_tpu_torch.store import apiserver as port_apiserver
from kubernetes_tpu_torch.store import podsecurity as port_podsecurity
from kubernetes_tpu_torch.store import store as port_store
from kubernetes_tpu_torch.store import webhooks as port_webhooks

APF = ("test_flow_", "test_apf_", "test_shuffle_", "test_greedy_",
       "test_queueset_")
CASES = ([("test_admission_apf",) + c
          for c in parity.cases("test_admission_apf")
          if not c[1].startswith(APF)]
         + [("test_podsecurity",) + c for c in parity.cases("test_podsecurity")]
         + [("test_webhooks",) + c for c in parity.cases("test_webhooks")])


@pytest.fixture(scope="module")
def shared():
    yield from parity.shared_fixtures()


@pytest.mark.parametrize("name,fname,params",
                         [(c[0], c[2], c[3]) for c in CASES],
                         ids=[f"{c[0][5:]}::{c[1]}" for c in CASES])
def test_reference_case_on_both_packages(name, fname, params, tmp_path,
                                         shared):
    ref, port = parity.both(name, fname, params, tmp_path, shared)
    assert port == ref


def test_every_case_is_selected():
    assert len(CASES) == 7 + 8 + 7


# ---- PodSecurity --------------------------------------------------------

def _random_pod(rng, i: int) -> dict:
    pod = make_pod(f"p{i}").req({"cpu": "100m"}).obj().to_dict()
    spec = pod["spec"]
    for field in ("hostNetwork", "hostPID", "hostIPC"):
        if rng.rand() < 0.15:
            spec[field] = True
    if rng.rand() < 0.15:
        spec["volumes"] = [{"name": "h", "hostPath": {"path": "/var"}}]
    for c in spec["containers"]:
        sc = {}
        if rng.rand() < 0.15:
            sc["privileged"] = True
        if rng.rand() < 0.5:
            sc["allowPrivilegeEscalation"] = bool(rng.rand() < 0.3)
        if rng.rand() < 0.5:
            sc["runAsNonRoot"] = bool(rng.rand() < 0.7)
        if rng.rand() < 0.3:
            sc["runAsUser"] = int(rng.choice([0, 1000]))
        caps = {}
        if rng.rand() < 0.5:
            caps["drop"] = ["ALL"] if rng.rand() < 0.7 else ["NET_RAW"]
        if rng.rand() < 0.2:
            caps["add"] = [str(rng.choice(["NET_ADMIN", "CHOWN",
                                           "SYS_ADMIN"]))]
        if caps:
            sc["capabilities"] = caps
        if rng.rand() < 0.5:
            sc["seccompProfile"] = {"type": str(rng.choice(
                ["RuntimeDefault", "Localhost", "Unconfined"]))}
        if rng.rand() < 0.1:
            c["ports"] = [{"containerPort": 80, "hostPort": 8080}]
        if sc:
            c["securityContext"] = sc
    return pod


def test_check_pod_equal_on_seeded_pods():
    rng = np.random.RandomState(0)
    for i in range(200):
        pod = _random_pod(rng, i)
        for level in ("privileged", "baseline", "restricted"):
            assert (port_podsecurity.check_pod(level, copy.deepcopy(pod))
                    == ref_podsecurity.check_pod(level, copy.deepcopy(pod)))


# ---- webhooks -----------------------------------------------------------

def _random_patch(rng) -> list:
    ops = []
    for _ in range(int(rng.randint(1, 5))):
        kind = str(rng.choice(["add", "replace", "remove", "move"]))
        path = str(rng.choice(["/metadata/labels/a", "/spec/priority",
                               "/spec/containers/0/name",
                               "/spec/containers/-", "/metadata/labels",
                               "/spec/tolerations/0", "/a~1b"]))
        op = {"op": kind, "path": path}
        if kind != "remove":
            op["value"] = str(rng.choice(["x", "y"]))
        ops.append(op)
    return ops


def _patched(mod, obj, patch):
    try:
        return ("ok", mod.apply_json_patch(obj, patch))
    except Exception as e:  # the same refusal on both sides
        return ("error", type(e).__name__, str(e))


def test_apply_json_patch_equal_on_seeded_patches():
    rng = np.random.RandomState(1)
    base = make_pod("w").label("k", "v").obj().to_dict()
    base["spec"]["tolerations"] = [{"key": "t", "operator": "Exists"}]
    for _ in range(200):
        patch = _random_patch(rng)
        assert (_patched(port_webhooks, base, patch)
                == _patched(ref_webhooks, base, patch))


def test_default_chain_equal():
    def names(mod, store):
        chain = mod.default_chain(store)
        return ([getattr(f, "__name__", type(f).__name__)
                 for f in chain.mutating],
                [getattr(f, "__name__", type(f).__name__)
                 for f in chain.validating])
    assert (names(port_admission, port_store.ObjectStore())
            == names(ref_admission, ref_store.ObjectStore()))


# ---- the dry-run gate (ROADMAP "Deliberate differences") ----------------

SIDES = {"ref": (ref_apiserver, ref_clientset, ref_webhooks),
         "port": (port_apiserver, port_clientset, port_webhooks)}


def _dry_run_create(side: str, side_effects) -> tuple:
    """A validating webhook with ``side_effects`` (None: the field left
    out), then one dry-run pod create -> (status code or "created", the
    webhook's calls, pods stored)."""
    apiserver, clientset, webhooks = SIDES[side]
    hook = webhooks.WebhookTestServer(validate=lambda r: (True, "")).start()
    server = apiserver.APIServer()
    server.enable_admission()
    server.start()
    try:
        client = clientset.HTTPClient(server.url)
        wh = {"name": "audit.example.com", "clientConfig": {"url": hook.url},
              "rules": [{"operations": ["CREATE"], "resources": ["pods"]}],
              "failurePolicy": "Ignore"}
        if side_effects is not None:
            wh["sideEffects"] = side_effects
        client.resource("validatingwebhookconfigurations", None).create({
            "kind": "ValidatingWebhookConfiguration",
            "metadata": {"name": "audit"}, "webhooks": [wh]})
        try:
            client.pods("default").create(
                make_pod("ghost").obj().to_dict(), dry_run=True)
            code = "created"
        except clientset.ApiError as e:
            code = (e.code, "does not support dry run" in str(e))
        return code, hook.calls, len(client.pods("default").list())
    finally:
        server.stop()
        hook.stop()


@pytest.mark.parametrize("side_effects", [None, "Some", "Unknown"])
def test_dry_run_refused_for_webhook_with_side_effects(side_effects):
    assert _dry_run_create("ref", side_effects) == ("created", 1, 0)
    assert _dry_run_create("port", side_effects) == ((400, True), 0, 0)


@pytest.mark.parametrize("side_effects", ["None", "NoneOnDryRun"])
def test_dry_run_calls_webhook_without_side_effects(side_effects):
    assert (_dry_run_create("port", side_effects)
            == _dry_run_create("ref", side_effects) == ("created", 1, 0))
