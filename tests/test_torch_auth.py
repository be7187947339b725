"""Authentication, RBAC and the audit log in the port (``store/auth.py`` and
the apiserver's handler chain) against the JAX package's, on the CPU.

- Every case of ``tests/test_auth.py`` runs on both packages through
  ``tests/torch_store_parity.py``: both pass, and their records (status
  codes and reasons, the stored objects, the audit events) are equal.
- RBAC decisions under ``bootstrap_policy()`` plus seeded roles and
  bindings, for seeded users, verbs, resources, namespaces and names:
  equal, and so are ``can_impersonate``, ``request_verb``, ``resource_for``
  and ``TokenAuthenticator``'s answers.
- Both runners as ``system:kube-scheduler`` under ``bootstrap_policy()``,
  each behind its own package's APIServer with authentication on: every
  pod bound, and the same 403s, by verb and resource: the policy has no
  rule for ConfigMaps (the status publishes) or for the DRA kinds the
  informers list, and none is on ``pods/binding`` or ``pods/status``.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

import torch_store_parity as parity
from kubernetes_tpu.client import clientset as ref_clientset
from kubernetes_tpu.config import types as ref_config
from kubernetes_tpu.sched import runner as ref_runner
from kubernetes_tpu.store import apiserver as ref_apiserver
from kubernetes_tpu.store import auth as ref_auth
from kubernetes_tpu.store import store as ref_store
from kubernetes_tpu.testing.wrappers import make_node, make_pod
from kubernetes_tpu_torch.client import clientset as port_clientset
from kubernetes_tpu_torch.config import types as port_config
from kubernetes_tpu_torch.sched import runner as port_runner
from kubernetes_tpu_torch.store import apiserver as port_apiserver
from kubernetes_tpu_torch.store import auth as port_auth
from kubernetes_tpu_torch.store import store as port_store

NAME = "test_auth"
CASES = parity.cases(NAME)


@pytest.fixture(scope="module")
def shared():
    yield from parity.shared_fixtures()


@pytest.mark.parametrize("fname,params", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_reference_case_on_both_packages(fname, params, tmp_path, shared):
    ref, port = parity.both(NAME, fname, params, tmp_path, shared)
    assert port == ref


# ---- RBAC decisions -------------------------------------------------------

RESOURCES = ["pods", "nodes", "pods/binding", "pods/status", "configmaps",
             "events", "leases", "secrets", "deployments", "users", "groups",
             "pods/eviction", "namespaces"]
VERBS = ["get", "list", "watch", "create", "update", "patch", "delete",
         "impersonate"]
USERS = [("system:kube-scheduler", ()), ("system:kube-controller-manager", ()),
         ("alice", ("view",)), ("bob", ("app-team",)), ("root", ("system:masters",)),
         ("system:anonymous", ("system:unauthenticated",)),
         ("system:serviceaccount:team-a:deployer", ("system:serviceaccounts",))]


def _policy(seed: int) -> list:
    """``bootstrap_policy()`` and seeded roles and bindings on top."""
    rng = np.random.RandomState(seed)
    objs = ref_auth.bootstrap_policy()
    for i in range(6):
        rules = [{"verbs": sorted(set(rng.choice(VERBS, 2))),
                  "resources": sorted(set(rng.choice(RESOURCES, 3)))}]
        if rng.rand() < 0.3:
            rules[0]["resourceNames"] = ["n1", "p1"]
        cluster = rng.rand() < 0.5
        ns = str(rng.choice(["team-a", "team-b"]))
        kind = "ClusterRole" if cluster else "Role"
        role = {"kind": kind, "metadata": {"name": f"r{i}"}, "rules": rules}
        subj = [{"kind": "Group", "name": "view"},
                {"kind": "User", "name": "bob"},
                {"kind": "ServiceAccount", "namespace": "team-a",
                 "name": "deployer"}][int(rng.randint(3))]
        binding = {"kind": "ClusterRoleBinding" if cluster else "RoleBinding",
                   "metadata": {"name": f"b{i}"}, "subjects": [subj],
                   "roleRef": {"kind": kind, "name": f"r{i}"}}
        if not cluster:
            role["metadata"]["namespace"] = ns
            binding["metadata"]["namespace"] = ns
        objs += [role, binding]
    return objs


def _decisions(auth_mod, store_mod, seed: int) -> list:
    store = store_mod.ObjectStore()
    for obj in _policy(seed):
        store.create(obj["kind"], obj)
    az = auth_mod.RBACAuthorizer(store)
    rng = np.random.RandomState(seed + 100)
    out = []
    for _ in range(400):
        name, groups = USERS[int(rng.randint(len(USERS)))]
        user = auth_mod.UserInfo(name, groups)
        verb, res = str(rng.choice(VERBS)), str(rng.choice(RESOURCES))
        ns = str(rng.choice(["", "team-a", "team-b", "default"]))
        obj_name = str(rng.choice(["", "n1", "p1", "x"]))
        out.append((name, verb, res, ns, obj_name,
                    az.authorize(user, verb, res, ns, obj_name),
                    az.can_impersonate(user, tuple(groups))))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rbac_decisions_equal(seed):
    port = _decisions(port_auth, port_store, seed)
    assert port == _decisions(ref_auth, ref_store, seed)
    assert any(d[5] for d in port) and not all(d[5] for d in port)


def test_bootstrap_policy_and_verb_mapping_equal():
    assert port_auth.bootstrap_policy() == ref_auth.bootstrap_policy()
    for method in ("GET", "POST", "PUT", "PATCH", "DELETE", "HEAD"):
        for name in (None, "p"):
            for sub in (None, "status", "binding"):
                for query in ("", "watch=true", "labelSelector=a"):
                    assert (port_auth.request_verb(method, name, sub, query)
                            == ref_auth.request_verb(method, name, sub, query))
                assert (port_auth.resource_for("pods", sub)
                        == ref_auth.resource_for("pods", sub))


def _authenticated(auth_mod, header, anonymous):
    az = auth_mod.TokenAuthenticator(
        tokens={"t1": ("alice", ("g",)), "t2": "bob"},
        allow_anonymous=anonymous)
    try:
        u = az.authenticate(header)
        return u.name, tuple(u.groups), sorted(u.all_groups())
    except auth_mod.AuthError as e:
        return "AuthError", str(e)


@pytest.mark.parametrize("anonymous", [True, False])
def test_token_authentication_equal(anonymous):
    for header in ("", "Bearer t1", "bearer t2", "Bearer nope", "Basic x",
                   "Bearer  t1 "):
        assert (_authenticated(port_auth, header, anonymous)
                == _authenticated(ref_auth, header, anonymous))


# ---- both runners as system:kube-scheduler --------------------------------

SIDES = {"ref": (ref_apiserver, ref_clientset, ref_config, ref_runner),
         "port": (port_apiserver, port_clientset, port_config, port_runner)}


def _resource(uri: str) -> str:
    """``/api/v1/namespaces/ns/pods/p/binding?x`` -> ``pods/binding``."""
    path = uri.split("?")[0]
    parts = [p for p in path.split("/") if p]
    parts = parts[2:] if parts[0] == "api" else parts[3:]
    if parts and parts[0] == "namespaces" and len(parts) > 2:
        parts = parts[2:]
    plural = parts[0] if parts else ""
    return plural + (f"/{parts[2]}" if len(parts) > 2 else "")


def _scheduler_403s(side: str) -> tuple:
    """One runner as system:kube-scheduler behind its package's APIServer
    -> (its 403s as sorted (verb, resource), pods bound)."""
    apiserver, clientset, config, runner_mod = SIDES[side]
    server = apiserver.APIServer().enable_auth()
    server.authenticator.add("admin", ("system:admin", ("system:masters",)))
    server.authenticator.add("sched", ("system:kube-scheduler", ()))
    server.enable_admission()
    server.start()
    admin = clientset.HTTPClient(server.url, token="admin")
    runner = None
    try:
        for i in range(6):
            admin.nodes().create(make_node(f"n{i}").capacity(
                {"cpu": "4", "memory": "8Gi", "pods": "10"}).obj().to_dict())
        for i in range(12):
            admin.pods("default").create(
                make_pod(f"p{i}").req({"cpu": "500m"}).obj().to_dict())
        cfg = config.SchedulerConfiguration(batch_size=8,
                                            max_drain_batches=1)
        client = clientset.HTTPClient(server.url, token="sched")
        kw = {"device": "cpu"} if side == "port" else {}
        runner = runner_mod.SchedulerRunner(client, cfg, **kw)
        runner.start()
        deadline = time.time() + 120.0
        while time.time() < deadline:
            if all(p["spec"].get("nodeName")
                   for p in admin.pods("default").list()):
                break
            time.sleep(0.1)
        runner.publish_status()
        bound = sum(1 for p in admin.pods("default").list()
                    if p["spec"].get("nodeName"))
    finally:
        if runner is not None:
            runner.stop()
        server.stop()
    events = [e for e in server.audit.events
              if e["user"] == "system:kube-scheduler"]
    denied = sorted({(e["verb"], _resource(e["requestURI"]))
                     for e in events if e["code"] == 403})
    return denied, bound


def test_runners_get_the_same_403s_as_the_scheduler():
    port = _scheduler_403s("port")
    ref = _scheduler_403s("ref")
    assert port == ref
    denied, bound = port
    assert bound == 12
    assert "configmaps" in {res for _verb, res in denied}
    assert not any(res in ("pods/binding", "pods/status")
                   for _verb, res in denied)
