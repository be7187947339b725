"""The port's invariant auditor against the reference's.

The overcommit cases of ``tests/test_audit.py`` run through both
packages' ``InvariantAuditor`` on the same objects. Then the one place
where the port's snapshot differs: the scheduler evicts a victim and
assumes its preemptor on the freed node while a sweep is listing the
API. The reference takes the API's pods before the cache's assumes, so a
sweep can hold the victim (listed before its delete) beside the
preemptor's assume (taken after it) and report an overcommit that never
existed. The port takes the cache's view first: an assume it holds was
made after its victims' deletes returned, so the API lists that follow
no longer show them (ROADMAP, "Deliberate differences")."""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

import pytest

from kubernetes_tpu.audit.auditor import InvariantAuditor as RefAuditor
from kubernetes_tpu.client.clientset import DirectClient as RefClient
from kubernetes_tpu.sched.cache import SchedulerCache as RefCache
from kubernetes_tpu.store.store import ObjectStore as RefStore
from kubernetes_tpu.testing import wrappers as ref_wrappers
from kubernetes_tpu_torch.audit.auditor import InvariantAuditor as PortAuditor
from kubernetes_tpu_torch.client.clientset import DirectClient as PortClient
from kubernetes_tpu_torch.sched.cache import SchedulerCache as PortCache
from kubernetes_tpu_torch.store.store import ObjectStore as PortStore
from kubernetes_tpu_torch.testing import wrappers as port_wrappers

PKGS = {
    "ref": SimpleNamespace(auditor=RefAuditor, client=RefClient,
                           cache=RefCache, store=RefStore, w=ref_wrappers),
    "port": SimpleNamespace(auditor=PortAuditor, client=PortClient,
                            cache=PortCache, store=PortStore,
                            w=port_wrappers),
}
TPU = "google.com/tpu"


def _node(P, name="n0", cpu="2", tpu=None):
    cap = {"cpu": cpu, "memory": "4Gi", "pods": "10"}
    if tpu is not None:
        cap[TPU] = tpu
    return P.w.make_node(name).capacity(cap).obj()


def _outcome(fresh, auditor, tmp_path):
    bundles = sorted(f for f in os.listdir(tmp_path) if f.endswith(".json"))
    payloads = [json.loads((tmp_path / f).read_text()) for f in bundles]
    return {"fresh": [(v.invariant, v.detail) for v in fresh],
            "objects": [p["objects"] for p in payloads],
            "status": {k: auditor.status()[k]
                       for k in ("violations", "byInvariant")}}


def _overcommit_bound(P, tmp_path):
    store = P.store()
    client = P.client(store)
    client.nodes().create(_node(P).to_dict())
    for i in range(2):
        client.pods().create(P.w.make_pod(f"p{i}").req({"cpu": "1500m"})
                             .node("n0").obj().to_dict())
    auditor = P.auditor(client=client, audit_dir=str(tmp_path))
    first = _outcome(auditor.run_once(), auditor, tmp_path)
    again = auditor.run_once()  # the same corruption is not re-counted
    return first, [v.invariant for v in again], auditor.total_violations


def _overcommit_assumed(P, tmp_path):
    store = P.store()
    client = P.client(store)
    client.nodes().create(_node(P).to_dict())
    cache = P.cache()
    cache.add_node(_node(P))
    for i in range(2):
        pod = P.w.make_pod(f"a{i}").req({"cpu": "1500m"}).obj()
        client.pods().create(pod.to_dict())  # pending in the API
        cache.assume(pod, "n0")              # double-booked by assume
    auditor = P.auditor(client=client, cache=cache,
                        audit_dir=str(tmp_path))
    return _outcome(auditor.run_once(), auditor, tmp_path)


@pytest.mark.parametrize("case", ["bound", "assumed"])
def test_overcommit_detected_as_reference(case, tmp_path):
    """An overcommit in the API's bindings, and one born of the cache's
    assumes, are reported in the first sweep by both auditors, with the
    same detail and repro objects."""
    run = _overcommit_bound if case == "bound" else _overcommit_assumed
    out = {}
    for name, P in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        out[name] = run(P, d)
    assert out["port"] == out["ref"]
    first = out["port"][0] if case == "bound" else out["port"]
    assert [inv for inv, _d in first["fresh"]] == ["node_overcommit"]
    if case == "bound":
        assert out["port"][1:] == ([], 1)


class _HookedClient:
    """A client that runs ``hook`` once, just before the first list of
    ``kind`` — a scheduler acting while a sweep is between its lists."""

    def __init__(self, client, kind, hook):
        self._client, self._kind, self._hook = client, kind, hook

    def resource(self, plural, ns="default"):
        res = self._client.resource(plural, ns)
        if plural != self._kind or self._hook is None:
            return res
        hook, self._hook = self._hook, None
        outer = res

        class _Res:
            def __getattr__(self, name):
                attr = getattr(outer, name)
                if name not in ("list", "list_rv"):
                    return attr

                def call(*a, **kw):
                    hook()
                    return attr(*a, **kw)
                return call
        return _Res()

    def __getattr__(self, name):
        return getattr(self._client, name)


def _preempt_during_sweep(P, kind, tmp_path):
    """One TPU node held by a bound victim, its preemptor pending. While
    the sweep lists ``kind``, the victim is deleted (the runner's
    ``_evict``: the API delete, then the cache) and the preemptor is
    assumed on the freed node. -> the two sweeps' reported invariants."""
    store = P.store()
    client = P.client(store)
    node = _node(P, cpu="8", tpu="4")
    client.nodes().create(node.to_dict())
    victim = P.w.make_pod("bg-0").req({TPU: "4"}).node("n0").obj()
    client.pods().create(victim.to_dict())
    preemptor = P.w.make_pod("s000-0").req({TPU: "4"}).priority(100).obj()
    client.pods().create(preemptor.to_dict())
    cache = P.cache()
    cache.add_node(node)
    cache.add_pod(victim)

    def evict_then_assume():
        client.pods().delete("bg-0")
        cache.remove_pod(victim.key)
        cache.assume(preemptor, "n0")

    auditor = P.auditor(client=_HookedClient(client, kind,
                                             evict_then_assume),
                        cache=cache, audit_dir=str(tmp_path))
    during = [v.invariant for v in auditor.run_once()]
    after = [v.invariant for v in auditor.run_once()]
    return during, after


@pytest.mark.parametrize("kind", ["pods", "nodes"])
def test_preemption_during_a_sweep_is_no_overcommit(kind, tmp_path):
    """The port reports nothing, wherever in the sweep the eviction and
    the assume fall. The reference reports an overcommit when they fall
    between its pods list and its cache view (here: while it lists the
    nodes), and nothing when they fall before its pods list."""
    out = {}
    for name, P in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        out[name] = _preempt_during_sweep(P, kind, d)
    assert out["port"] == ([], [])
    ref_during = ["node_overcommit"] if kind == "nodes" else []
    assert out["ref"] == (ref_during, [])
