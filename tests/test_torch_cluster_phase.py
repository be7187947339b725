"""``chip_smoke.py``'s ``cluster`` phase (ClusterUp/20Nodes100Pods), its
``domain_counts`` sub-phase (ROADMAP B2) and its counter checks, on the
CPU.

- ``cluster_failures`` passes a clean run and fails on each gate alone: a
  scheduler off the card, a pod not Running, a skew over 1, two pods on
  one IP or one outside its node's podCIDR, a proxy render or table that
  misses a pod, a packet resolved outside the pods, a child that exits
  non-zero or late, count_pn never launched in the child.
- ``cluster_phase`` runs whole on the CPU at a small size (``ktpu-up init
  --nodes 3 --auth --device cpu``, ``join --nodes 1``, 12 replicas): no
  gate fails (the count_pn gate applies to the card only).
- ``domain_counts_phase`` at small N on the CPU (its CUDA timer stubbed):
  the two branches bit-equal; ``graph_counts_hold`` on a drain's counters.
- The port's kubelet hands out pod IPs from its node's podCIDR, where the
  reference's count from a process-global index: two kubelets of two
  processes share addresses on the reference and not on the port (a
  deliberate difference).
"""

from __future__ import annotations

import copy
import itertools
import time

import pytest

import chip_smoke


def _run(n_nodes=4, per_node=3):
    """A clean cluster phase's reads: nodes with podCIDRs, Running pods
    spread evenly, every render holding every pod."""
    nodes = [{"metadata": {"name": f"node-{i}"},
              "spec": {"podCIDR": f"10.244.{i}.0/24"}}
             for i in range(n_nodes)]
    pods = [{"metadata": {"name": f"web-{i}-{j}"},
             "spec": {"nodeName": f"node-{i}"},
             "status": {"phase": "Running", "podIP": f"10.244.{i}.{j + 2}"}}
            for i in range(n_nodes) for j in range(per_node)]
    eps = sorted(f"{p['status']['podIP']}:8080" for p in pods)
    backends = {k: list(eps) for k in ("iptables", "nftables", "ipvs",
                                       "table")}
    backends["resolved"] = eps[:3]
    exits = {"init": (0, 1.2), "join": (0, 0.8)}
    return dict(pods=pods, nodes=nodes, backends=backends,
                want_device="cuda", device_line="cuda:0 NVIDIA H100",
                exits=exits, launches={"count_pn": 7},
                replicas=n_nodes * per_node)


def test_clean_run_passes():
    assert chip_smoke.cluster_failures(**_run()) == []


def _off_card(r):
    r["device_line"] = "cpu"


def _not_running(r):
    r["pods"][0]["status"]["phase"] = "Pending"


def _skewed(r):
    r["pods"][0]["spec"]["nodeName"] = "node-1"
    r["pods"][0]["status"]["podIP"] = "10.244.1.9"


def _shared_ip(r):
    r["pods"][1]["status"]["podIP"] = r["pods"][0]["status"]["podIP"]


def _outside_cidr(r):
    r["pods"][0]["status"]["podIP"] = "10.11.0.2"


def _render_misses(r):
    r["backends"]["nftables"] = r["backends"]["nftables"][1:]


def _table_misses(r):
    r["backends"]["table"] = r["backends"]["table"][1:]


def _resolved_outside(r):
    r["backends"]["resolved"] = ["10.99.0.1:8080"]


def _exit_nonzero(r):
    r["exits"]["init"] = (1, 0.5)


def _exit_late(r):
    r["exits"]["join"] = (0, chip_smoke.CLUSTER_EXIT_S + 1)


def _never_launched(r):
    r["launches"] = {"count_pn": 0}


def _synced(r):
    """The renders and resolutions as a proxy would hold them for ``r``'s
    Running pods."""
    eps = sorted(f"{p['status']['podIP']}:8080" for p in r["pods"]
                 if p["status"]["phase"] == "Running")
    for k in ("iptables", "nftables", "ipvs", "table"):
        r["backends"][k] = list(eps)
    r["backends"]["resolved"] = eps[:3]


@pytest.mark.parametrize("edit,words", [
    (_off_card, "runs on"), (_not_running, "bound and Running"),
    (_skewed, "skew over 1"), (_shared_ip, "pod IPs shared"),
    (_outside_cidr, "outside their node's podCIDR"),
    (_render_misses, "nftables:"), (_table_misses, "table:"),
    (_resolved_outside, "resolved the VIP"),
    (_exit_nonzero, "init exited 1"), (_exit_late, "join exited 0"),
    (_never_launched, "count_pn was never launched")],
    ids=lambda v: v.__name__.strip("_") if callable(v) else None)
def test_each_gate_fails_alone(edit, words):
    r = copy.deepcopy(_run())
    edit(r)
    if edit in (_not_running, _skewed, _shared_ip, _outside_cidr):
        _synced(r)
    failures = chip_smoke.cluster_failures(**r)
    assert len(failures) == 1 and words in failures[0], failures


def test_count_pn_gate_is_the_cards():
    r = _run()
    r.update(want_device="cpu", device_line="cpu",
             launches={"count_pn": 0})
    assert chip_smoke.cluster_failures(**r) == []


def test_manifests_carry_the_hard_spread_and_the_service_port():
    dep, svc = chip_smoke.cluster_manifests(100)
    spec = dep["spec"]["template"]["spec"]
    assert dep["spec"]["replicas"] == 100
    assert spec["topologySpreadConstraints"] == [{
        "maxSkew": 1, "topologyKey": "kubernetes.io/hostname",
        "whenUnsatisfiable": "DoNotSchedule",
        "labelSelector": {"matchLabels": {"app": "web"}}}]
    assert spec["containers"][0]["ports"] == [{"containerPort": 8080}]
    assert spec["containers"][0]["resources"]["requests"] == {
        "cpu": "10m", "memory": "10Mi"}
    assert svc["spec"]["ports"] == [{"port": 80, "targetPort": 8080,
                                     "protocol": "TCP"}]


def test_cluster_phase_runs_on_the_cpu():
    out = chip_smoke.cluster_phase(device="cpu", n_init=3, n_join=1,
                                   replicas=12)
    assert out["failures"] == []
    assert out["device"] == "cpu"
    assert out["nodes"] == 4 and out["pods"] == 12
    assert out["pods_per_node"] == {"min": 3, "max": 3, "nodes": 4}
    assert out["backends"]["iptables"] == 12
    assert {k: v["rc"] for k, v in out["exits"].items()} == {"init": 0,
                                                             "join": 0}
    assert out["launches"] == {"count_pn": 0}


def test_domain_counts_branches_agree_on_the_cpu(monkeypatch):
    def cpu_ms(fn, iters=5, warmup=1):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    monkeypatch.setattr(chip_smoke, "cuda_ms", cpu_ms)
    out = chip_smoke.domain_counts_phase(sizes=(256, 640), card="cpu")
    assert out["256"]["bit_equal"] and out["640"]["bit_equal"]
    assert out["640"]["domains"] > out["256"]["domains"] > 0


def test_domain_counts_branches_differ_is_caught(monkeypatch):
    """A factored branch that drops a count fails the phase."""
    base = chip_smoke._domain_counts_with

    def broken(factored, *args):
        cnt, has, num = base(factored, *args)
        if factored:
            cnt = cnt.clone()
            cnt.view(-1)[0] += 1
        return cnt, has, num

    monkeypatch.setattr(chip_smoke, "_domain_counts_with", broken)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, **kw: 0.0)
    with pytest.raises(chip_smoke.PhaseFailed, match="branches differ"):
        chip_smoke.domain_counts_phase(sizes=(256,), card="cpu")


def test_graph_counts_hold():
    rounds = [3, 4, 1]   # ceil(r / 2): 2 + 2 + 1
    assert chip_smoke.graph_counts_hold(
        {"K": 2, "replays": 5, "host_reads": 5, "captures": 0}, rounds)
    assert not chip_smoke.graph_counts_hold(
        {"K": 2, "replays": 5, "host_reads": 4, "captures": 0}, rounds)
    assert not chip_smoke.graph_counts_hold(
        {"K": 2, "replays": 6, "host_reads": 6, "captures": 0}, rounds)
    assert not chip_smoke.graph_counts_hold(
        {"K": 2, "replays": 5, "host_reads": 5, "captures": 1}, rounds)


@pytest.mark.parametrize("pkg", ["kubernetes_tpu", "kubernetes_tpu_torch"])
def test_kubelets_of_two_processes_and_their_pod_ips(pkg, monkeypatch):
    """Two kubelets with the same process-global node index (as ``ktpu-up
    init`` and ``join`` each start theirs at 1), on nodes whose podCIDRs
    nodeipam set: after a heartbeat the port's hand out addresses of their
    own podCIDR, the reference's the same address."""
    import importlib
    kubelet = importlib.import_module(f"{pkg}.kubelet.kubelet")
    cs = importlib.import_module(f"{pkg}.client.clientset")
    store = importlib.import_module(f"{pkg}.store.store")
    client = cs.DirectClient(store.ObjectStore())
    got = []
    for i in range(2):
        monkeypatch.setattr(kubelet, "_node_ip_counter", itertools.count(1))
        k = kubelet.Kubelet(client, f"n{i}")
        k._register()
        node = client.nodes().get(f"n{i}")
        node["spec"]["podCIDR"] = f"10.244.{i}.0/24"
        client.nodes().update(node)
        k.heartbeat_once()
        got.append(k._next_pod_ip())
    if pkg == "kubernetes_tpu":
        assert got == ["10.11.0.2", "10.11.0.2"]
    else:
        assert got == ["10.244.0.2", "10.244.1.2"]
