"""The port stands alone: ``kubernetes_tpu_torch`` and ``chip_smoke.py``
import with JAX and flax blocked, and nothing in them imports the JAX
package (``kubernetes_tpu``), not even its JAX-free modules."""

from __future__ import annotations

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "kubernetes_tpu_torch"
SMOKE = ROOT / "chip_smoke.py"
FORBIDDEN = ("kubernetes_tpu", "benchmarks", "jax", "flax")

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import kubernetes_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    kubernetes_tpu_torch.__path__, "kubernetes_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("kubernetes_tpu", "benchmarks"))
print(len(names), leaked)
"""


def _top_level_imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_port_imports_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    count, leaked = res.stdout.strip().split(" ", 1)
    assert int(count) >= 20
    assert leaked == "[]"


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [SMOKE],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_imports(path):
    # top-level names only: "kubernetes_tpu_torch" is not "kubernetes_tpu"
    assert not _top_level_imports(path) & set(FORBIDDEN)


_SCHED_MODULES = (
    "config.features", "config.types", "metrics.registry", "utils.clock",
    "utils.events", "utils.sanity", "utils.tracing", "topology.slicing",
    "sched.queue", "sched.framework", "sched.resilience", "sched.oracle",
    "sched.staging", "sched.cache", "sched.scheduler",
    # the connected scheduler
    "utils.atomicio", "utils.retry", "utils.configmap", "api.scheme",
    "api.policy", "store.store", "store.apiserver", "client.clientset",
    "client.informer", "client.leaderelection", "audit.invariants",
    "audit.auditor", "audit.sentinel", "sched.runner",
    # default preemption
    "ops.preemption", "sched.preemption",
    # slice carving
    "topology.carve",
    # the resident planners
    "encode.overlay", "autoscaler.nodegroup", "autoscaler.expander",
    "autoscaler.simulator", "autoscaler.autoscaler", "descheduler.planner",
    "descheduler.strategies", "descheduler.descheduler", "sched.bgplanner",
    # the shared fatal-failure predicate and fleet mode
    "sched.faults", "sched.fleet",
    # warm start and the round loop as one captured device program
    "models.graphs", "parallel.aot", "sched.aotcache",
    # the device mesh
    "parallel.mesh",
    # DRA device claims and the ResourceClaim controller
    "sched.dra", "client.workqueue", "controllers.base",
    "controllers.resourceclaim",
    # tensor plugins and the entry points: ktpu and the sidecar client
    "testing.plugins", "cli.ktpu", "sidecar.proto", "sidecar.client",
    "sidecar.server",
    # the rest of store/: the apiserver's planes, replication, front door
    "store.flowcontrol", "store.auth", "store.apply", "store.podsecurity",
    "store.webhooks", "store.admission", "store.aggregator",
    "store.replication", "store.frontdoor",
    # the controller manager and the controllers it starts
    "controllers.attachdetach", "controllers.certificates",
    "controllers.clusterroleaggregation", "controllers.cronjob",
    "controllers.csrlifecycle", "controllers.daemonset",
    "controllers.deployment", "controllers.disruption",
    "controllers.endpoints", "controllers.endpointslice",
    "controllers.endpointslicemirroring", "controllers.ephemeral",
    "controllers.garbagecollector", "controllers.hpa", "controllers.job",
    "controllers.manager", "controllers.namespace", "controllers.nodeipam",
    "controllers.nodelifecycle", "controllers.podgc", "controllers.pvbinder",
    "controllers.replicaset", "controllers.resourcequota",
    "controllers.rootca", "controllers.route", "controllers.serviceaccount",
    "controllers.servicelb", "controllers.statefulset", "controllers.ttl",
    "controllers.ttlafterfinished", "controllers.volumeprotection",
    # the kubelet, kubemark and the runtime, CNI and CSI seams
    "kubelet.runtime", "kubelet.pleg", "kubelet.pod_workers",
    "kubelet.resources", "kubelet.managers", "kubelet.prober",
    "kubelet.volumemanager", "kubelet.server", "kubelet.kubelet",
    "kubelet.kubemark", "kubelet.cri", "kubelet.csi", "kubelet.cni",
    # the chaos harness and the scenario time machine
    "chaos.schedule", "chaos.hooks", "chaos.api", "chaos.device",
    "chaos.apiserver", "chaos.scheduler", "chaos.replica",
    "scenario.trace", "scenario.generate", "scenario.record",
    "scenario.driver",
    # the static analyzer, kube-proxy and cluster bootstrap
    "analysis.engine", "analysis.baseline", "analysis.cli",
    "analysis.rules.base", "analysis.rules.ktl001_guarded_by",
    "analysis.rules.ktl002_silent_swallow", "analysis.rules.ktl003_clock",
    "analysis.rules.ktl004_threads", "analysis.rules.ktl006_configmap",
    "analysis.rules.ktl007_metrics", "analysis.rules.ktl008_atomicio",
    "proxy.proxier", "proxy.nftables", "proxy.ipvs", "cli.cluster")

_NO_YAML = r"""
import importlib, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["yaml"] = None
sys.modules["msgpack"] = None
sys.modules["grpc"] = None
for name in sys.argv[1:]:
    importlib.import_module("kubernetes_tpu_torch." + name)
from kubernetes_tpu_torch.config.types import SchedulerConfiguration, validate
cfg = SchedulerConfiguration.from_dict({"batchSize": 8, "pipelineDepth": 3})
validate(cfg)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("kubernetes_tpu", "benchmarks"))
print(cfg.batch_size, cfg.pipeline_depth, leaked)
"""


def test_scheduler_modules_import_without_yaml():
    """The scheduling loop's, the connected scheduler's, the resident
    planners', the entry points', the controllers', the kubelet's, the
    chaos harness's, the scenario driver's, the analyzer's, kube-proxy's
    and ``ktpu-up``'s modules import with JAX, flax, PyYAML,
    msgpack and grpc blocked (the card's machine lists none of the last
    three: config/types.py and descheduler/descheduler.py import PyYAML in
    ``from_yaml`` only, ktpu when it reads YAML, the kubelet when it reads
    a YAML static-pod manifest, the store and the clients speak JSON
    without msgpack, and the sidecar and the kubelet's CRI and CSI seams
    import grpc and msgpack where they serve, dial or pack a message),
    and pull in nothing of the JAX package."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _NO_YAML, *_SCHED_MODULES],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["8", "3", "[]"]


@pytest.mark.parametrize("name", _SCHED_MODULES)
def test_scheduler_module_is_walked(name):
    # the blocked-import walk above reaches every module of the slice
    assert (PORT / (name.replace(".", "/") + ".py")).is_file()
    assert (PORT / name.split(".")[0] / "__init__.py").is_file()


_MESH_BLOCKED = r"""
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import torch
from kubernetes_tpu_torch.parallel import mesh
m = mesh.make_mesh(["cpu"] * 4, pods_axis=2)
out = mesh.run(mesh.Layout(m, 8, 4), lambda: int(mesh.reduce_nodes(
    torch.ones((), dtype=torch.int64), "sum")), [()] * m.size)
leaked = sorted(k for k in sys.modules
                if k.split(".")[0] in ("kubernetes_tpu", "benchmarks"))
print(m.shape["pods"], m.shape["nodes"], out, leaked)
"""


def test_mesh_module_imports_and_runs_with_jax_blocked():
    """``parallel/mesh.py`` imports and runs its shards with JAX blocked
    (its counterpart in the JAX package is built on ``jax.sharding``)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _MESH_BLOCKED], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "2 2 [2, 2, 2, 2] []"


def test_no_item_14_refusal_left():
    """``controllers/`` is whole: nothing in the port refuses a controller
    or a command as waiting for ROADMAP Queue A item 14, and the port holds
    every module of the reference's ``controllers/``."""
    hits = [f"{p.relative_to(ROOT)}:{i}"
            for p in sorted(PORT.rglob("*.py"))
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if '"14")' in line or "item 14" in line]
    assert hits == []
    ref = ROOT / "kubernetes_tpu" / "controllers"
    assert ({p.name for p in (PORT / "controllers").glob("*.py")}
            == {p.name for p in ref.glob("*.py")})


def test_no_item_15_refusal_left():
    """``kubelet/`` is whole: nothing in the port refuses a command, a
    subresource or a provider as waiting for ROADMAP Queue A item 15, and
    the port holds every module of the reference's ``kubelet/``."""
    hits = [f"{p.relative_to(ROOT)}:{i}"
            for p in sorted(PORT.rglob("*.py"))
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if '"15")' in line or "item 15" in line]
    assert hits == []
    ref = ROOT / "kubernetes_tpu" / "kubelet"
    assert ({p.name for p in (PORT / "kubelet").glob("*.py")}
            == {p.name for p in ref.glob("*.py")})


def test_no_item_13_refusal_left():
    """``store/`` is whole: nothing in the port refuses a plane as waiting
    for ROADMAP Queue A item 13."""
    hits = [f"{p.relative_to(ROOT)}:{i}"
            for p in sorted(PORT.rglob("*.py"))
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if '"13")' in line or "item 13" in line]
    assert hits == []


def test_no_item_16_refusal_left():
    """``chaos/`` and ``scenario/`` are whole: the port holds every module
    of the reference's two packages, nothing refuses as waiting for ROADMAP
    Queue A item 16, and ``ktpu scenario`` runs (``describe`` is a file
    operation: the address below listens to nothing), as ``ktpu lint``
    does since item 17 (over one subtree of the port, against its
    baseline)."""
    import io

    from kubernetes_tpu_torch.cli import ktpu
    hits = [f"{p.relative_to(ROOT)}:{i}"
            for p in sorted(PORT.rglob("*.py"))
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if re.search(r'\(\s*"[^"]*",\s*"16"\)', line)
            or "item 16" in line]
    assert hits == []
    for pkg in ("chaos", "scenario"):
        ref = ROOT / "kubernetes_tpu" / pkg
        assert ({p.name for p in (PORT / pkg).glob("*.py")}
                == {p.name for p in ref.glob("*.py")})
    out = io.StringIO()
    assert ktpu.main(["--server", "http://127.0.0.1:9", "scenario",
                      "describe", "builtin:smoke"], out=out) == 0
    assert '"resident_pods": 32' in out.getvalue()
    out = io.StringIO()
    assert ktpu.main(["--server", "http://127.0.0.1:9", "lint", "--json",
                      str(PORT / "proxy")], out=out) == 0
    assert '"findings_new": 0' in out.getvalue()


def test_no_item_17_18_19_refusal_left():
    """The port is whole but the multi-device mesh: nothing refuses a
    feature as waiting for ROADMAP Queue A items 17-19, ``not_ported`` is
    raised nowhere, and the port holds every module of the reference's
    ``analysis/`` (but KTL005's rule), ``proxy/`` and ``cli/``, and the
    analyzer's baseline."""
    hits = [f"{p.relative_to(ROOT)}:{i}"
            for p in sorted(PORT.rglob("*.py"))
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if re.search(r'\(\s*"[^"]*",\s*"1[789]"\)', line)
            or re.search(r"item 1[789]\b", line) or "not_ported(" in line
            and not line.startswith("def not_ported(")]
    assert hits == []
    for pkg, left_out in (("analysis", {"ktl005_donation.py"}),
                          ("proxy", set()), ("cli", set())):
        ref = ROOT / "kubernetes_tpu" / pkg
        assert ({str(p.relative_to(PORT / pkg))
                 for p in (PORT / pkg).rglob("*.py")}
                == {str(p.relative_to(ref)) for p in ref.rglob("*.py")
                    if p.name not in left_out})
    assert (PORT / "analysis" / "ktpu_lint_baseline.json").is_file()
