"""The port stands alone: ``kubernetes_tpu_torch`` and ``chip_smoke.py``
import with JAX and flax blocked, and nothing in them imports the JAX
package (``kubernetes_tpu``), not even its JAX-free modules."""

from __future__ import annotations

import ast
import os
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
    # DRA device claims and the ResourceClaim controller
    "sched.dra", "client.workqueue", "controllers.base",
    "controllers.resourceclaim",
    # tensor plugins and the entry points: ktpu and the sidecar client
    "testing.plugins", "cli.ktpu", "sidecar.proto", "sidecar.client",
    "sidecar.server")

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
    planners' and the entry points' modules import with JAX, flax, PyYAML,
    msgpack and grpc blocked (the card's machine lists none of the last
    three: config/types.py and descheduler/descheduler.py import PyYAML in
    ``from_yaml`` only, ktpu when it reads YAML, the store and the clients
    speak JSON without msgpack, and the sidecar imports grpc and msgpack
    where it serves, dials or packs a frame), and pull in nothing of the
    JAX package."""
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
