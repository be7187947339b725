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
