"""The port's static analyzer against the JAX package's, on the CPU.

Every case of ``tests/test_analysis.py`` runs on both packages: the file is
compiled once for each, with every ``kubernetes_tpu`` word pointed at the
package under test, so its fixtures are written under a directory named
after that package and the path-scoped rules (KTL003's disciplined trees,
KTL006's and KTL008's whitelists, KTL007's registry path) see their own
trees. Both legs pass, and the findings each analyzer returned, the
package's name masked in their paths, are equal.

Left out by name: the six ``test_ktl005_*`` cases. The port has no KTL005
(``kubernetes_tpu_torch/analysis/rules/__init__.py`` says why).
``test_own_line_suppression_covers_next_line`` uses KTL005 only as the
text of its suppression; it runs on both packages with that text and its
fixture held by KTL003 (a wall-clock read in ``controllers/``), a rule
both packages have.
"""

from __future__ import annotations

import inspect
import re
import sys
import types
from pathlib import Path

import pytest

import torch_store_parity as parity

TESTS = Path(__file__).resolve().parent
NAME = "test_analysis"
LEFT_OUT = ("test_ktl005_donate_without_pin_fires",
            "test_ktl005_out_shardings_pins",
            "test_ktl005_constrain_cluster_pins",
            "test_ktl005_device_get_outside_whitelist",
            "test_ktl005_device_get_whitelisted_resolver",
            "test_ktl005_suppression_with_reason")
# the own-line suppression case, held by a rule both packages have
_KTL005_TEXT = '''    import jax

    def peek(x):
        # ktpu-lint: disable=KTL005 -- debug readback, never on the cycle
        return jax.device_get(x)
    """
    assert lint(tmp_path, {"ops/p.py": src}) == []'''
_KTL003_TEXT = '''    import time

    def peek(x):
        # ktpu-lint: disable=KTL003 -- debug readback, never on the cycle
        return time.time()
    """
    assert lint(tmp_path, {"controllers/p.py": src}) == []'''
CASES = [c for c in parity.cases(NAME) if c[1] not in LEFT_OUT]
_MODULES: dict = {}


def _load(pkg: str) -> types.ModuleType:
    """``tests/test_analysis.py`` with every ``kubernetes_tpu`` word
    pointed at ``pkg`` (cached)."""
    if pkg not in _MODULES:
        src = (TESTS / f"{NAME}.py").read_text()
        assert _KTL005_TEXT in src
        src = re.sub(r"\bkubernetes_tpu\b", pkg,
                     src.replace(_KTL005_TEXT, _KTL003_TEXT))
        mod = types.ModuleType(f"_analysis_{pkg}")
        mod.__file__ = str(TESTS / f"{NAME}.py")
        sys.modules[mod.__name__] = mod
        exec(compile(src, mod.__file__, "exec"), mod.__dict__)
        _MODULES[pkg] = mod
    return _MODULES[pkg]


def _run(pkg: str, fname: str, params: dict, tmp_path, capsys,
         monkeypatch) -> list:
    """Run one case on ``pkg`` -> what each analysis run returned."""
    import importlib
    mod = _load(pkg)
    cli = importlib.import_module(f"{pkg}.analysis.cli")
    seen = []

    def recorded(fn):
        def run_analysis(root, rules=None):
            found = fn(root, rules=rules)
            seen.append([(f.rule, f.path.replace(pkg + "/", "<pkg>/"),
                          f.line, f.message) for f in found])
            return found
        return run_analysis

    with monkeypatch.context() as mp:
        mp.setattr(mod, "run_analysis", recorded(mod.run_analysis))
        mp.setattr(cli, "run_analysis", recorded(cli.run_analysis))
        fn = mod.__dict__[fname]
        fixtures = {"tmp_path": tmp_path, "capsys": capsys}
        fn(**{a: params[a] if a in params else fixtures[a]
              for a in inspect.signature(fn).parameters})
    capsys.readouterr()
    return seen


@pytest.mark.parametrize("fname,params", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_reference_case_on_both_packages(fname, params, tmp_path, capsys,
                                         monkeypatch):
    got = []
    for pkg in parity.PACKAGES:
        d = tmp_path / pkg
        d.mkdir()
        got.append(_run(pkg, fname, params, d, capsys, monkeypatch))
    assert got[1] == got[0]


def test_analysis_cases_are_selected():
    """All of the reference's cases but the six KTL005 ones."""
    names = {c[1] for c in parity.cases(NAME)}
    assert set(LEFT_OUT) <= names
    assert len(CASES) == len(parity.cases(NAME)) - len(LEFT_OUT) == 49


def test_port_has_no_ktl005_and_its_suppression_covers_nothing(tmp_path):
    """The port's registry holds every reference rule but KTL005, and a
    reasoned suppression naming KTL005 covers no other rule's finding."""
    from kubernetes_tpu.analysis.rules import RULE_CLASSES as REF
    from kubernetes_tpu_torch.analysis.engine import run_analysis
    from kubernetes_tpu_torch.analysis.rules import RULE_CLASSES
    assert ({c.id for c in REF} - {c.id for c in RULE_CLASSES}
            == {"KTL005"})
    assert ([c.__name__ for c in RULE_CLASSES]
            == [c.__name__ for c in REF if c.id != "KTL005"])
    root = tmp_path / "kubernetes_tpu_torch" / "controllers"
    root.mkdir(parents=True)
    (root / "p.py").write_text(
        "import time\n\n\ndef peek(x):\n"
        "    # ktpu-lint: disable=KTL005 -- not a port rule\n"
        "    return time.time()\n")
    assert [f.rule for f in run_analysis(str(root.parent))] == ["KTL003"]
