"""Tier-1 static-analysis gate over the port: the port's analyzer over
``kubernetes_tpu_torch/``, the counterpart of ``tests/test_lint.py``.

Zero-NEW enforcement against the port's committed baseline
(``kubernetes_tpu_torch/analysis/ktpu_lint_baseline.json``), whose debt is
only in KTL003 and KTL004. The analyzer runs once for the module.

Budget: the run is held to the CPU seconds of this process, not to wall
seconds, so a loaded run (``-n 6`` beside other files) cannot trip it:
``CPU_BUDGET_S`` is 20 s, about three times the ~7 CPU seconds one run
over the port takes on an idle 8-CPU box.
"""

from __future__ import annotations

import io
import json
import os
import time

import pytest

from kubernetes_tpu_torch.analysis import (
    DEFAULT_BASELINE,
    diff,
    load_baseline,
    run_analysis,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE_ROOT = os.path.join(REPO, "kubernetes_tpu_torch")
CPU_BUDGET_S = 20.0


@pytest.fixture(scope="module")
def lint_run():
    t0 = time.process_time()
    findings = run_analysis(PACKAGE_ROOT)
    return findings, time.process_time() - t0


def test_baseline_is_committed():
    assert os.path.isfile(DEFAULT_BASELINE), (
        "analysis/ktpu_lint_baseline.json must be committed — regenerate "
        "with `python -m kubernetes_tpu_torch.analysis --write-baseline`")
    assert DEFAULT_BASELINE.startswith(PACKAGE_ROOT + os.sep)
    assert load_baseline(), "committed baseline is empty/unreadable"


def test_no_new_findings_and_under_cpu_budget(lint_run):
    findings, cpu_s = lint_run
    new, _fixed = diff(findings, load_baseline())
    assert not new, (
        "ktpu-lint found NEW violations in the port (fix them, add a "
        "reasoned '# ktpu-lint: disable=KTL00N -- why', or deliberately "
        "accept via --write-baseline):\n"
        + "\n".join(f.render() for f in new))
    assert cpu_s < CPU_BUDGET_S, (
        f"ktpu-lint took {cpu_s:.1f} CPU s over the port "
        f"(budget {CPU_BUDGET_S} s)")


def test_burned_down_rules_stay_at_zero(lint_run):
    """Only KTL003/KTL004 carry accepted debt; KTL001 and KTL008 read 0 on
    the port, baselined or not (its module counters move under locks and
    the kernel library is published through utils/atomicio)."""
    findings, _ = lint_run
    base = load_baseline()
    debt = {f.rule for f in findings if f.fingerprint in base}
    assert debt <= {"KTL003", "KTL004"}, sorted(debt)
    with open(DEFAULT_BASELINE, encoding="utf-8") as f:
        assert {e["rule"] for e in json.load(f)["findings"]} <= {
            "KTL003", "KTL004"}
    assert [f.render() for f in findings
            if f.rule in ("KTL001", "KTL008")] == []
    assert all(f.path.startswith("kubernetes_tpu_torch/") for f in findings)


def test_guarded_by_annotations_are_live():
    """The KTL001 annotations on the port's hot shared state: losing one
    silently disables the rule there."""
    for rel in ("sched/cache.py", "sched/staging.py", "kubelet/kubemark.py",
                "audit/auditor.py", "sched/queue.py"):
        with open(os.path.join(PACKAGE_ROOT, rel), encoding="utf-8") as f:
            assert "# guarded by: self._" in f.read(), (
                f"kubernetes_tpu_torch/{rel} lost its 'guarded by:' "
                "annotations")


@pytest.mark.parametrize("entry", ["ktpu", "analysis"])
def test_entry_points_gate_a_subtree(entry):
    """``ktpu lint`` and ``python -m kubernetes_tpu_torch.analysis`` over
    one subtree of the port: exit 0, nothing new, the subtree's files."""
    if entry == "ktpu":
        from kubernetes_tpu_torch.cli.ktpu import main
        argv = ["lint", "--json"]
    else:
        from kubernetes_tpu_torch.analysis.cli import main
        argv = ["--json"]
    out = io.StringIO()
    rc = main(argv + [os.path.join(PACKAGE_ROOT, "proxy")], out=out)
    summary = json.loads(out.getvalue().splitlines()[-1].split(" ", 1)[1])
    assert rc == 0, out.getvalue()
    assert summary["findings_new"] == 0 and summary["ok"]
    assert summary["files_scanned"] == 4


def test_planted_violation_fails_then_reasoned_disable_passes(tmp_path):
    """The user flow: a NEW unlocked access to annotated state in a port
    tree exits 1 naming the rule and line; a reasoned disable exits 0; a
    reasonless one exits 1 with KTL000 and the rule."""
    from kubernetes_tpu_torch.analysis.cli import main
    root = tmp_path / "kubernetes_tpu_torch" / "sched"
    root.mkdir(parents=True)
    (root.parent / "__init__.py").write_text("")
    (root / "__init__.py").write_text("")
    src = ("import threading\n\n\nclass Q:\n    def __init__(self):\n"
           "        self._lock = threading.Lock()\n"
           "        self.n = 0  # guarded by: self._lock\n\n"
           "    def bump(self):\n        self.n += 1{}\n")
    mod = root / "q.py"
    bl = str(tmp_path / "bl.json")
    for suffix, rc, rules in (
            ("", 1, ["KTL001"]),
            ("  # ktpu-lint: disable=KTL001 -- caller holds the lock", 0, []),
            ("  # ktpu-lint: disable=KTL001", 1, ["KTL000", "KTL001"])):
        mod.write_text(src.format(suffix))
        out = io.StringIO()
        assert main([str(root), "--baseline", bl, "--json"], out=out) == rc
        lines = out.getvalue().splitlines()
        assert sorted(ln.split(" ")[1] for ln in lines[:-1]) == rules
        assert all(ln.startswith("kubernetes_tpu_torch/sched/q.py:10:")
                   for ln in lines[:-1])
        assert json.loads(lines[-1].split(" ", 1)[1])["findings_new"] \
            == len(rules)
