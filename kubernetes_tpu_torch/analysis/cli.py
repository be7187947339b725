"""ktpu-lint CLI — `ktpu lint` and `python -m kubernetes_tpu_torch.analysis`.

Exit codes: 0 = no NEW findings (baseline-covered ones are reported as
context, not failures), 1 = new findings, 2 = usage error. ``--json``
prints a machine-readable summary (the bench.py convention) as the last
line so CI wrappers can parse without scraping human output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

from kubernetes_tpu_torch.analysis import baseline as baseline_mod
from kubernetes_tpu_torch.analysis.engine import run_analysis


def default_package_root() -> str:
    """The kubernetes_tpu_torch package this module is installed in."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="ktpu lint",
        description="Project-native static analyzer: recurring review "
                    "findings (locking, swallows, clock, threads, "
                    "donation, ConfigMap, metrics) as enforced invariants.")
    ap.add_argument("paths", nargs="*",
                    help="directories to scan (default: the installed "
                         "kubernetes_tpu_torch package)")
    ap.add_argument("--baseline", default=None,
                    help="baseline file (default: the committed "
                         "analysis/ktpu_lint_baseline.json)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept current findings as the new baseline")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline: report every finding as new")
    ap.add_argument("--json", action="store_true", dest="json_out",
                    help="print a machine-readable summary line")
    ap.add_argument("--rule", action="append", default=None,
                    help="only run the given rule id(s), e.g. --rule KTL001")
    return ap


def main(argv: Optional[list[str]] = None, out=None) -> int:
    out = out or sys.stdout
    args = build_parser().parse_args(argv)
    roots = args.paths or [default_package_root()]
    for r in roots:
        if not os.path.isdir(r):
            print(f"ktpu-lint: not a directory: {r}", file=out)
            return 2

    want = None
    if args.rule:
        from kubernetes_tpu_torch.analysis.rules import RULE_CLASSES
        want = {r.upper() for r in args.rule}
        known = {cls.id for cls in RULE_CLASSES}
        if not want <= known:
            print(f"ktpu-lint: unknown rule(s): {sorted(want - known)}",
                  file=out)
            return 2
        if args.write_baseline:
            # a rule-filtered run sees a SLICE of the findings; writing it
            # as the baseline would silently drop every other rule's
            # accepted debt and fail the next full gate
            print("ktpu-lint: --write-baseline cannot be combined with "
                  "--rule (the baseline must cover every rule)", file=out)
            return 2

    def rule_set():
        # fresh instances per root: rules carry cross-file state and
        # finalize() per run_analysis call — reuse would re-emit prior
        # roots' deferred findings as duplicates
        if want is None:
            return None
        from kubernetes_tpu_torch.analysis.rules import make_rules
        return [r for r in make_rules() if r.id in want]

    t0 = time.time()
    findings = []
    for root in roots:
        findings.extend(run_analysis(root, rules=rule_set()))
    elapsed = time.time() - t0

    if args.write_baseline:
        path = baseline_mod.write_baseline(findings, args.baseline)
        print(f"ktpu-lint: baseline written: {path} "
              f"({len(findings)} findings)", file=out)
        return 0

    base = (set() if args.no_baseline
            else baseline_mod.load_baseline(args.baseline))
    new, fixed = baseline_mod.diff(findings, base)

    for f in new:
        print(f.render(), file=out)

    by_rule: dict[str, int] = {}
    for f in new:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    summary = {
        "tool": "ktpu-lint",
        "files_scanned": sum(1 for root in roots
                             for _ in _iter_files(root)),
        "findings_total": len(findings),
        "findings_new": len(new),
        "findings_baselined": len(findings) - len(new),
        "baseline_fixed": fixed,
        "new_by_rule": dict(sorted(by_rule.items())),
        "elapsed_s": round(elapsed, 3),
        "ok": not new,
    }
    if args.json_out:
        print("[ktpu-lint] " + json.dumps(summary), file=out)
    else:
        print(f"ktpu-lint: {len(findings)} findings "
              f"({len(new)} new, {len(findings) - len(new)} baselined, "
              f"{fixed} baselined-and-fixed) in {elapsed:.2f}s", file=out)
    return 1 if new else 0


def _iter_files(root: str):
    from kubernetes_tpu_torch.analysis.engine import iter_py_files
    return iter_py_files(root)
