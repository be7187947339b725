"""Baseline — pre-existing findings the gate tolerates, nothing else.

The analyzer's enforcement is ZERO-NEW: findings whose fingerprints are in
the committed baseline pass; anything else fails. Fingerprints hash rule +
path + normalized line content (not line numbers), so edits elsewhere in a
file neither hide a baselined finding nor resurrect it as new.

Workflow:
- ``python -m kubernetes_tpu_torch.analysis --write-baseline`` regenerates the
  file after deliberately accepting current findings (e.g. a new rule
  surfacing historical debt).
- Fixing a baselined finding needs no baseline edit — a fingerprint that
  stops appearing is simply unused (``diff`` reports it as fixed).
"""

from __future__ import annotations

import json
import os
from typing import Optional

from kubernetes_tpu_torch.analysis.engine import Finding

DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__),
                                "ktpu_lint_baseline.json")


def load_baseline(path: Optional[str] = None) -> set[str]:
    """Fingerprint set from a baseline file ({} when absent: every finding
    is new — the state a fresh checkout of a new rule starts from)."""
    path = path or DEFAULT_BASELINE
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError):
        return set()
    return {e["fingerprint"] for e in data.get("findings", [])}


def write_baseline(findings: list[Finding], path: Optional[str] = None
                   ) -> str:
    """Persist today's findings as the accepted baseline (sorted, stable
    diffs)."""
    path = path or DEFAULT_BASELINE
    payload = {
        "comment": ("ktpu-lint accepted findings. Regenerate with "
                    "`python -m kubernetes_tpu_torch.analysis "
                    "--write-baseline`; entries that stop appearing are "
                    "fixed and need no manual removal."),
        "findings": [f.to_dict() for f in findings],
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")
    return path


def diff(findings: list[Finding], baseline: set[str]
         ) -> tuple[list[Finding], int]:
    """-> (new findings not covered by the baseline, count of baseline
    entries no longer observed i.e. fixed)."""
    observed = {f.fingerprint for f in findings}
    new = [f for f in findings if f.fingerprint not in baseline]
    fixed = len(baseline - observed)
    return new, fixed
