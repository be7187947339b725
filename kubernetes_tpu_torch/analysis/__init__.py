"""ktpu-lint — project-native static analysis for kubernetes-tpu.

Go's race detector and ``go vet`` did not survive the paper's Go->Python
translation; this package is their project-native replacement. Entry
points: ``ktpu lint`` (CLI subcommand), ``python -m
kubernetes_tpu_torch.analysis`` (standalone), ``tests/test_torch_lint.py``
(tier-1 fail-on-new gate over this package).

The PyTorch port of ``kubernetes_tpu/analysis``: the same engine, baseline
and rules, their path scopes on this package's trees, without KTL005
(``rules/__init__.py`` says why).
"""

from kubernetes_tpu_torch.analysis.baseline import (
    DEFAULT_BASELINE,
    diff,
    load_baseline,
    write_baseline,
)
from kubernetes_tpu_torch.analysis.engine import Finding, run_analysis
from kubernetes_tpu_torch.analysis.rules import RULE_CLASSES, make_rules

__all__ = ["Finding", "run_analysis", "RULE_CLASSES", "make_rules",
           "DEFAULT_BASELINE", "load_baseline", "write_baseline", "diff"]
