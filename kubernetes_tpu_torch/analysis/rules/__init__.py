"""ktpu-lint rule registry — each rule is a shipped-and-fixed bug class.

Adding a rule: drop a module here with a Rule subclass, give it the next
KTL id, register it in ``make_rules``, add fixture tests (one proving it
fires, one proving ``# ktpu-lint: disable=KTL00N -- reason`` works), and
regenerate the baseline if it surfaces pre-existing findings.

The PyTorch port of ``kubernetes_tpu_torch/analysis/rules``. KTL005 (JAX
donation without pinned output shardings, and ``jax.device_get`` outside
the resolver and the sentinel) has no rule here: the port donates nothing,
and its host reads (``.item()``, ``.cpu()``, ``.tolist()``) are calls an
AST cannot tell from numpy's. Its runtime guards take the rule's place:
a captured round refuses a host read (``models/graphs.GraphError``) and
``models/graphs.HOST_READS`` counts the drain's reads. A suppression
naming KTL005 covers nothing here.
"""

from __future__ import annotations

from kubernetes_tpu_torch.analysis.rules.base import Rule
from kubernetes_tpu_torch.analysis.rules.ktl001_guarded_by import GuardedByRule
from kubernetes_tpu_torch.analysis.rules.ktl002_silent_swallow import SilentSwallowRule
from kubernetes_tpu_torch.analysis.rules.ktl003_clock import ClockDisciplineRule
from kubernetes_tpu_torch.analysis.rules.ktl004_threads import ThreadHygieneRule
from kubernetes_tpu_torch.analysis.rules.ktl006_configmap import ConfigMapWriteRule
from kubernetes_tpu_torch.analysis.rules.ktl007_metrics import MetricsRegistryRule
from kubernetes_tpu_torch.analysis.rules.ktl008_atomicio import AtomicCommitRule

RULE_CLASSES: tuple[type[Rule], ...] = (
    GuardedByRule,
    SilentSwallowRule,
    ClockDisciplineRule,
    ThreadHygieneRule,
    ConfigMapWriteRule,
    MetricsRegistryRule,
    AtomicCommitRule,
)


def make_rules() -> list[Rule]:
    """Fresh rule instances (rules carry cross-file state; one set per
    run)."""
    return [cls() for cls in RULE_CLASSES]


__all__ = ["Rule", "RULE_CLASSES", "make_rules"]
