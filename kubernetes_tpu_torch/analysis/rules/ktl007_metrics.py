"""KTL007 — metrics registry discipline: one registry, consistent labels.

Two drifts this rule pins (both bitten in bench-JSON archaeology):

- A metric constructed via ``REGISTRY.counter(...)`` outside
  ``metrics/registry.py`` silently forks the catalog: the registry dedups
  by name, so a second construction with a different help string or
  bucket set is ignored — whichever import ran first wins, and dashboards
  document the loser.

- A labeled write whose key set differs from the metric's other call
  sites creates a parallel series the dashboards never join: a
  ``LOOP_ERRORS.inc()`` (no ``site``) next to fifty
  ``LOOP_ERRORS.inc({"site": ...})`` calls is a count that vanishes from
  every by-site breakdown. Canonical key set = the majority across write
  sites (ties break to the earliest site); minority sites flag.

Cross-file by nature: evidence accumulates per file, verdicts land in
``finalize()``.
"""

from __future__ import annotations

import ast
from typing import Optional

from kubernetes_tpu_torch.analysis.engine import FileContext, Finding
from kubernetes_tpu_torch.analysis.rules.base import Rule, dotted_name

REGISTRY_PATH = "kubernetes_tpu_torch/metrics/registry.py"

# write verb -> positional index of the labels argument
_LABEL_ARG = {"inc": 0, "set": 1, "observe": 1}

_CTOR_VERBS = {"counter", "gauge", "histogram"}


def _label_keys(call: ast.Call, verb: str) -> Optional[frozenset]:
    """Key set of the labels argument, frozenset() when absent/None, None
    (= unknowable, skip) when the labels are a non-literal expression."""
    node = None
    idx = _LABEL_ARG[verb]
    if len(call.args) > idx:
        node = call.args[idx]
    for kw in call.keywords:
        if kw.arg == "labels":
            node = kw.value
    if node is None or (isinstance(node, ast.Constant)
                        and node.value is None):
        return frozenset()
    if isinstance(node, ast.Dict) and all(
            isinstance(k, ast.Constant) for k in node.keys):
        return frozenset(k.value for k in node.keys)
    return None


class MetricsRegistryRule(Rule):
    id = "KTL007"
    title = "metric outside the registry / inconsistent label set"

    def __init__(self) -> None:
        super().__init__()
        # metric variable name -> metric string name (from registry.py)
        self.defs: dict[str, str] = {}
        # metric var -> [(keyset, ctx, lineno)]
        self.uses: dict[str, list] = {}

    def visit(self, ctx: FileContext) -> list[tuple[int, str]]:
        out: list[tuple[int, str]] = []
        in_registry = ctx.relpath == REGISTRY_PATH
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func) or ""
            parts = name.split(".")
            # constructions: REGISTRY.counter/gauge/histogram(...)
            if (len(parts) == 2 and parts[0] == "REGISTRY"
                    and parts[1] in _CTOR_VERBS):
                if in_registry:
                    parent = ctx.parents.get(node)
                    if (isinstance(parent, ast.Assign)
                            and len(parent.targets) == 1
                            and isinstance(parent.targets[0], ast.Name)
                            and node.args
                            and isinstance(node.args[0], ast.Constant)):
                        self.defs[parent.targets[0].id] = node.args[0].value
                else:
                    out.append((node.lineno,
                                "metric constructed outside metrics/"
                                "registry.py (the registry dedups by name "
                                "— a second construction's help/buckets "
                                "are silently ignored)"))
                continue
            # writes: METRIC_CONST.inc/set/observe(...)
            if (len(parts) == 2 and parts[1] in _LABEL_ARG
                    and parts[0].isupper() and not in_registry):
                keys = _label_keys(node, parts[1])
                if keys is not None:
                    self.uses.setdefault(parts[0], []).append(
                        (keys, ctx, node.lineno))
        return out

    def finalize(self) -> list[Finding]:
        for var, sites in sorted(self.uses.items()):
            if var not in self.defs or len(sites) < 2:
                continue
            counts: dict[frozenset, int] = {}
            for keys, _ctx, _line in sites:
                counts[keys] = counts.get(keys, 0) + 1
            ordered = sorted(sites, key=lambda s: (s[1].relpath, s[2]))
            canonical = max(
                counts,
                key=lambda k: (counts[k],
                               -next(i for i, s in enumerate(ordered)
                                     if s[0] == k)))
            for keys, ctx, lineno in sites:
                if keys != canonical:
                    self.defer(ctx, lineno,
                               f"metric '{self.defs[var]}' written with "
                               f"label keys {sorted(keys) or '{}'} but its "
                               f"other call sites use "
                               f"{sorted(canonical) or '{}'} — a minority "
                               "label set is a series dashboards never "
                               "join")
        return self.deferred_findings()
