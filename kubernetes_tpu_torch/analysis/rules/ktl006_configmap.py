"""KTL006 — ConfigMap writes go through utils/configmap.upsert_configmap.

Before the shared upsert, four components each grew their own
get/update-else-create ConfigMap publish with subtly different 409/404
handling — and two of them silently dropped on-change publishes when they
lost the create race. ``upsert_configmap`` is the one shared, counted,
race-retrying implementation; a raw ``resource("configmaps").create/
update`` anywhere else is the same bug waiting to be re-fixed.

Reads (``.get``) are fine; the rule targets the write verbs only.
"""

from __future__ import annotations

import ast

from kubernetes_tpu_torch.analysis.engine import FileContext
from kubernetes_tpu_torch.analysis.rules.base import Rule, enclosing_function

WHITELIST = ("kubernetes_tpu_torch/analysis/",
             "kubernetes_tpu_torch/utils/configmap.py")

_WRITE_VERBS = {"create", "update", "patch", "replace"}


def _is_cm_resource_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "resource"
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and node.args[0].value == "configmaps")


class ConfigMapWriteRule(Rule):
    id = "KTL006"
    title = "raw ConfigMap write outside upsert_configmap"

    def _cm_vars(self, scope: ast.AST) -> set[str]:
        """Names bound to a configmaps resource handle in ``scope``."""
        out = set()
        for node in ast.walk(scope):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and _is_cm_resource_call(node.value)):
                out.add(node.targets[0].id)
        return out

    def visit(self, ctx: FileContext) -> list[tuple[int, str]]:
        if ctx.relpath.startswith(WHITELIST[0]) or ctx.relpath in WHITELIST:
            return []
        out: list[tuple[int, str]] = []
        scope_vars: dict[ast.AST, set[str]] = {}
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _WRITE_VERBS):
                continue
            base = node.func.value
            hit = _is_cm_resource_call(base)
            if not hit and isinstance(base, ast.Name):
                scope = enclosing_function(ctx, node) or ctx.tree
                if scope not in scope_vars:
                    scope_vars[scope] = self._cm_vars(scope)
                hit = base.id in scope_vars[scope]
            if hit:
                out.append((node.lineno,
                            f"ConfigMap .{node.func.attr}() outside "
                            "utils/configmap.upsert_configmap (the shared "
                            "upsert owns the create/update race + counted "
                            "failure handling)"))
        return out
