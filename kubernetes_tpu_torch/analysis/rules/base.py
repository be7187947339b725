"""Rule base class + the small AST toolbox the rules share."""

from __future__ import annotations

import ast
from typing import Optional

from kubernetes_tpu_torch.analysis.engine import FileContext, Finding, make_findings


class Rule:
    """One rule = one shipped-and-fixed bug class.

    ``visit(ctx)`` -> [(lineno, message)] for per-file findings (the engine
    fingerprints and applies suppressions). Cross-file rules stash
    evidence during visit and report via ``finalize()`` — ``defer`` +
    ``deferred_findings`` handle the fingerprint/suppression plumbing for
    them."""

    id = "KTL???"
    title = ""

    def __init__(self) -> None:
        self._deferred: list[tuple[FileContext, int, str]] = []

    def visit(self, ctx: FileContext) -> list[tuple[int, str]]:
        return []

    def finalize(self) -> list[Finding]:
        return []

    # ---- cross-file plumbing ---------------------------------------------

    def defer(self, ctx: FileContext, lineno: int, message: str) -> None:
        self._deferred.append((ctx, lineno, message))

    def deferred_findings(self) -> list[Finding]:
        by_ctx: dict[str, tuple[FileContext, list]] = {}
        for ctx, lineno, message in self._deferred:
            by_ctx.setdefault(ctx.relpath, (ctx, []))[1].append(
                (lineno, message))
        out: list[Finding] = []
        for ctx, raw in by_ctx.values():
            out.extend(make_findings(ctx, self.id, raw))
        return out


# ---- shared AST helpers ----------------------------------------------------

def dotted_name(node: ast.AST) -> Optional[str]:
    """'a.b.c' for Name/Attribute chains, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> Optional[str]:
    return dotted_name(call.func)


def keyword_names(call: ast.Call) -> set[str]:
    return {kw.arg for kw in call.keywords if kw.arg is not None}


def import_aliases(tree: ast.Module, module: str) -> dict[str, str]:
    """Local name -> imported thing for one module.

    ``import time as t``          -> {"t": "<module>"}
    ``from time import sleep``    -> {"sleep": "sleep"}
    ``from time import time as T``-> {"T": "time"}
    """
    out: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == module:
                    out[a.asname or a.name] = "<module>"
        elif isinstance(node, ast.ImportFrom) and node.module == module:
            for a in node.names:
                out[a.asname or a.name] = a.name
    return out


def enclosing_function(ctx: FileContext, node: ast.AST
                       ) -> Optional[ast.AST]:
    """Nearest enclosing FunctionDef/AsyncFunctionDef, else None."""
    cur = ctx.parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = ctx.parents.get(cur)
    return None


def enclosing_withs(ctx: FileContext, node: ast.AST) -> list[ast.expr]:
    """Context-manager expressions of every ``with`` enclosing ``node``
    WITHIN its innermost function (or module) scope.

    The walk stops at the first function/lambda/class boundary: a closure
    or thread-target defined inside a ``with self._lock:`` block executes
    LATER, after the lock is released — its body does not hold the lock,
    however it is indented."""
    out: list[ast.expr] = []
    cur = ctx.parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda, ast.ClassDef)):
            break
        if isinstance(cur, (ast.With, ast.AsyncWith)):
            out.extend(item.context_expr for item in cur.items)
        cur = ctx.parents.get(cur)
    return out


def self_attr(node: ast.AST) -> Optional[str]:
    """'x' when node is ``self.x``, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def lock_expr_matches(expr: ast.expr, lock: str) -> bool:
    """Does a with-item expression hold the named lock?

    ``lock`` comes from a ``guarded by:`` annotation: ``self._lock`` or
    ``self._locks[i]`` (any index — per-shard lock arrays). Condition
    variables count: ``with self._lock:`` works on both."""
    want_sub = lock.endswith("]")
    base = lock.split("[")[0]
    attr = base.split(".", 1)[1] if "." in base else base
    if want_sub:
        if not isinstance(expr, ast.Subscript):
            return False
        return self_attr(expr.value) == attr
    return self_attr(expr) == attr
