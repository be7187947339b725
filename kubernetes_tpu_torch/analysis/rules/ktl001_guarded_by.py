"""KTL001 — guarded-by: annotated shared state only moves under its lock.

The bug class (reviews re-found it by hand every time): stats
counters and shard maps shared across batcher/stager/auditor threads
mutated with a bare ``+=`` or dict write outside the lock that every other
access path holds. CPython's ``+=`` is not atomic — the undercount silently
deflates the very fleet rates the bench JSONs gate on.

Contract: declaring an attribute with a trailing (or immediately
preceding) ``# guarded by: self._lock`` comment makes every read/write of
``self.<attr>`` in that class illegal outside a ``with self._lock:`` block.

Escapes, mirroring how the codebase actually holds locks:
- ``__init__``/``__post_init__`` construct before the object is shared;
- ``*_locked`` methods are called with the lock held by convention (the
  Go ``fooLocked`` idiom this codebase already uses);
- a method that manually calls ``self.<lock>.acquire(...)`` holds it for
  its whole body (the try/finally non-blocking acquire pattern —
  coarse on purpose: the release discipline is the method's business);
- ``self._locks[i]``-style per-shard lock arrays match any subscript.

Also in scope: ``+=``/``-=`` on module-level numeric counters from inside
a function with no lock ``with`` in sight — the module-global twin of the
same race.
"""

from __future__ import annotations

import ast
import re
from typing import Optional

from kubernetes_tpu_torch.analysis.engine import FileContext
from kubernetes_tpu_torch.analysis.rules.base import (
    Rule,
    dotted_name,
    enclosing_withs,
    lock_expr_matches,
    self_attr,
)

_GUARD_RE = re.compile(r"#\s*guarded by:\s*(self\.\w+(?:\[\w*\])?)")

_EXEMPT_METHODS = ("__init__", "__post_init__")


def _guard_on_line(ctx: FileContext, lineno: int,
                   comment_only: bool = False) -> Optional[str]:
    text = ctx.line_text(lineno)
    if comment_only and not text.strip().startswith("#"):
        return None  # a neighbor's trailing annotation must not leak down
    m = _GUARD_RE.search(text)
    return m.group(1) if m else None


class GuardedByRule(Rule):
    id = "KTL001"
    title = "guarded-by annotation violated"

    # ---- per-class annotation collection ---------------------------------

    @staticmethod
    def _owning_class(ctx: FileContext, node: ast.AST
                      ) -> Optional[ast.ClassDef]:
        cur = ctx.parents.get(node)
        while cur is not None:
            if isinstance(cur, ast.ClassDef):
                return cur
            cur = ctx.parents.get(cur)
        return None

    def _collect_guards(self, ctx: FileContext, cls: ast.ClassDef
                        ) -> dict[str, str]:
        guards: dict[str, str] = {}
        for node in ast.walk(cls):
            if self._owning_class(ctx, node) is not cls:
                continue  # a nested class owns its own annotations
            target = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                target = self_attr(node.targets[0])
            elif isinstance(node, ast.AnnAssign):
                target = self_attr(node.target)
            if target is None:
                continue
            lock = (_guard_on_line(ctx, node.lineno)
                    or _guard_on_line(ctx, node.lineno - 1,
                                      comment_only=True))
            if lock:
                guards[target] = lock
        return guards

    # ---- lock-held analysis ----------------------------------------------

    @staticmethod
    def _holds_via_acquire(func: ast.AST, lock: str) -> bool:
        attr = lock.split("[")[0].split(".", 1)[-1]
        for node in ast.walk(func):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "acquire"):
                base = node.func.value
                if self_attr(base) == attr:
                    return True
                if (isinstance(base, ast.Subscript)
                        and self_attr(base.value) == attr):
                    return True
        return False

    def _exempt_scope(self, ctx: FileContext, node: ast.AST,
                      cls: ast.ClassDef) -> Optional[list[ast.AST]]:
        """Function chain from ``node`` up to (not past) ``cls``; None when
        the INNERMOST frame is __init__-like or *_locked (access exempt).
        Innermost only: a closure defined inside __init__ or a *_locked
        method (a thread target, a callback) executes later, outside the
        construction window / without the caller's lock."""
        chain: list[ast.AST] = []
        cur = ctx.parents.get(node)
        while cur is not None and cur is not cls:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if not chain and (cur.name in _EXEMPT_METHODS
                                  or cur.name.endswith("_locked")):
                    return None
                chain.append(cur)
            cur = ctx.parents.get(cur)
        return chain

    def _check_class(self, ctx: FileContext, cls: ast.ClassDef,
                     out: list[tuple[int, str]]) -> None:
        guards = self._collect_guards(ctx, cls)
        if not guards:
            return
        for node in ast.walk(cls):
            attr = self_attr(node)
            if attr is None or attr not in guards:
                continue
            if self._owning_class(ctx, node) is not cls:
                continue  # nested class: its own annotation set applies
            lock = guards[attr]
            chain = self._exempt_scope(ctx, node, cls)
            if chain is None or not chain:
                continue  # __init__/_locked method, or class-body default
            if any(lock_expr_matches(e, lock)
                   for e in enclosing_withs(ctx, node)):
                continue
            # innermost frame only: an acquire in an OUTER frame does not
            # cover a closure that runs after the frame returns
            if self._holds_via_acquire(chain[0], lock):
                continue
            out.append((node.lineno,
                        f"'self.{attr}' is guarded by '{lock}' but "
                        f"accessed outside 'with {lock}:'"))

    # ---- module-level counters -------------------------------------------

    @staticmethod
    def _module_counters(tree: ast.Module) -> set[str]:
        names: set[str] = set()
        for stmt in tree.body:
            if (isinstance(stmt, ast.Assign)
                    and isinstance(stmt.value, ast.Constant)
                    and isinstance(stmt.value.value, (int, float))
                    and not isinstance(stmt.value.value, bool)):
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
        return names

    def _check_module_counters(self, ctx: FileContext,
                               out: list[tuple[int, str]]) -> None:
        counters = self._module_counters(ctx.tree)
        if not counters:
            return
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.AugAssign)
                    and isinstance(node.op, (ast.Add, ast.Sub))
                    and isinstance(node.target, ast.Name)
                    and node.target.id in counters):
                continue
            func = ctx.parents.get(node)
            in_function = False
            cur = func
            while cur is not None:
                if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    in_function = True
                    break
                cur = ctx.parents.get(cur)
            if not in_function:
                continue  # module-scope init/adjust: single-threaded import
            held = any("lock" in (dotted_name(e) or ast.unparse(e)).lower()
                       for e in enclosing_withs(ctx, node))
            if not held:
                out.append((node.lineno,
                            f"module-level counter '{node.target.id}' "
                            "augmented outside a lock ('+=' is not atomic "
                            "across threads)"))

    # ---- rule entry -------------------------------------------------------

    def visit(self, ctx: FileContext) -> list[tuple[int, str]]:
        out: list[tuple[int, str]] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                self._check_class(ctx, node, out)
        self._check_module_counters(ctx, out)
        return out
