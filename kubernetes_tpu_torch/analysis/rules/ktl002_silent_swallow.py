"""KTL002 — silent-swallow: broad excepts must leave a trace.

A chaos sweep replaced every bare ``except: pass`` with a logged +
counted absorb (``scheduler_loop_errors_total{site=...}``) — and review
passes since kept finding fresh ones growing back. Enforced now: a handler
catching everything (bare / ``Exception`` / ``BaseException``) must
re-raise, log, or increment a counter. A broad catch that does none of
those turns every future bug in its try-block into a silent no-op — the
exact failure mode chaos testing exists to kill.

Narrow handlers (``except ApiError:`` etc.) are out of scope: catching a
specific exception is a decision; catching everything silently is a leak.
"""

from __future__ import annotations

import ast

from kubernetes_tpu_torch.analysis.engine import FileContext
from kubernetes_tpu_torch.analysis.rules.base import Rule

_BROAD = {"Exception", "BaseException"}
_LOG_METHODS = {"debug", "info", "warning", "warn", "error", "exception",
                "critical", "log", "print_exc"}
_COUNT_METHODS = {"inc", "observe", "record"}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = t.elts if isinstance(t, ast.Tuple) else [t]
    for n in names:
        if isinstance(n, ast.Name) and n.id in _BROAD:
            return True
        if isinstance(n, ast.Attribute) and n.attr in _BROAD:
            return True
    return False


_COUNTERISH = ("count", "err", "fail", "drop", "miss", "skip", "retr")


def _handles(handler: ast.ExceptHandler) -> bool:
    exc_name = handler.name  # `except Exception as e` binds e
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if (exc_name and isinstance(node, ast.Name)
                and node.id == exc_name):
            return True  # the exception object is consumed, not dropped
        if isinstance(node, ast.AugAssign):
            t = ast.unparse(node.target).lower()
            if any(w in t for w in _COUNTERISH):
                return True  # hand-rolled error/drop counter
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute):
                if f.attr in (_LOG_METHODS | _COUNT_METHODS):
                    return True
                if any(w in f.attr.lower() for w in ("count", "warn")):
                    return True  # self._count_error() and friends
            if isinstance(f, ast.Name) and f.id in ("print", "log"):
                return True
    return False


class SilentSwallowRule(Rule):
    id = "KTL002"
    title = "broad except swallows silently"

    def visit(self, ctx: FileContext) -> list[tuple[int, str]]:
        out = []
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.ExceptHandler) and _is_broad(node)
                    and not _handles(node)):
                what = ("bare except" if node.type is None
                        else "broad except")
                out.append((node.lineno,
                            f"{what} neither re-raises, logs, nor "
                            "increments a counter (silent swallow)"))
        return out
