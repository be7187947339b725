"""KTL004 — thread hygiene: no accidental lifetimes.

Two review-found failure modes behind one rule:

- A ``threading.Thread`` without an explicit ``daemon=`` inherits the
  spawner's flag — a non-daemon worker leaked from a test hangs the whole
  pytest process at exit (a deflake hunt found several).
- A thread nobody joins or watchdog-registers is a thread whose death
  nobody notices — the runner's watchdog exists precisely because silent
  thread deaths turned into stalled control loops.

So: every Thread(...) construction states ``daemon=`` explicitly, and the
constructing module must show SOME serialization evidence — a ``.join(``
call or a watchdog registration. The evidence check is module-granular on
purpose: ownership patterns vary (lists of threads, helper joins), and a
module with neither is wrong however it is shaped.
"""

from __future__ import annotations

import ast

from kubernetes_tpu_torch.analysis.engine import FileContext
from kubernetes_tpu_torch.analysis.rules.base import (
    Rule,
    dotted_name,
    import_aliases,
    keyword_names,
)


def _thread_calls(ctx: FileContext) -> list[ast.Call]:
    aliases = import_aliases(ctx.tree, "threading")
    thread_names = {n for n, what in aliases.items() if what == "Thread"}
    module_names = {n for n, what in aliases.items() if what == "<module>"}
    out = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = dotted_name(node.func)
        if name is None:
            continue
        parts = name.split(".")
        if ((len(parts) == 2 and parts[0] in module_names
             and parts[1] == "Thread")
                or (len(parts) == 1 and parts[0] in thread_names)):
            out.append(node)
    return out


class ThreadHygieneRule(Rule):
    id = "KTL004"
    title = "thread without explicit daemon= or lifecycle management"

    def visit(self, ctx: FileContext) -> list[tuple[int, str]]:
        calls = _thread_calls(ctx)
        if not calls:
            return []
        src = ctx.source
        managed = (".join(" in src or "watchdog" in src.lower()
                   or "register_thread" in src)
        out = []
        for call in calls:
            if "daemon" not in keyword_names(call):
                out.append((call.lineno,
                            "threading.Thread without explicit daemon= "
                            "(inherited flag; a leaked non-daemon worker "
                            "hangs process exit)"))
            elif not managed:
                out.append((call.lineno,
                            "thread is neither join-managed nor watchdog-"
                            "registered in this module (silent death "
                            "becomes a stalled loop)"))
        return out
