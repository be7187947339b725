"""KTL003 — clock discipline: control loops take a Clock, not the wall.

The deflake lesson: every controller with time-window logic (HPA
stabilization, autoscaler cooldowns, TTL sweeps, lease grace) that called
``time.time()`` directly was a test that could only pass by SLEEPING
through its window — slow at best, flaky under load at worst.
``utils/clock.py`` exists so tests advance a FakeClock instead; this rule
stops new direct wall-clock reads from growing back into the
clock-disciplined trees (controllers/, sched/, descheduler/, autoscaler/,
scenario/ — the trace driver replays on an injected Clock so a FakeClock
can warp through a scenario without sleeping).

``time.sleep`` counts too: a sleeping control loop is an untestable one
(waits belong on stop Events / injectable periods).
"""

from __future__ import annotations

import ast

from kubernetes_tpu_torch.analysis.engine import FileContext
from kubernetes_tpu_torch.analysis.rules.base import Rule, dotted_name, import_aliases

_BANNED = {"time", "monotonic", "sleep", "perf_counter"}

# package-relative dir prefixes under clock discipline
DIRS = ("kubernetes_tpu_torch/controllers/", "kubernetes_tpu_torch/sched/",
        "kubernetes_tpu_torch/descheduler/", "kubernetes_tpu_torch/autoscaler/",
        "kubernetes_tpu_torch/scenario/")

# files inside those trees allowed direct clock access (the clock sources
# themselves, and perf spans that must read the real wall by definition)
WHITELIST = ()


class ClockDisciplineRule(Rule):
    id = "KTL003"
    title = "direct wall clock in a clock-disciplined tree"

    def visit(self, ctx: FileContext) -> list[tuple[int, str]]:
        if not ctx.relpath.startswith(DIRS) or ctx.relpath in WHITELIST:
            return []
        aliases = import_aliases(ctx.tree, "time")
        module_names = {n for n, what in aliases.items()
                        if what == "<module>"}
        func_names = {n: what for n, what in aliases.items()
                      if what in _BANNED}
        out = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name is None:
                continue
            hit = None
            parts = name.split(".")
            if (len(parts) == 2 and parts[0] in module_names
                    and parts[1] in _BANNED):
                hit = name
            elif len(parts) == 1 and parts[0] in func_names:
                hit = f"time.{func_names[parts[0]]}"
            if hit:
                out.append((node.lineno,
                            f"direct {hit}() in a clock-disciplined tree "
                            "(inject utils/clock.Clock so FakeClock tests "
                            "can advance time)"))
        return out
