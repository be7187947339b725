"""KTL008 — durable-file commits go through utils/atomicio.

The WAL snapshot, the audit repro bundles, and the AOT cache's
fingerprint/manifest all persist state a CRASHED process must be able to
trust at its next boot. The only rename-commit discipline that survives
a SIGKILL mid-write is the one ``utils/atomicio.atomic_write`` owns:
temp file in the TARGET directory (same filesystem, so the rename cannot
degrade to a copy), flush + fsync, then ``os.replace``. Before the
helper, the snapshot fold carried its own copy and the
audit bundles wrote in place — a torn half-bundle from a crash mid-write
is evidence that lies.

A raw ``os.replace``/``os.rename``/``shutil.move`` anywhere else is a
hand-rolled commit: either it is the atomic pattern re-implemented (use
the helper), or it is not actually atomic (worse). Reads, ``os.unlink``
and plain writes of scratch data are fine; the rule targets the commit
verb itself.
"""

from __future__ import annotations

import ast

from kubernetes_tpu_torch.analysis.engine import FileContext
from kubernetes_tpu_torch.analysis.rules.base import Rule

WHITELIST = ("kubernetes_tpu_torch/analysis/",
             "kubernetes_tpu_torch/utils/atomicio.py")

# (module alias attribute, function name) pairs that commit a file over
# another path — the verbs atomic_write exists to own
_COMMIT_VERBS = {("os", "replace"), ("os", "rename"),
                 ("shutil", "move")}


class AtomicCommitRule(Rule):
    id = "KTL008"
    title = "rename-commit outside utils/atomicio"

    def visit(self, ctx: FileContext) -> list[tuple[int, str]]:
        if ctx.relpath.startswith(WHITELIST[0]) or ctx.relpath in WHITELIST:
            return []
        out: list[tuple[int, str]] = []
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)):
                continue
            pair = (node.func.value.id, node.func.attr)
            if pair in _COMMIT_VERBS:
                out.append((node.lineno,
                            f"{pair[0]}.{pair[1]}() outside utils/atomicio "
                            "— a durable commit must be the shared "
                            "temp-file + fsync + rename helper "
                            "(atomic_write), not a hand-rolled rename"))
        return out
