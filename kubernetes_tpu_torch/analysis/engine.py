"""ktpu-lint engine — files in, findings out, baseline-gated.

The paper's scheduler is a lock-heavy, thread-heavy Go system reimplemented
in Python+JAX. Go ships a race detector and ``go vet``; Python ships
neither, and review-hardening passes kept re-finding the same
bug classes by hand (unlocked stat ``+=`` on batcher shards, silent except
swallows, untestable ``time.time`` in controllers, donate-without-pinned-
out_shardings). This package turns each of those review findings into an
enforced invariant: an AST rule with a stable fingerprint, a committed
baseline for the pre-existing findings, and a fail-on-NEW gate in tier-1.

Mechanics
---------
- Every rule (rules/) visits each file's AST via a shared
  :class:`FileContext`; cross-file rules accumulate and report from
  ``finalize()``.
- A finding's fingerprint hashes (relpath, rule, normalized source line,
  occurrence index) — NOT the line number — so unrelated edits above a
  baselined finding don't resurrect it as "new".
- ``# ktpu-lint: disable=KTL00N -- reason`` suppresses a rule on its line
  (or the next line when the comment stands alone). The reason string is
  REQUIRED: a reasonless disable suppresses nothing and is itself reported
  (KTL000) — an exemption nobody can explain is a bug report, not policy.
"""

from __future__ import annotations

import ast
import hashlib
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Iterable, Optional

# comment grammar: disable=<rule>[,<rule>...] followed by "-- reason text"
_SUPPRESS_RE = re.compile(
    r"#\s*ktpu-lint:\s*disable=(?P<rules>KTL\d{3}(?:\s*,\s*KTL\d{3})*)"
    r"(?P<reason>\s*--\s*\S.*)?")

META_RULE = "KTL000"  # reasonless/dangling suppression comments


@dataclass(frozen=True)
class Finding:
    rule: str          # "KTL001"
    path: str          # repo-relative, "/"-separated
    line: int          # 1-indexed
    message: str
    fingerprint: str   # stable across unrelated edits (see module doc)

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "fingerprint": self.fingerprint}


@dataclass
class Suppression:
    rules: tuple[str, ...]
    line: int            # line the comment sits on
    has_reason: bool
    own_line: bool       # comment is the only thing on its line
    used: bool = False


@dataclass
class FileContext:
    """Everything a rule needs about one file, parsed once."""

    path: str                 # absolute
    relpath: str              # relative to the scanned package's parent
    source: str
    lines: list[str]
    tree: ast.Module
    suppressions: list[Suppression] = field(default_factory=list)
    _parents: Optional[dict] = None

    @property
    def parents(self) -> dict:
        """Child AST node -> parent map (built lazily, once per file)."""
        if self._parents is None:
            p: dict = {}
            for node in ast.walk(self.tree):
                for child in ast.iter_child_nodes(node):
                    p[child] = node
            self._parents = p
        return self._parents

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def suppressed(self, rule: str, lineno: int) -> bool:
        """True when an inline (or preceding own-line) disable comment with
        a reason covers ``rule`` at ``lineno``."""
        for s in self.suppressions:
            if rule not in s.rules or not s.has_reason:
                continue
            if s.line == lineno or (s.own_line and s.line == lineno - 1):
                s.used = True
                return True
        return False


def parse_suppressions(source: str) -> list[Suppression]:
    """Tokenize-level scan (regex on strings would misfire inside string
    literals; the tokenizer knows what is a comment)."""
    out: list[Suppression] = []
    try:
        tokens = tokenize.generate_tokens(iter(source.splitlines(True)).__next__)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if not m:
                continue
            rules = tuple(r.strip() for r in m.group("rules").split(","))
            out.append(Suppression(
                rules=rules, line=tok.start[0],
                has_reason=bool(m.group("reason")),
                own_line=tok.string.strip() == tok.line.strip()))
    except tokenize.TokenError:
        pass  # a file the parser already accepted; partial scan is fine
    return out


def load_file(path: str, relpath: str) -> Optional[FileContext]:
    """Parse one file into a FileContext, or None on a syntax error (the
    syntax pass in tools/lint.sh owns that failure mode)."""
    try:
        with open(path, encoding="utf-8") as f:
            source = f.read()
        tree = ast.parse(source, filename=path)
    except (OSError, SyntaxError, ValueError):
        return None
    ctx = FileContext(path=path, relpath=relpath, source=source,
                      lines=source.splitlines(), tree=tree)
    ctx.suppressions = parse_suppressions(source)
    return ctx


def iter_py_files(root: str) -> Iterable[tuple[str, str]]:
    """(abspath, relpath) for every .py under ``root``, sorted for
    deterministic finding/fingerprint order.

    relpaths anchor at the TOP of the package chain containing ``root``
    (ascend while ``__init__.py`` is present), so scanning a subtree
    (``... kubernetes_tpu_torch/sched``) yields the same
    ``kubernetes_tpu_torch/sched/...`` relpaths — and therefore the same
    fingerprints, rule path-scopes, and baseline matches — as a
    whole-package run. Non-package roots (test fixture trees) anchor at
    the root's parent as before."""
    root = os.path.abspath(root)
    top = root
    while os.path.isfile(os.path.join(top, "__init__.py")):
        top = os.path.dirname(top)
        if top == os.path.dirname(top):
            break  # filesystem root: give up ascending
    base = top if top != root else os.path.dirname(root)
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d != "__pycache__" and not d.startswith("."))
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                ap = os.path.join(dirpath, fn)
                yield ap, os.path.relpath(ap, base).replace(os.sep, "/")


def fingerprint(relpath: str, rule: str, line_text: str, occurrence: int
                ) -> str:
    """Stable id: path + rule + whitespace-normalized line content +
    occurrence index among identical (path, rule, content) triples."""
    norm = " ".join(line_text.split())
    h = hashlib.sha1(
        f"{relpath}|{rule}|{norm}|{occurrence}".encode()).hexdigest()
    return h[:16]


def make_findings(ctx: FileContext, rule: str,
                  raw: list[tuple[int, str]]) -> list[Finding]:
    """Attach fingerprints + apply suppressions to (lineno, message) pairs
    a rule produced for one file."""
    seen: dict[tuple, int] = {}
    out = []
    for lineno, message in sorted(raw):
        if ctx.suppressed(rule, lineno):
            continue
        key = (rule, " ".join(ctx.line_text(lineno).split()))
        occ = seen.get(key, 0)
        seen[key] = occ + 1
        out.append(Finding(
            rule=rule, path=ctx.relpath, line=lineno, message=message,
            fingerprint=fingerprint(ctx.relpath, rule,
                                    ctx.line_text(lineno), occ)))
    return out


def meta_findings(ctx: FileContext) -> list[Finding]:
    """KTL000 (reasonless half): suppression comments without a reason
    string suppress nothing and are findings themselves."""
    raw = [(s.line, "ktpu-lint disable comment without a reason "
                    "(write `# ktpu-lint: disable=%s -- <why>`)"
            % ",".join(s.rules))
           for s in ctx.suppressions if not s.has_reason]
    return make_findings(ctx, META_RULE, raw)


def dangling_findings(ctxs: list[FileContext],
                      active_rules: set[str]) -> list[Finding]:
    """KTL000 (dangling half): a reasoned disable that suppressed nothing
    this run is a stale exemption — the offending code moved or was fixed,
    and the comment now grants a silent pass to whatever lands on that
    line next. Only judged for rules that actually RAN (a --rule-filtered
    run must not condemn other rules' suppressions)."""
    out: list[Finding] = []
    for ctx in ctxs:
        raw = []
        for s in ctx.suppressions:
            if not s.has_reason or s.used:
                continue
            if not set(s.rules) <= active_rules:
                continue
            raw.append((s.line,
                        "suppression for %s matched no finding (stale "
                        "exemption: remove it, or re-anchor it to the "
                        "code it excuses)" % ",".join(s.rules)))
        out.extend(make_findings(ctx, META_RULE, raw))
    return out


def run_analysis(root: str, rules: Optional[list] = None) -> list[Finding]:
    """Run every rule over every .py under ``root``; -> sorted findings.

    ``rules``: rule instances (default: fresh instances of the full
    registry — rules are stateful across files, so one instance set per
    run)."""
    from kubernetes_tpu_torch.analysis.rules import make_rules
    active = make_rules() if rules is None else rules
    findings: list[Finding] = []
    ctxs: list[FileContext] = []
    for path, relpath in iter_py_files(root):
        ctx = load_file(path, relpath)
        if ctx is None:
            continue
        ctxs.append(ctx)
        findings.extend(meta_findings(ctx))
        for rule in active:
            findings.extend(make_findings(ctx, rule.id, rule.visit(ctx)))
    for rule in active:
        findings.extend(rule.finalize())
    # after finalize: cross-file rules have applied their suppressions,
    # so any still-unused reasoned disable is a stale exemption
    findings.extend(dangling_findings(ctxs, {r.id for r in active}))
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.fingerprint))
    return findings
