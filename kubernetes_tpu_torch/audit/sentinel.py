"""Device-parity sentinel — re-judge sampled device answers with the oracle.

The port of ``kubernetes_tpu/audit/sentinel.py``. A device program that
returns *wrong winners without raising* is invisible to the circuit
breaker (built on exceptions). This sentinel checks for it at runtime:

- the scheduler samples every Kth ``drain_step`` dispatch, capturing the
  typed nodes / bound-pod / namespace-label views the device program's
  resident encoding was built from;
- a dedicated checker thread — never the scheduling loop — re-judges the
  device's answer with the pure-numpy :class:`OracleScheduler`;
- a REFUTED answer (overcommitted node, infeasible placement) writes a
  repro bundle and is kept as :attr:`ParitySentinel.fault`, a
  :class:`ParityError`; the scheduler raises it at its next pop and the
  loop stops for good, as it does for a kernel that fails to launch.

Where the port differs from the reference: the reference trips the
circuit breaker to the numpy oracle on a refutation, so a kernel that
counts wrong would quietly move the scheduling to the CPU. Here it ends
the loop. And a winner with a ``DoNotSchedule`` topology spread
constraint is skipped per pod: the full-set-minus-self check counts a
LATER winner of the same drain that joined its domain without a
constraint of its own (which the device rightly allowed), so it refutes
correct placements (ROADMAP Queue C); the reference judges them.

The verification is one-sided by construction: the device program's
constraints are a superset of the oracle checks applied here (profiles
may ADD plugins/affinity, never remove the core filters — pops from
profiles that disable filters are skipped), and every other constraint
only gets harder to meet as placements are added, so a correct program
is never refuted. Pods whose feasibility depends on mutable shared
catalogs (volumes, DRA claims, host ports) or on the order of the
drain's placements (hard spread) are skipped per pod rather than judged
wrongly.

The reference also samples preemption waves and slice carves; those
submits raise until preemption (ROADMAP Queue A item 4) and slice carving
(item 6) are ported.
"""

from __future__ import annotations

import dataclasses
import logging
import queue as queue_mod
import threading
import time
from typing import Optional

from kubernetes_tpu_torch.api.types import UNSATISFIABLE_DO_NOT_SCHEDULE
from kubernetes_tpu_torch.config.types import not_ported
from kubernetes_tpu_torch.metrics.registry import (
    LOOP_ERRORS,
    PARITY_DIVERGENCES,
    PARITY_SAMPLES,
)
from kubernetes_tpu_torch.utils.tracing import TRACER

_LOG = logging.getLogger(__name__)

# per-sample cap on full per-winner oracle feasibility re-checks (the
# whole-set capacity audit below is uncapped and O(pods))
MAX_FEASIBILITY_CHECKS = 64


def _unbound_view(pod, node_name: str = ""):
    return dataclasses.replace(
        pod, spec=dataclasses.replace(pod.spec, node_name=node_name))


class ParityError(RuntimeError):
    """The oracle refuted a device answer: a kernel returned wrong results
    without raising. A retry or the oracle cannot cure that."""


def _simple(pod) -> bool:
    """Pods the oracle can judge from the captured snapshot alone: no
    volume topology, no DRA claims, no host ports (those read shared
    catalogs the scheduling thread keeps mutating), and no DoNotSchedule
    spread (the full set counts later winners the device rightly placed
    after this one)."""
    return not (pod.spec.volumes or pod.pvc_names()
                or pod.spec.resource_claims or pod.host_ports()
                or any(c.when_unsatisfiable == UNSATISFIABLE_DO_NOT_SCHEDULE
                       for c in pod.spec.topology_spread_constraints))


def verify_drain_winners(nodes, bound, winners, prior_winners,
                         exempt: frozenset = frozenset(),
                         namespace_labels=None,
                         max_checked: int = MAX_FEASIBILITY_CHECKS
                         ) -> list[str]:
    """Judge one resolved drain's winners against the numpy oracle on the
    state captured AT DISPATCH (plus the winners of drains that were
    in flight then — the device's fold already counted them).

    ``exempt``: pod keys with cache deltas the resident context had not
    consumed when this drain dispatched. The device provably did not see
    those changes, so the pods are excluded from the judgment — dropping
    constraints keeps the check one-sided (it can relax, never tighten,
    what the device was asked to satisfy).

    Two passes, mirroring tests' ``check_validity`` contract for the gang
    program:
      1. whole-set capacity audit — bound + all committed winners must fit
         every node's allocatable for every resource;
      2. per-winner feasibility — each winner must be oracle-feasible on
         its node given ALL other placements (full-set-minus-self, so
         mutually-affine gang placements judge correctly).
    Returns problem strings (empty = parity holds)."""
    from kubernetes_tpu_torch.sched.oracle import OracleScheduler
    problems: list[str] = []
    idx = {n.metadata.name: i for i, n in enumerate(nodes)}
    winner_keys = {p.key for p, _ in winners} | {p.key
                                                for p, _ in prior_winners}
    # nodes can churn between patch-compile and capture: a winner on a
    # node the capture missed is not judgeable, only suspicious
    placed = [(pod, node) for pod, node in
              list(prior_winners) + list(winners) if node in idx]
    bound_eff = [p for p in bound
                 if p.key not in winner_keys and p.key not in exempt
                 and p.spec.node_name in idx]

    # ---- pass 1: capacity audit (pure integer arithmetic, uncapped) ------
    from kubernetes_tpu_torch.audit.invariants import (charge_usage,
                                                 find_overcommit,
                                                 node_alloc_map)
    alloc = node_alloc_map(nodes)
    used: dict[str, dict] = {}
    for p in bound_eff:
        charge_usage(used, p.spec.node_name, p.resource_requests())
    for pod, node in placed:
        charge_usage(used, node, pod.resource_requests())
    for name, over in sorted(find_overcommit(alloc, used).items()):
        problems.append(
            f"node {name} overcommitted after the drain's winners: "
            + ", ".join(f"{r} ({v}>{cap})"
                        for r, (v, cap) in sorted(over.items())))

    # ---- pass 2: per-winner oracle feasibility (full set minus self) -----
    placed_views = [(_unbound_view(pod, node), node) for pod, node in placed]
    orc = OracleScheduler(nodes, bound_eff + [v for v, _ in placed_views],
                          namespace_labels=namespace_labels)
    checked = 0
    this_keys = {p.key for p, _ in winners}
    for view, node in placed_views:
        if view.key not in this_keys:
            continue  # prior drains' winners were judged at their resolve
        if checked >= max_checked:
            break
        if not _simple(view):
            continue
        ni = idx[node]
        orc.remove_bound(view)
        try:
            mask, reasons = orc.feasible(_unbound_view(view))
            if not mask[ni]:
                problems.append(
                    f"winner {view.key} -> {node} refuted by the oracle: "
                    f"{reasons.get(node, 'infeasible')}")
        finally:
            orc.restore_bound(view)
        checked += 1
    return problems


class ParitySentinel:
    """Samples device dispatches and re-judges them off the hot path.

    All captures are taken on the scheduling thread (consistent with the
    dispatched program's view); the verdicts run on this sentinel's own
    daemon thread. The first refutation is kept as ``fault`` for the
    scheduling loop to raise."""

    def __init__(self, every: int = 16, audit_dir: Optional[str] = None,
                 max_backlog: int = 8):
        self.every = max(0, int(every))
        self._audit_dir = audit_dir
        self._max_backlog = max_backlog
        self._q: "queue_mod.Queue" = queue_mod.Queue()
        self._thread: Optional[threading.Thread] = None
        self._spawn_lock = threading.Lock()
        self._n_drain = 0
        self._force_drain = False
        self.samples: dict[str, int] = {"drain": 0, "wave": 0, "carve": 0}
        self.divergences = 0
        self.skipped = 0
        self.last_divergence: Optional[dict] = None
        self.fault: Optional[ParityError] = None

    # ---- scheduling-thread half -----------------------------------------

    def force_next(self) -> None:
        """Arm a one-shot guaranteed sample: the next JUDGEABLE drain
        dispatch is parity-checked regardless of the every-Kth modulus.
        (The reference's runner arms it after a boot from its executable
        cache, which the port does not have.) The flag stays armed across
        skipped dispatches (disabled-filter profiles, unjudgeable churn)
        and clears only when a capture actually happens."""
        self._force_drain = True

    def maybe_capture_drain(self, cache, profile, level: str,
                            ctx_seq: int) -> Optional[dict]:
        """Every Kth drain dispatch: capture the typed host views the
        resident encoding mirrors, plus the EXEMPT set — keys of cache
        deltas past ``ctx_seq`` (the resident context's consumed log
        position) the device provably has not seen. Returns None on
        non-sampled dispatches; skips (counted) profiles whose disabled
        filters the oracle cannot honor and captures racing cluster-level
        churn (pending node/full deltas) — judging either would refute
        CORRECT answers.

        Fused folds (deltas applied INSIDE the sampled dispatch as
        drain_step's third input) need no special casing: the scheduler
        advances ``ctx_seq`` past them before capturing, and the scatter
        applies in front of the scan — so the device's view at judgment
        time equals the host views captured here, and the folded deltas
        are correctly NOT exempt. In fact fused folds make MORE dispatches
        judgeable: node churn that used to sit pending (strict-mode skip)
        is consumed by the dispatch itself."""
        if self.every <= 0 and not self._force_drain:
            return None
        self._n_drain += 1
        if (not self._force_drain and self.every > 0
                and self._n_drain % self.every):
            return None
        if profile.enabled_filters is not None:
            self.skipped += 1
            return None
        from kubernetes_tpu_torch.audit.invariants import delta_pod_keys
        entries = cache.deltas_since(ctx_seq)
        exempt = (delta_pod_keys(entries, strict=True)
                  if entries is not None else None)
        if exempt is None:
            self.skipped += 1
            return None
        self._force_drain = False
        return {"site": "drain", "level": level, "ts": time.time(),
                "nodes": cache.list_nodes(),
                "bound": cache.bound_pods(include_assumed=True),
                "ns_labels": cache.namespace_labels(),
                "exempt": frozenset(exempt),
                "profile": profile.scheduler_name}

    def submit_drain(self, capture: dict, winners: list,
                     prior_winners: list) -> None:
        if self._q.qsize() >= self._max_backlog:
            self.skipped += 1
            return
        capture["winners"] = list(winners)
        capture["prior_winners"] = list(prior_winners)
        self.samples["drain"] += 1
        PARITY_SAMPLES.inc({"site": "drain"})
        self._ensure_thread()
        self._q.put(capture)

    def maybe_submit_wave(self, *args, **kwargs) -> None:
        """The reference samples every Kth tensor preemption wave here."""
        raise not_ported("the parity sentinel's preemption-wave sample",
                         "4")

    def maybe_submit_carve(self, *args, **kwargs) -> None:
        """The reference samples every Kth carved slice batch here."""
        raise not_ported("the parity sentinel's slice-carve sample", "6")

    # ---- checker thread --------------------------------------------------

    def _ensure_thread(self) -> None:
        with self._spawn_lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name="parity-sentinel")
                self._thread.start()

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            try:
                with TRACER.span("sentinel/check",
                                 winners=len(item["winners"])):
                    self._check(item)
            except Exception:
                # the checker must never raise its way into silence: a
                # broken check is counted and logged, and the sample is
                # simply inconclusive
                LOOP_ERRORS.inc({"site": "parity_sentinel"})
                _LOG.exception("parity check failed (inconclusive sample)")
            finally:
                self._q.task_done()

    def _check(self, item: dict) -> None:
        problems = verify_drain_winners(
            item["nodes"], item["bound"], item["winners"],
            item["prior_winners"],
            exempt=item.get("exempt", frozenset()),
            namespace_labels=item.get("ns_labels"))
        if problems:
            self._diverged(item, problems)

    def _diverged(self, item: dict, problems: list[str]) -> None:
        from kubernetes_tpu_torch.audit.auditor import (active_chaos_seed,
                                                  default_audit_dir,
                                                  write_bundle)
        site, level = item["site"], item["level"]
        self.divergences += 1
        PARITY_DIVERGENCES.inc({"site": site})
        bundle = write_bundle(
            self._audit_dir or default_audit_dir(), f"parity-{site}",
            {"ts": item["ts"], "site": site, "level": level,
             "chaosSeed": active_chaos_seed(),
             "problems": problems,
             "winners": [(p.key, n) for p, n in item.get("winners", [])],
             "priorWinners": [(p.key, n)
                              for p, n in item.get("prior_winners", [])],
             "nodes": [n.metadata.name for n in item["nodes"]][:200]})
        self.last_divergence = {
            "site": site, "level": level, "ts": item["ts"],
            "problems": problems[:5], "bundle": bundle}
        if self.fault is None:
            self.fault = ParityError(
                f"the oracle refuted the device's answer at {site} "
                f"(level {level!r}): {problems[0]} "
                f"(repro bundle: {bundle or '<write failed>'})")
        _LOG.error(
            "PARITY DIVERGENCE at %s (level %r): the oracle refuted the "
            "device's answer, the loop stops; %d problem(s), first: %s "
            "(repro bundle: %s)", site, level, len(problems),
            problems[0], bundle or "<write failed>")

    # ---- status / lifecycle ---------------------------------------------

    def stats(self) -> dict:
        return {"every": self.every,
                "samples": dict(self.samples),
                "divergences": self.divergences,
                "skipped": self.skipped,
                "lastDivergence": self.last_divergence}

    def drain(self, timeout: float = 5.0) -> None:
        """Block until every submitted sample's VERDICT has landed
        (benches call this before reading stats). Tracks unfinished
        tasks, not queue emptiness — the checker pops an item before
        judging it, so an empty queue can still have a verdict in
        flight."""
        deadline = time.time() + timeout
        while self._q.unfinished_tasks and time.time() < deadline:
            time.sleep(0.01)

    def close(self) -> None:
        t = self._thread
        if t is not None and t.is_alive():
            self._q.put(None)
            self._thread = None
