"""Device-parity sentinel — re-judge sampled device answers with the oracle.

The port of ``kubernetes_tpu/audit/sentinel.py``. A device program that
returns *wrong winners without raising* is invisible to the circuit
breaker (built on exceptions). This sentinel checks for it at runtime:

- the scheduler samples every Kth ``drain_step`` dispatch, capturing the
  typed nodes / bound-pod / namespace-label views the device program's
  resident encoding was built from, and every Kth preemption wave, with
  the host objects its masks were built from;
- a dedicated checker thread — never the scheduling loop — re-judges the
  device's answer with the pure-numpy :class:`OracleScheduler`;
- a REFUTED answer (overcommitted node, infeasible placement) writes a
  repro bundle and is kept as :attr:`ParitySentinel.fault`, a
  :class:`ParityError`; the scheduler raises it at its next pop and the
  loop stops for good, as it does for a kernel that fails to launch.

Where the port differs from the reference: the reference trips the
circuit breaker to the numpy oracle on a refutation, so a kernel that
counts wrong would quietly move the scheduling to the CPU. Here it ends
the loop. And a drain winner with a ``DoNotSchedule`` topology spread
constraint is skipped per pod: the full-set-minus-self check counts a
LATER winner of the same drain that joined its domain without a
constraint of its own (which the device rightly allowed), so it refutes
correct placements (ROADMAP Queue C); the reference judges them. A wave
is judged in its own sequential-commit order, so a preemptor with such a
constraint is judged there, as in the reference.

The verification is one-sided by construction: the device program's
constraints are a superset of the oracle checks applied here (profiles
may ADD plugins/affinity, never remove the core filters — pops from
profiles that disable filters are skipped), and every other constraint
only gets harder to meet as placements are added, so a correct program
is never refuted. Pods whose feasibility depends on mutable shared
catalogs (volumes, DRA claims, host ports) or on the order of the
drain's placements (hard spread) are skipped per pod rather than judged
wrongly.

Slice carves are sampled too: every Kth carved group batch, the numpy
oracle carver replays the device carver's member -> node picks, and any
difference is a divergence (the carve is deterministic end to end).
"""

from __future__ import annotations

import dataclasses
import logging
import queue as queue_mod
import threading
import time
from typing import Optional

from kubernetes_tpu_torch.api.types import UNSATISFIABLE_DO_NOT_SCHEDULE
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


def _snapshot_judgeable(pod) -> bool:
    """Pods the oracle can judge from the captured snapshot alone: no
    volume topology, no DRA claims, no host ports (those read shared
    catalogs the scheduling thread keeps mutating)."""
    return not (pod.spec.volumes or pod.pvc_names()
                or pod.spec.resource_claims or pod.host_ports())


def _simple(pod) -> bool:
    """Drain winners the full-set-minus-self check can judge: snapshot
    judgeable, and no DoNotSchedule spread (the full set counts later
    winners the device rightly placed after this one)."""
    return _snapshot_judgeable(pod) and not any(
        c.when_unsatisfiable == UNSATISFIABLE_DO_NOT_SCHEDULE
        for c in pod.spec.topology_spread_constraints)


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


def verify_carve_assignments(nodes, bound, assignments,
                             members) -> list[str]:
    """Re-run the numpy oracle carver (sched/oracle.py plan_slices over
    topology/carve.numpy_grids) on the captured host views and demand
    BIT-EQUAL member -> node assignments for every gang the device carved.
    The carve is deterministic end to end — same grids, same max-wins
    scatter, same first-fit flat order — so ANY difference is a
    divergence, never a tie-break."""
    from kubernetes_tpu_torch.sched.oracle import OracleScheduler
    orc = OracleScheduler(nodes, bound)
    plans = orc.plan_slices(members, validate=False)
    problems: list[str] = []
    for gang, got in sorted(assignments.items()):
        want = plans.get(gang)
        if want != got:
            problems.append(
                f"carve for gang {gang!r} diverged: device placed "
                f"{sorted(got.items())}, the oracle carver says "
                f"{sorted(want.items()) if want else None}")
    return problems


def verify_wave_results(nodes, bound, views, results,
                        namespace_labels=None) -> list[str]:
    """Judge one preemption wave's results with the oracle, in the wave's
    sequential-commit order: every named victim must actually be a bound
    pod on that node with priority strictly below the preemptor's, and
    after the evictions the preemptor must be oracle-feasible there."""
    from kubernetes_tpu_torch.sched.oracle import OracleScheduler
    problems: list[str] = []
    idx = {n.metadata.name: i for i, n in enumerate(nodes)}
    orc = OracleScheduler(nodes, [p for p in bound
                                  if p.spec.node_name in idx],
                          namespace_labels=namespace_labels)
    by_key = {p.key: p for p in bound}
    evicted: set = set()
    for view, res in zip(views, results):
        if res is None:
            continue
        ni = idx.get(res.node_name)
        if ni is None:
            problems.append(f"preemptor {view.key}: unknown node "
                            f"{res.node_name!r}")
            continue
        ok = True
        for v in res.victims:
            real = by_key.get(v.key)
            if real is None or real.spec.node_name != res.node_name:
                problems.append(
                    f"preemptor {view.key}: victim {v.key} is not a bound "
                    f"pod on {res.node_name}")
                ok = False
                continue
            if v.key in evicted:
                # victims must be deduped across picks — a double eviction
                # double-frees capacity for every later pick in the wave
                problems.append(
                    f"preemptor {view.key}: victim {v.key} already "
                    "evicted by an earlier pick this wave")
                ok = False
                continue
            if v.spec.priority >= view.spec.priority:
                problems.append(
                    f"preemptor {view.key} (prio {view.spec.priority}) "
                    f"named equal/higher-priority victim {v.key} "
                    f"(prio {v.spec.priority})")
                ok = False
        if not ok:
            continue
        for v in res.victims:
            evicted.add(v.key)
            orc.remove_bound(by_key[v.key])
        if (_snapshot_judgeable(view)
                and not orc.feasible_one(_unbound_view(view), ni)):
            problems.append(
                f"preemptor {view.key} still infeasible on "
                f"{res.node_name} after evicting "
                f"{[v.key for v in res.victims]}")
        # sequential commit: the preemptor occupies the node for the rest
        # of the wave (victims stay evicted)
        orc.assume(_unbound_view(view), ni)
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
        self._n_wave = 0
        self._n_carve = 0
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
        (The runner arms it after a boot from a kernel cache with entries:
        sched/aotcache.py.) The flag stays armed across
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

    def maybe_submit_wave(self, nodes, bound, views, results, level: str,
                          namespace_labels=None) -> None:
        """Every Kth device preemption wave: the inputs are already typed
        host objects in the caller's hands — capture by reference (the
        product treats pod subtrees as immutable), so no race with the
        cache exists: the device masks came from the same snapshot.
        ``namespace_labels`` may be a callable — it is only invoked on
        SAMPLED waves."""
        if self.every <= 0:
            return
        self._n_wave += 1
        if self._n_wave % self.every:
            return
        if self._q.qsize() >= self._max_backlog:
            self.skipped += 1
            return
        self.samples["wave"] += 1
        PARITY_SAMPLES.inc({"site": "wave"})
        if callable(namespace_labels):
            namespace_labels = namespace_labels()
        self._ensure_thread()
        self._q.put({"site": "wave", "level": level, "ts": time.time(),
                     "nodes": list(nodes), "bound": list(bound),
                     "views": list(views), "results": list(results),
                     "ns_labels": namespace_labels})

    def maybe_submit_carve(self, nodes, bound, assignments, members,
                           level: str = "single") -> None:
        """Every Kth carved group batch: the scheduler hands over the
        typed host views its snapshot encoded (capture by reference — the
        product treats pod subtrees as immutable) plus the device carver's
        member -> node picks per gang. The checker replays the numpy
        oracle carver and demands bit-equality."""
        if self.every <= 0:
            return
        self._n_carve += 1
        if self._n_carve % self.every:
            return
        if self._q.qsize() >= self._max_backlog:
            self.skipped += 1
            return
        self.samples["carve"] += 1
        PARITY_SAMPLES.inc({"site": "carve"})
        self._ensure_thread()
        self._q.put({"site": "carve", "level": level, "ts": time.time(),
                     "nodes": list(nodes), "bound": list(bound),
                     "assignments": dict(assignments),
                     "members": list(members)})

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
                with TRACER.span("sentinel/check", site=item["site"],
                                 winners=len(item.get("winners")
                                             or item.get("results")
                                             or item.get("members") or ())):
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
        if item["site"] == "drain":
            problems = verify_drain_winners(
                item["nodes"], item["bound"], item["winners"],
                item["prior_winners"],
                exempt=item.get("exempt", frozenset()),
                namespace_labels=item.get("ns_labels"))
        elif item["site"] == "carve":
            problems = verify_carve_assignments(
                item["nodes"], item["bound"], item["assignments"],
                item["members"])
        else:
            problems = verify_wave_results(
                item["nodes"], item["bound"], item["views"],
                item["results"], namespace_labels=item.get("ns_labels"))
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
             "carve": {g: sorted(a.items()) for g, a
                       in item.get("assignments", {}).items()},
             "winners": [(p.key, n) for p, n in item.get("winners", [])],
             "priorWinners": [(p.key, n)
                              for p, n in item.get("prior_winners", [])],
             "results": [(v.key, r.node_name, [x.key for x in r.victims])
                         for v, r in zip(item.get("views", []),
                                         item.get("results", []))
                         if r is not None],
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

    def close(self, timeout: float = 5.0) -> None:
        """Poison-pill the checker thread and join it (a verdict in flight
        lands first)."""
        t = self._thread
        if t is not None and t.is_alive():
            self._q.put(None)
            self._thread = None
            t.join(timeout=timeout)
