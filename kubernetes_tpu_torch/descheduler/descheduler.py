"""Descheduler — periodic eviction planning + gang defragmentation loop.

Reference: ``kubernetes-sigs/descheduler`` (``pkg/descheduler/descheduler.go``
RunDeschedulerStrategies: list nodes/pods, run each enabled strategy,
evict through the Eviction API). Differences that matter here:

- Discovery and validation are SPLIT: strategies only nominate candidate
  sets; the planner proves every nomination with one batched
  ``run_filters``/``run_scores`` re-placement simulation before the first
  eviction is issued (descheduler/planner.py).
- Gang defragmentation is a first-class mode: a pending gang (pods sharing
  the ``kubernetes-tpu.io/gang`` label) that cannot fit triggers a
  targeted consolidation search scored by fewest evictions — the missing
  half of the autoscaler's convergence loop (consolidate before you buy).
- Evictions flow through the Eviction subresource, so PodDisruptionBudgets
  are enforced server-side too (store/apiserver.py consults the same
  arithmetic the disruption controller maintains); a 429 mid-set aborts
  the rest of that set — the budget said no.
- Evicted BARE pods (no owner controller) are re-created unbound, so they
  land back in the scheduling queue exactly like a controller-managed
  pod's replacement would — without this, descheduling a bare pod would
  delete work instead of moving it.

The PyTorch port of ``kubernetes_tpu/descheduler/descheduler.py``: the
planner's and the quota plane's device work runs on ``device`` (None = the
card) or, through ``resident``, on the scheduler's context. PyYAML is
imported by ``from_yaml`` alone, so the module imports without it. The
ConfigMap is the status surface (``ktpu deschedule status``; ``ktpu
deschedule run`` drives one ``run_once``). ``run_once`` is driven by
``start``'s own loop, every ``interval_s`` unless told another period, or
by sched/bgplanner.BackgroundPlanner. Unlike the reference's, the loop of
``start`` stops for good on a failure that ``sched/faults.is_fatal`` calls
fatal (``loop_error`` keeps it), and logs only other failures.
"""

from __future__ import annotations

import json
import logging
import threading
from dataclasses import dataclass, field
from typing import Optional

from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.autoscaler.autoscaler import _terminal
from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.descheduler.planner import (
    EvictionPlan,
    GangDefragPlan,
    plan_evictions,
    plan_gang_defrag,
)
from kubernetes_tpu_torch.descheduler.strategies import (
    GANG_LABEL,
    STRATEGY_BUILDERS,
    gang_consolidation_candidates,
)
from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
from kubernetes_tpu_torch.metrics.registry import (
    DESCHEDULER_EVICTIONS,
    DESCHEDULER_LOOP_DURATION,
    DESCHEDULER_PLAN_BATCH,
)
from kubernetes_tpu_torch.utils.clock import REAL_CLOCK, rfc3339_from_epoch
from kubernetes_tpu_torch.utils.tracing import TRACER

_LOG = logging.getLogger(__name__)

STATUS_CONFIGMAP = "descheduler-status"
STATUS_NAMESPACE = "default"

DEFAULT_STRATEGIES: dict[str, dict] = {
    "RemoveDuplicates": {},
    "RemovePodsViolatingNodeAffinity": {},
    "RemovePodsViolatingTopologySpread": {},
    "HighNodeUtilization": {"threshold": 0.3},
}


@dataclass
class DeschedulerConfiguration:
    """Knobs (DeschedulerPolicy analog). YAML keys mirror the camelCase
    the rest of the config surface speaks."""

    interval_s: float = 60.0
    max_evictions_per_cycle: int = 16
    gang_defrag: bool = True
    gang_max_drain_nodes: int = 8
    requeue_bare_pods: bool = True
    # tenant name -> max victims this tenant may contribute per cycle
    # (enforced device-side in ONE quota-plane dispatch; absent = unlimited)
    tenant_drain_quotas: dict = field(default_factory=dict)
    # strategy name -> kwargs for its builder (descheduler/strategies.py)
    strategies: dict = field(
        default_factory=lambda: dict(DEFAULT_STRATEGIES))

    @classmethod
    def from_dict(cls, d: dict) -> "DeschedulerConfiguration":
        cfg = cls()
        for yaml_key, attr in [
            ("deschedulerInterval", "interval_s"),
            ("maxEvictionsPerCycle", "max_evictions_per_cycle"),
            ("gangDefrag", "gang_defrag"),
            ("gangMaxDrainNodes", "gang_max_drain_nodes"),
            ("requeueBarePods", "requeue_bare_pods"),
        ]:
            if yaml_key in d:
                setattr(cfg, attr, type(getattr(cfg, attr))(d[yaml_key]))
        if "tenantDrainQuotas" in d:
            cfg.tenant_drain_quotas = {
                str(k): int(v)
                for k, v in (d["tenantDrainQuotas"] or {}).items()}
        if "profiles" in d:
            # profiles: [{name, strategies: {Name: {args}|null}}] — flattened
            # into one strategy map (single-framework runtime)
            strategies: dict[str, dict] = {}
            for prof in d["profiles"] or []:
                for name, args in (prof.get("strategies") or {}).items():
                    strategies[name] = dict(args or {})
            cfg.strategies = strategies
        elif "strategies" in d:
            cfg.strategies = {k: dict(v or {})
                              for k, v in (d["strategies"] or {}).items()}
        return cfg

    @classmethod
    def from_yaml(cls, path: str) -> "DeschedulerConfiguration":
        import yaml
        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f) or {})


class Descheduler:
    """The control loop. ``autoscaler``: optional ClusterAutoscaler whose
    ``note_drained`` gets the names of nodes a cycle fully drained — the
    scale-down handoff (the unneeded-window clock starts at drain time,
    not at the autoscaler's next observation)."""

    def __init__(self, client, config: Optional[DeschedulerConfiguration] = None,
                 clock=None, autoscaler=None, resident=None, device=None):
        self.client = client
        self.config = config or DeschedulerConfiguration()
        self.clock = clock or REAL_CLOCK
        self.autoscaler = autoscaler
        # resident fast path (encode/overlay.ResidentPlanner): when set,
        # the planner's one encode+mask rides the scheduler's device-
        # resident encoding; declines fall back to self.encoder cold
        self.resident = resident
        self.device = device
        self.encoder = SnapshotEncoder()   # persistent: stable intern ids
        self._last: dict = {"cycle": None}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the fatal failure that stopped start()'s loop, else None
        self.loop_error: Optional[BaseException] = None

    # ---- observation ----------------------------------------------------

    def _observe(self):
        with TRACER.span("planner/observe", planner="descheduler"):
            node_dicts = self.client.nodes().list()
            pod_dicts = [p for p in self.client.resource("pods", None).list()
                         if not _terminal(p)]
            nodes = [Node.from_dict(d) for d in node_dicts]
            pods = [Pod.from_dict(d) for d in pod_dicts]
        bound = [p for p in pods if p.spec.node_name]
        pending = [p for p in pods if not p.spec.node_name]
        return nodes, bound, pending, pod_dicts

    def _list_pdbs(self) -> list[dict]:
        from kubernetes_tpu_torch.api.policy import list_pdbs
        return list_pdbs(self.client)

    # ---- planning -------------------------------------------------------

    def plan(self, nodes=None, bound=None, pending=None, pod_dicts=None,
             ) -> tuple[EvictionPlan, list[GangDefragPlan]]:
        """Build this cycle's plan without executing it (CLI --dry-run)."""
        if nodes is None:
            nodes, bound, pending, pod_dicts = self._observe()
        pdbs = self._list_pdbs()
        candidates = []
        import inspect
        for name, args in self.config.strategies.items():
            builder = STRATEGY_BUILDERS.get(name)
            if builder is None:
                _LOG.warning("unknown descheduler strategy %r", name)
                continue
            kwargs = dict(args)
            params = inspect.signature(builder).parameters
            if "encoder" in params:
                # share the loop's persistent encoder: stable intern ids and
                # no full re-encode (or shape recompile) per periodic cycle
                kwargs.setdefault("encoder", self.encoder)
            if "device" in params:
                kwargs.setdefault("device", self.device)
            if "pending" in params:
                # demand-driven strategies (SliceDefrag) read the pending
                # set: what to free is defined by who is waiting
                kwargs.setdefault("pending", pending)
            if "pdbs" in params:
                kwargs.setdefault("pdbs", pdbs)
            with TRACER.span(f"planner/strategy/{name}"):
                candidates.extend(builder(nodes, bound, **kwargs))
        # None stays None: the planner falls back to the bound pods for PDB
        # arithmetic — an empty list would make every covered budget compute
        # healthy=0 and silently block each guarded eviction
        bound_dicts = ([p for p in pod_dicts
                        if (p.get("spec") or {}).get("nodeName")]
                       if pod_dicts is not None else None)
        plan = plan_evictions(
            nodes, bound, candidates, pdbs=pdbs,
            all_pod_dicts=bound_dicts,
            encoder=self.encoder,
            max_evictions=self.config.max_evictions_per_cycle,
            resident=self.resident, device=self.device)
        DESCHEDULER_PLAN_BATCH.set(plan.batch_victims,
                                   {"phase": "strategies"})
        gang_plans = []
        if self.config.gang_defrag and pending:
            gang_plans = self._plan_gangs(
                nodes, bound, pending, pdbs, bound_dicts,
                already=plan.evictions, ledger=plan.ledger,
                claimed={p.key for s in plan.accepted for p in s.victims})
        else:
            # gangless cycle: zero the gauge, or it reports the previous
            # cycle's batch forever (see _plan_gangs)
            DESCHEDULER_PLAN_BATCH.set(0, {"phase": "gangDefrag"})
        self._apply_tenant_quotas(plan, gang_plans)
        return plan, gang_plans

    def _apply_tenant_quotas(self, plan: EvictionPlan,
                             gang_plans: list[GangDefragPlan]) -> None:
        """Per-tenant drain-slot quotas, enforced DEVICE-SIDE: every
        accepted victim rides one quota-plane dispatch
        (encode/overlay.tenant_quota_mask) in execution order — strategy
        sets first, then gangs, matching ``_execute``. A set containing
        any victim ranked past its tenant's cap blocks WHOLE (half a
        drain helps nobody); its victims still consume their slots, so
        admission stays a pure function of the one dispatch's verdicts —
        no host-side re-ranking or re-check. Unlabeled victims and
        tenants without a configured quota are unlimited."""
        quotas_cfg = self.config.tenant_drain_quotas
        if not quotas_cfg:
            return
        from kubernetes_tpu_torch.encode.overlay import tenant_quota_mask
        from kubernetes_tpu_torch.encode.snapshot import TENANT_LABEL
        tenants = sorted(quotas_cfg)
        t_index = {t: i for i, t in enumerate(tenants)}
        quotas = [int(quotas_cfg[t]) for t in tenants]
        sets = [(s, None) for s in plan.accepted]
        sets += [(gp.accepted, gp) for gp in gang_plans
                 if gp.accepted is not None]
        victims = [p for s, _gp in sets for p in s.victims]
        if not victims:
            return
        ids = [t_index.get(p.metadata.labels.get(TENANT_LABEL, ""), -1)
               for p in victims]
        allowed = tenant_quota_mask(ids, quotas,     # ONE dispatch
                                    device=self.device)
        i = 0
        for s, gp in sets:
            n = len(s.victims)
            ok = bool(allowed[i:i + n].all())
            i += n
            if ok:
                continue
            if gp is None:
                plan.accepted = [x for x in plan.accepted if x is not s]
                plan.blocked[s.name] = "tenant drain quota exceeded"
            else:
                gp.accepted = None
                gp.blocked[s.name] = "tenant drain quota exceeded"

    def _plan_gangs(self, nodes, bound, pending, pdbs, bound_dicts,
                    already: int = 0, ledger=None,
                    claimed: Optional[set] = None) -> list[GangDefragPlan]:
        gangs: dict[str, list[Pod]] = {}
        for p in pending:
            g = p.metadata.labels.get(GANG_LABEL)
            if g:
                gangs.setdefault(g, []).append(p)
        out = []
        budget = self.config.max_evictions_per_cycle - already
        batch_total = 0
        # victim keys a prior plan in THIS cycle already evicts (strategy
        # sets, then each earlier gang): skipped by the planner so one pod
        # is never evicted twice nor PDB-charged twice in a cycle
        claimed = set(claimed or ())
        for g in sorted(gangs):
            members = gangs[g]
            prio = min(p.spec.priority for p in members)
            cands = gang_consolidation_candidates(
                nodes, bound, max_nodes=self.config.gang_max_drain_nodes,
                max_victim_priority=prio,
                pdbs=pdbs, all_pod_dicts=bound_dicts)
            gp = plan_gang_defrag(
                nodes, bound, members, g, cands, pdbs=pdbs,
                all_pod_dicts=bound_dicts,
                encoder=self.encoder,
                max_evictions=max(budget, 0),
                # one cycle, one ledger: this gang plans against the
                # strategy plan's and every earlier gang's committed moves
                ledger=ledger, claimed=claimed,
                resident=self.resident, device=self.device)
            ledger = gp.ledger or ledger
            batch_total += gp.batch_victims
            if gp.accepted is not None:
                budget -= len(gp.accepted.victims)
                claimed |= {p.key for p in gp.accepted.victims}
            out.append(gp)
        # the cycle's total victim rows across every gang's batched
        # validation — per-gang .set() would report only the last gang, and
        # skipping the write on gangless cycles would report the previous
        # cycle's batch forever
        DESCHEDULER_PLAN_BATCH.set(batch_total, {"phase": "gangDefrag"})
        return out

    # ---- execution ------------------------------------------------------

    def _evict(self, p: Pod, strategy: str) -> bool:
        md = p.metadata
        try:
            self.client.pods(md.namespace or "default").evict(md.name)
        except ApiError as e:
            if e.code == 404:
                DESCHEDULER_EVICTIONS.inc({"strategy": strategy,
                                           "result": "gone"})
                return True   # already deleted: the goal state holds
            DESCHEDULER_EVICTIONS.inc({"strategy": strategy,
                                       "result": "refused"})
            _LOG.warning("eviction of %s refused (%s)", p.key, e.code)
            return False
        DESCHEDULER_EVICTIONS.inc({"strategy": strategy,
                                   "result": "evicted"})
        if self.config.requeue_bare_pods and not md.owner_references:
            self._requeue(p)
        return True

    def _requeue(self, p: Pod) -> None:
        """Re-create a bare evicted pod unbound — the stand-in for the
        controller that would replace an owned pod. The copy drops binding,
        status, and store identity; the scheduler's informer picks it up
        and it re-enters the queue like any new pod."""
        d = p.to_dict()
        d.get("spec", {}).pop("nodeName", None)
        d.pop("status", None)
        md = d.get("metadata", {})
        for k in ("resourceVersion", "uid", "creationTimestamp"):
            md.pop(k, None)
        try:
            self.client.pods(md.get("namespace", "default")).create(d)
        except ApiError:
            _LOG.exception("requeue of evicted pod %s failed", p.key)

    def _execute(self, plan: EvictionPlan,
                 gang_plans: list[GangDefragPlan]) -> dict:
        evicted: list[str] = []
        aborted: dict[str, str] = {}
        sets = [(s, s.strategy, None) for s in plan.accepted]
        sets += [(gp.accepted, "GangDefrag", gp) for gp in gang_plans
                 if gp.accepted is not None]
        touched: set[str] = set()
        for aset, strategy, gp in sets:
            if gp is not None:
                # Reserve the capacity the drain opens BEFORE the victims'
                # replacements exist: the eviction re-creates each bare
                # victim immediately, and an unreserved gang pod parked in
                # backoffQ (time-gated, not event-woken) loses the vacated
                # node to the fresh replacement almost every cycle.
                self._nominate_gang(gp)
            ok = True
            for p in aset.victims:
                if not self._evict(p, strategy):
                    aborted[aset.name] = f"eviction of {p.key} refused"
                    ok = False
                    break
                evicted.append(p.key)
            if ok:
                touched |= {p.spec.node_name for p in aset.victims}
            elif gp is not None:
                self._unnominate_gang(gp)
        drained_candidates = self._drained_nodes(touched)
        if drained_candidates and self.autoscaler is not None:
            self.autoscaler.note_drained(sorted(drained_candidates))
        return {"evicted": evicted, "aborted": aborted,
                "drained": sorted(drained_candidates)}

    def _nominate_gang(self, gp: GangDefragPlan) -> None:
        """Write each gang member's status.nominatedNodeName from the
        proof's placement (upstream preemption's reservation contract,
        pkg/scheduler/schedule_one.go): the scheduler shields a nominated
        node's capacity from lower-priority pods, so the victims' re-created
        replacements cannot steal the very nodes the plan just drained for
        the gang. Best-effort — a lost write costs convergence speed, not
        correctness."""
        for key, node in gp.gang_moves:
            self._set_nomination(key, node)

    def _unnominate_gang(self, gp: GangDefragPlan) -> None:
        """A set aborted mid-drain (PDB said no): clear the reservations so
        a half-executed plan does not pin capacity for pods that will not
        get their consolidation this cycle."""
        for key, _node in gp.gang_moves:
            self._set_nomination(key, "")

    def _set_nomination(self, key: str, node: str) -> None:
        ns, _, name = key.partition("/")
        pods = self.client.pods(ns or "default")
        try:
            cur = pods.get(name)
        except ApiError:
            return
        if (cur.get("spec") or {}).get("nodeName"):
            return  # already bound: nomination is moot
        status = cur.setdefault("status", {})
        if status.get("nominatedNodeName", "") == node:
            return
        if node:
            status["nominatedNodeName"] = node
        else:
            status.pop("nominatedNodeName", None)
        try:
            pods.update_status(cur)
        except ApiError:
            pass  # raced an update: the next cycle re-proves and re-writes

    def _drained_nodes(self, touched: set[str]) -> set[str]:
        """Nodes the cycle's successful sets emptied (their victims were
        the node's last evictable residents — exempt daemon/mirror pods
        don't count). ONE unfiltered pod LIST after all evictions answers
        every touched node's membership question — a list per set (let
        alone per node) would re-scan the whole store once per set."""
        from kubernetes_tpu_torch.autoscaler.autoscaler import _daemon_or_mirror
        if not touched:
            return set()
        try:
            live = [p for p in self.client.resource("pods", None).list()
                    if not _terminal(p)]
        except ApiError:
            return set()
        still_busy = {(p.get("spec") or {}).get("nodeName")
                      for p in live if not _daemon_or_mirror(p)}
        return touched - still_busy

    # ---- one reconcile --------------------------------------------------

    def run_once(self, dry_run: bool = False) -> dict:
        with DESCHEDULER_LOOP_DURATION.time({"phase": "plan"}):
            plan, gang_plans = self.plan()
        summary = {
            "candidateSets": plan.batch_sets,
            "batchVictims": plan.batch_victims,
            "planned": [{"set": s.name, "strategy": s.strategy,
                         "evictions": len(s.victims),
                         "moves": s.moves} for s in plan.accepted],
            "blocked": dict(plan.blocked),
            "gangs": [{
                "gang": gp.gang,
                "fitsWithoutEvictions": gp.fits_without_evictions,
                "evictions": gp.evictions,
                "set": gp.accepted.name if gp.accepted else None,
                "blocked": dict(gp.blocked),
            } for gp in gang_plans],
            "dryRun": dry_run,
        }
        if not dry_run:
            with DESCHEDULER_LOOP_DURATION.time({"phase": "evict"}):
                summary.update(self._execute(plan, gang_plans))
        self._last["cycle"] = {
            "at": rfc3339_from_epoch(self.clock.now()),
            "evicted": len(summary.get("evicted", [])),
            "planned": sum(len(s.victims) for s in plan.accepted)
            + sum(gp.evictions for gp in gang_plans),
        }
        self._publish_status(summary)
        return summary

    # ---- status ----------------------------------------------------------

    def status(self) -> dict:
        return {
            "strategies": sorted(self.config.strategies),
            "gangDefrag": self.config.gang_defrag,
            "maxEvictionsPerCycle": self.config.max_evictions_per_cycle,
            "tenantDrainQuotas": dict(self.config.tenant_drain_quotas),
            "lastCycle": self._last["cycle"],
        }

    def _publish_status(self, summary: dict) -> None:
        # the shared upsert owns the create/update race + counted failure
        # handling (best-effort: publishing never takes the loop down)
        from kubernetes_tpu_torch.utils.configmap import upsert_configmap
        upsert_configmap(
            self.client, STATUS_NAMESPACE, STATUS_CONFIGMAP,
            {"status": json.dumps({**self.status(),
                                   "lastLoop": summary}, indent=1),
             "lastProbeTime": rfc3339_from_epoch(self.clock.now())},
            site="descheduler_publish")

    # ---- loop ------------------------------------------------------------

    def start(self, interval: Optional[float] = None) -> "Descheduler":
        from kubernetes_tpu_torch.sched.faults import loop_until_fatal
        period = self.config.interval_s if interval is None else interval
        self._thread = threading.Thread(
            target=loop_until_fatal,
            args=(self, period, "descheduler cycle", _LOG),
            daemon=True, name="descheduler")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
