"""ClusterAutoscaler — the scale-up/scale-down control loop.

Reference: ``cluster-autoscaler/core/static_autoscaler.go`` (RunOnce:
unschedulable pods -> ScaleUp via expander; low-utilization nodes ->
ScaleDown after a re-placement proof) with the simulation swapped for the
batched tensor path (autoscaler/simulator.py). Decisions publish to the
``cluster-autoscaler-status`` ConfigMap exactly like the reference, which
is what ``ktpu autoscale status`` reads.

The PyTorch port of ``kubernetes_tpu/autoscaler/autoscaler.py``: both
simulations run on ``device`` (None = the card) or, through ``resident``,
on the scheduler's resident context. The ConfigMap is the port's status
surface (``ktpu autoscale status``). ``run_once`` is driven by
``start``'s own loop, or by sched/bgplanner.BackgroundPlanner. Unlike the
reference's, the loop of ``start`` stops for good on a failure that
``sched/faults.is_fatal`` calls fatal (``loop_error`` keeps it), and logs
only other failures.
"""

from __future__ import annotations

import json
import logging
import threading
from typing import Optional

from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.autoscaler.expander import EXPANDERS
from kubernetes_tpu_torch.autoscaler.nodegroup import (
    NODE_GROUP_LABEL,
    NodeGroupProvider,
)
from kubernetes_tpu_torch.autoscaler.simulator import (
    simulate_scale_down,
    simulate_scale_up,
)
from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
from kubernetes_tpu_torch.metrics.registry import (
    AUTOSCALER_DECISIONS,
    AUTOSCALER_GROUP_SIZE,
    AUTOSCALER_LOOP_DURATION,
    AUTOSCALER_SCALED,
    AUTOSCALER_UNSCHEDULABLE,
)
from kubernetes_tpu_torch.utils.clock import REAL_CLOCK, rfc3339_from_epoch
from kubernetes_tpu_torch.utils.tracing import TRACER

_LOG = logging.getLogger(__name__)

STATUS_CONFIGMAP = "cluster-autoscaler-status"
STATUS_NAMESPACE = "default"
# the seed of the "random" expander's tie-break
EXPANDER_SEED = 0


def _terminal(pod: dict) -> bool:
    return (pod.get("status") or {}).get("phase") in ("Succeeded", "Failed")


def _daemon_or_mirror(pod: dict) -> bool:
    from kubernetes_tpu_torch.autoscaler.simulator import drain_exempt
    md = pod.get("metadata") or {}
    return drain_exempt(md.get("annotations") or {},
                        md.get("ownerReferences") or [])


class ClusterAutoscaler:
    def __init__(self, client, provider: NodeGroupProvider,
                 expander: str = "least-waste",
                 utilization_threshold: float = 0.5,
                 scale_down_unneeded_s: float = 0.0,
                 clock=None, resident=None, device=None):
        from kubernetes_tpu_torch.utils import sanity
        problems = sanity.check_node_groups(provider.groups())
        if problems:
            # fail at construction, not three loops into a scale-up
            raise ValueError("invalid node-group config: "
                             + "; ".join(problems))
        if expander not in EXPANDERS:
            raise ValueError(f"unknown expander {expander!r} "
                             f"(have {sorted(EXPANDERS)})")
        self.client = client
        self.provider = provider
        self.expander = expander
        self.utilization_threshold = utilization_threshold
        self.scale_down_unneeded_s = scale_down_unneeded_s
        self.clock = clock or REAL_CLOCK
        # resident fast path (encode/overlay.ResidentPlanner): when set,
        # both simulations ride the scheduler's device-resident encoding;
        # declines fall back to self.encoder cold
        self.resident = resident
        self.device = device
        self.encoder = SnapshotEncoder()  # persistent: stable intern ids
        self._cooldown_until: dict[str, float] = {}
        self._backoff_until: dict[str, float] = {}
        self._unneeded_since: dict[str, float] = {}
        self._last: dict = {"scaleUp": None, "scaleDown": None}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the fatal failure that stopped start()'s loop, else None
        self.loop_error: Optional[BaseException] = None

    # ---- observation ----------------------------------------------------

    def _observe(self) -> tuple[list[Node], list[Pod], list[dict]]:
        with TRACER.span("planner/observe", planner="autoscaler"):
            node_dicts = self.client.nodes().list()
            pod_dicts = [p for p in self.client.resource("pods", None).list()
                         if not _terminal(p)]
            nodes = [Node.from_dict(d) for d in node_dicts]
            pods = [Pod.from_dict(d) for d in pod_dicts]
        # re-adopt provisioned nodes by group label (restart resilience)
        for n in nodes:
            g = n.metadata.labels.get(NODE_GROUP_LABEL)
            if g and self.provider.group(g) is not None \
                    and self.provider.group_of(n.metadata.name) is None:
                self.provider.adopt(g, [n.metadata.name])
        return nodes, pods, pod_dicts

    # ---- one reconcile --------------------------------------------------

    def run_once(self) -> dict:
        """One RunOnce: scale-up for the unschedulable set, then scale-down
        over under-utilized managed nodes. Returns a decision summary."""
        nodes, pods, pod_dicts = self._observe()
        bound = [p for p in pods if p.spec.node_name]
        pending = [p for p in pods if not p.spec.node_name]
        AUTOSCALER_UNSCHEDULABLE.set(len(pending))
        summary = {"pending": len(pending), "scaled_up": [],
                   "scaled_down": [], "blocked": {}}
        with AUTOSCALER_LOOP_DURATION.time({"phase": "scaleUp"}):
            if pending:
                summary["scaled_up"] = self._scale_up(nodes, bound, pending)
        with AUTOSCALER_LOOP_DURATION.time({"phase": "scaleDown"}):
            down, blocked = self._scale_down(nodes, bound, pod_dicts,
                                             busy=bool(pending))
            summary["scaled_down"] = down
            summary["blocked"] = blocked
        if not summary["scaled_up"] and not summary["scaled_down"]:
            AUTOSCALER_DECISIONS.inc({"action": "noop"})
        for g in self.provider.groups():
            AUTOSCALER_GROUP_SIZE.set(self.provider.target_size(g.name),
                                      {"group": g.name})
        self._publish_status(summary)
        return summary

    # ---- scale-up -------------------------------------------------------

    def _scale_up(self, nodes, bound, pending) -> list[str]:
        now = self.clock.now()
        eligible, headroom = [], {}
        for g in self.provider.groups():
            if now < self._backoff_until.get(g.name, 0.0):
                continue
            if now < self._cooldown_until.get(g.name, 0.0):
                continue
            room = g.max_size - self.provider.target_size(g.name)
            if room > 0:
                eligible.append(g)
                headroom[g.name] = room
        if not eligible:
            return []
        options = simulate_scale_up(nodes, bound, pending, eligible,
                                    headroom=headroom, encoder=self.encoder,
                                    resident=self.resident,
                                    device=self.device)
        choice = EXPANDERS[self.expander](options, seed=EXPANDER_SEED)
        if choice is None:
            return []
        group = choice.group
        try:
            names = self.provider.scale_up(group.name, choice.nodes_needed)
        except Exception:
            _LOG.exception("scale-up of group %s failed; backing off",
                           group.name)
            self._backoff_until[group.name] = now + group.backoff_s
            AUTOSCALER_DECISIONS.inc({"action": "backoff"})
            return []
        if names:
            self._cooldown_until[group.name] = now + group.cooldown_s
            AUTOSCALER_DECISIONS.inc({"action": "scaleUp"})
            AUTOSCALER_SCALED.inc({"direction": "up", "group": group.name},
                                  by=len(names))
            self._last["scaleUp"] = {
                "group": group.name, "nodes": names,
                "pods": choice.pods_placed, "at": rfc3339_from_epoch(now)}
            _LOG.info("scaled up %s by %d (%s) for %d pending pods",
                      group.name, len(names), ",".join(names),
                      choice.pods_placed)
        return names

    # ---- scale-down -----------------------------------------------------

    def _scale_down(self, nodes, bound, pod_dicts,
                    busy: bool) -> tuple[list[str], dict]:
        """Reclaim provably-drainable managed nodes. ``busy`` (pending pods
        exist) suppresses reclaim entirely — capacity wanted upstream must
        not be torn down below."""
        if busy:
            self._unneeded_since.clear()
            return [], {}
        now = self.clock.now()
        candidates = []
        for n in nodes:
            g = self.provider.group_of(n.metadata.name)
            if g is None or n.spec.unschedulable:
                continue
            if self.provider.target_size(g) <= self.provider.group(g).min_size:
                continue
            candidates.append(n.metadata.name)
        if not candidates:
            self._unneeded_since.clear()
            return [], {}
        pdbs = self._list_pdbs()
        plan = simulate_scale_down(
            nodes, bound, candidates,
            utilization_threshold=self.utilization_threshold,
            pdbs=pdbs, all_pod_dicts=pod_dicts, encoder=self.encoder,
            resident=self.resident, device=self.device)
        # unneeded-window gate (scale-down-unneeded-time): a node must stay
        # provably removable for the whole window before reclaim
        removable = []
        for c in plan.removable:
            since = self._unneeded_since.setdefault(c, now)
            if now - since >= self.scale_down_unneeded_s:
                removable.append(c)
        for c in list(self._unneeded_since):
            if c not in plan.removable:
                del self._unneeded_since[c]
        reclaimed = []
        for c in removable:
            g = self.provider.group_of(c)
            # live re-check: target_size drops as this loop reclaims
            if self.provider.target_size(g) <= self.provider.group(g).min_size:
                plan.blocked[c] = "at group min size"
                continue
            if self._reclaim(c, g):
                reclaimed.append(c)
                self._unneeded_since.pop(c, None)
                AUTOSCALER_DECISIONS.inc({"action": "scaleDown"})
                AUTOSCALER_SCALED.inc({"direction": "down", "group": g})
                self._last["scaleDown"] = {
                    "group": g, "node": c, "at": rfc3339_from_epoch(now)}
        return reclaimed, dict(plan.blocked)

    def note_drained(self, node_names: list[str]) -> None:
        """Descheduler handoff: a defrag cycle fully drained these nodes,
        so start their scale-down-unneeded window NOW instead of at this
        loop's next observation — consolidation and reclaim compose into
        one convergence step instead of two full loop periods."""
        now = self.clock.now()
        for n in node_names:
            self._unneeded_since.setdefault(n, now)

    def _list_pdbs(self) -> list[dict]:
        from kubernetes_tpu_torch.api.policy import list_pdbs
        return list_pdbs(self.client)

    def _reclaim(self, node_name: str, group_name: str) -> bool:
        """Cordon -> drain (Eviction API, PDB-honoring) -> delete. A 429
        mid-drain uncordons and aborts: the budget said no."""
        if not self._set_unschedulable(node_name, True):
            return False
        residents = [p for p in self.client.resource("pods", None).list(
            field_selector=f"spec.nodeName={node_name}")
            if not _terminal(p) and not _daemon_or_mirror(p)]
        for p in residents:
            md = p["metadata"]
            try:
                self.client.pods(md.get("namespace", "default")).evict(
                    md["name"])
            except ApiError as e:
                if e.code == 404:
                    continue
                _LOG.warning("eviction of %s/%s refused (%s); aborting "
                             "scale-down of %s", md.get("namespace"),
                             md["name"], e.code, node_name)
                self._set_unschedulable(node_name, False)
                return False
        try:
            self.provider.scale_down(group_name, [node_name])
        except Exception:
            _LOG.exception("deprovision of %s failed", node_name)
            self._set_unschedulable(node_name, False)
            return False
        return True

    def _set_unschedulable(self, name: str, flag: bool) -> bool:
        try:
            node = self.client.nodes().get(name)
            node.setdefault("spec", {})["unschedulable"] = flag
            self.client.nodes().update(node)
            return True
        except ApiError:
            return False

    # ---- status ----------------------------------------------------------

    def status(self) -> dict:
        now = self.clock.now()
        return {
            "expander": self.expander,
            "groups": {
                g.name: {
                    "size": self.provider.target_size(g.name),
                    "minSize": g.min_size, "maxSize": g.max_size,
                    "cooldown": now < self._cooldown_until.get(g.name, 0.0),
                    "backoff": now < self._backoff_until.get(g.name, 0.0),
                } for g in self.provider.groups()},
            "lastScaleUp": self._last["scaleUp"],
            "lastScaleDown": self._last["scaleDown"],
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
            site="autoscaler_publish")

    # ---- loop ------------------------------------------------------------

    def start(self, interval: float = 2.0) -> "ClusterAutoscaler":
        from kubernetes_tpu_torch.sched.faults import loop_until_fatal
        self._thread = threading.Thread(
            target=loop_until_fatal,
            args=(self, interval, "autoscaler loop iteration", _LOG),
            daemon=True, name="cluster-autoscaler")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
