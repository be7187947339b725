"""Node lifecycle controller — taint unhealthy nodes, evict their pods.

Reference: ``pkg/controller/nodelifecycle/node_lifecycle_controller.go``
(monitorNodeHealth: Ready condition staleness -> NoExecute ``not-ready`` /
``unreachable`` taints) and the NoExecute taint-manager eviction path
(``tainteviction/``: pods without a matching toleration are evicted after
tolerationSeconds).

Disruption modes (upstream handleDisruption): when the unready fraction
crosses ``unhealthyZoneThreshold`` (default 0.55) the controller stops
trusting its own staleness signal — mass unreadiness is far more likely
an apiserver/network outage than half the fleet dying at once, and the
worst possible response is a fleet-wide taint/evict storm the moment the
control plane comes back:

  Normal             taint + evict as usual (unthrottled)
  PartialDisruption  fraction >= threshold; small clusters
                     (< largeClusterSizeThreshold) halt evictions, large
                     ones add NoExecute taints at the reduced secondary
                     rate (upstream secondary-node-eviction-rate)
  FullDisruption     EVERY node unready: taints removed + evictions
                     halted entirely (upstream markNodeAsReachable on
                     entering full disruption)

Clusters smaller than ``min_disruption_nodes`` (default 3) never enter a
disruption mode — "mass-unready protection" needs a mass, and a one-node
cluster's single NotReady node is its own ground truth. The mode is a
gauge (``nodelifecycle_disruption_mode``), a status ConfigMap (the
``ktpu status`` Disruption line), and the DisasterChurn bench gate.
"""

from __future__ import annotations

import json
import logging
import threading
import time

from kubernetes_tpu_torch.api.types import Pod, Taint
from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.controllers.base import Controller, split_key
from kubernetes_tpu_torch.metrics.registry import (
    DISRUPTION_MODE,
    NODELIFE_DEFERRED,
    NODELIFE_EVICTIONS,
)

_LOG = logging.getLogger("kubernetes_tpu_torch.controllers.nodelifecycle")

TAINT_NOT_READY = "node.kubernetes.io/not-ready"
TAINT_UNREACHABLE = "node.kubernetes.io/unreachable"

DEFAULT_GRACE = 40.0  # nodeMonitorGracePeriod default 40s

MODE_NORMAL = "Normal"
MODE_PARTIAL = "PartialDisruption"
MODE_FULL = "FullDisruption"
_MODE_GAUGE = {MODE_NORMAL: 0, MODE_PARTIAL: 1, MODE_FULL: 2}

# ``ktpu status`` reads the Disruption line from this ConfigMap
NODELIFECYCLE_CONFIGMAP = "kubernetes-tpu-nodelifecycle-status"


def _ready_condition(node: dict):
    for c in (node.get("status") or {}).get("conditions") or []:
        if c.get("type") == "Ready":
            return c
    return None


class NodeLifecycleController(Controller):
    """Sync per node: reconcile health taints; evict intolerant pods on
    NoExecute-tainted nodes. A monitor thread recomputes the disruption
    mode and re-enqueues all nodes every ``monitor_period`` so staleness
    is noticed without events."""

    name = "nodelifecycle"

    def __init__(self, client, grace_period: float = DEFAULT_GRACE,
                 monitor_period: float = 5.0,
                 unhealthy_zone_threshold: float = 0.55,
                 large_cluster_threshold: int = 50,
                 secondary_eviction_rate_qps: float = 0.01,
                 min_disruption_nodes: int = 3,
                 status_namespace: str = "default"):
        super().__init__(client)
        self.grace_period = grace_period
        self.monitor_period = monitor_period
        self.unhealthy_zone_threshold = unhealthy_zone_threshold
        self.large_cluster_threshold = large_cluster_threshold
        self.secondary_eviction_rate_qps = secondary_eviction_rate_qps
        self.min_disruption_nodes = min_disruption_nodes
        self.status_namespace = status_namespace
        self._monitor: threading.Thread | None = None
        # disruption-mode state (written by the monitor thread, read by
        # sync workers; plain attribute reads — GIL-atomic)
        self.mode = MODE_NORMAL
        self.unready_fraction = 0.0
        self.cluster_size = 0
        self.engaged_count = 0  # times the mode left Normal
        self.transitions: list[dict] = []
        # taint/evict accounting (the DisasterChurn bench gates on these)
        self.evictions = 0
        self.evictions_deferred = 0
        self.taints_suppressed = 0
        # secondary-rate token bucket (PartialDisruption, large clusters)
        self._tokens = 1.0
        self._tokens_ts = time.monotonic()
        self._token_lock = threading.Lock()
        self._sweeps_since_publish = 0
        # fresh-grace shield: set when a disruption RELEASES *or* when
        # this controller's own informers heal a SIGNIFICANT watch gap
        # (>= min_shield_gap_s — the controller itself lived through a
        # connectivity loss, e.g. an apiserver restart). Staleness
        # accrued across either window is not evidence — without the
        # gap-heal trigger, a SHORT outage (< grace) lets nodes cross
        # grace staggered AFTER the heal and the first crossers are
        # tainted/evicted before the unready fraction can trip the
        # disruption threshold. Unreachable taints are suppressed until
        # a FULL grace window has re-elapsed (0 = no shield; upstream's
        # analog is the fresh probeTimestamp every node gets when the
        # controller restarts).
        self._normal_since = 0.0
        self._seen_gap_ends: dict[str, float] = {}

    def register(self, factory: InformerFactory) -> None:
        self.lease_informer = factory.informer("leases", None)
        self.node_informer = factory.informer("nodes", None)
        self.node_informer.add_event_handler(self.handler())
        self.pod_informer = factory.informer("pods", None)

    def start(self):
        super().start()
        self._monitor = threading.Thread(target=self._monitor_loop, daemon=True)
        self._monitor.start()
        return self

    def _monitor_loop(self):
        while not self._stop.wait(self.monitor_period):
            # mode FIRST: by the time a sync worker pops a key, the sweep
            # that enqueued it has already judged whether this is an
            # outage — a mass-unready sweep must never race its own keys
            # into un-protected syncs
            try:
                self._update_disruption_mode()
            except Exception:
                _LOG.exception("disruption-mode sweep failed")
            for key in self.node_informer.store.keys():
                self.queue.add(key)

    # ---- disruption modes (handleDisruption) ----------------------------

    # gaps shorter than this never grant the fleet-wide shield: a routine
    # TooOld relist under churn heals sub-second, and refreshing the
    # shield on every one would suppress dead-node detection forever
    min_shield_gap_s = 1.0

    def _observe_gap_heals(self) -> None:
        """Grant the fresh-grace shield when an informer heals a
        SIGNIFICANT watch gap (an apiserver outage, not watch-window
        churn): staleness bookkeeping that spans the gap is not
        evidence."""
        for attr in ("node_informer", "lease_informer"):
            inf = getattr(self, attr, None)
            if inf is None:
                continue
            end = inf.last_gap_end
            if end is None or end == self._seen_gap_ends.get(attr):
                continue
            self._seen_gap_ends[attr] = end
            if inf.last_gap_duration >= self.min_shield_gap_s:
                _LOG.warning(
                    "%s healed a %.1fs watch gap (control-plane outage):"
                    " granting the fleet a fresh %.0fs grace window",
                    attr, inf.last_gap_duration, self.grace_period)
                self._normal_since = max(self._normal_since, end)

    def _update_disruption_mode(self) -> None:
        self._observe_gap_heals()
        nodes = self.node_informer.store.list()
        total = len(nodes)
        self.cluster_size = total
        if total >= max(1, self.min_disruption_nodes):
            unready = sum(1 for n in nodes
                          if self._wanted_taint(n) is not None)
            frac = unready / total
        else:
            frac = 0.0  # too small to distinguish outage from dead nodes
        self.unready_fraction = frac
        if frac >= 1.0:
            mode = MODE_FULL
        elif frac >= self.unhealthy_zone_threshold:
            mode = MODE_PARTIAL
        else:
            mode = MODE_NORMAL
        changed = mode != self.mode
        if changed:
            _LOG.warning(
                "disruption mode %s -> %s (%d/%d nodes unready)",
                self.mode, mode, int(round(frac * total)), total)
            if self.mode == MODE_NORMAL:
                self.engaged_count += 1
            elif mode == MODE_NORMAL:
                # release: the laggards whose lease renewals haven't
                # landed yet are stale from the SAME outage that engaged
                # the mode — they must re-accrue a full grace window
                # before "unreachable" means anything again, or the
                # release itself taints/evicts half the fleet
                self._normal_since = time.time()
            self.mode = mode
            self.transitions.append(
                {"mode": mode, "at": time.time(),
                 "unreadyFraction": round(frac, 3), "nodes": total})
            del self.transitions[:-20]
            DISRUPTION_MODE.set(_MODE_GAUGE[mode])
        self._sweeps_since_publish += 1
        if changed or self._sweeps_since_publish >= 10:
            self._sweeps_since_publish = 0
            self.publish_status()

    def _evictions_halted(self) -> bool:
        return (self.mode == MODE_FULL
                or (self.mode == MODE_PARTIAL
                    and self.cluster_size < self.large_cluster_threshold))

    def _staleness_distrusted(self) -> bool:
        """True while staleness must not drive new unreachable taints: a
        watch gap is OPEN on the informers this controller judges from
        (their caches are aging untracked — the apiserver may be down or
        freshly restarted), or a gap/disruption healed less than one full
        grace period ago (the laggards' staleness is gap-era evidence)."""
        for inf in (getattr(self, "node_informer", None),
                    getattr(self, "lease_informer", None)):
            if inf is not None and inf.gap_since:
                return True
        return bool(self._normal_since
                    and time.time() - self._normal_since
                    < self.grace_period)

    def _take_eviction_token(self) -> bool:
        """Secondary-rate token bucket (PartialDisruption, large cluster):
        one NEW taint per 1/secondary_rate seconds across the fleet."""
        with self._token_lock:
            now = time.monotonic()
            self._tokens = min(
                1.0, self._tokens + (now - self._tokens_ts)
                * self.secondary_eviction_rate_qps)
            self._tokens_ts = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    def disruption_status(self) -> dict:
        return {
            "mode": self.mode,
            "unreadyFraction": round(self.unready_fraction, 3),
            "nodes": self.cluster_size,
            "evictionsHalted": self._evictions_halted(),
            "unhealthyZoneThreshold": self.unhealthy_zone_threshold,
            "largeClusterThreshold": self.large_cluster_threshold,
            "engagedCount": self.engaged_count,
            "evictions": self.evictions,
            "evictionsDeferred": self.evictions_deferred,
            "taintsSuppressed": self.taints_suppressed,
            "stalenessDistrusted": self._staleness_distrusted(),
            "transitions": self.transitions[-5:],
        }

    def publish_status(self) -> None:
        """Best-effort ConfigMap for ``ktpu status``; during the very
        outage this mode protects against, the write itself fails — it
        re-asserts on the first post-heal sweep."""
        from kubernetes_tpu_torch.utils.configmap import upsert_configmap
        upsert_configmap(
            self.client, self.status_namespace, NODELIFECYCLE_CONFIGMAP,
            {"disruption": json.dumps(self.disruption_status())},
            site="nodelifecycle_publish")

    # ---- monitorNodeHealth ----------------------------------------------

    def _lease_renew_time(self, node_name: str):
        """renewTime of the node's kube-node-lease Lease, if any — lease
        renewal counts as a heartbeat (monitorNodeHealth's probeTimestamp
        advances on lease updates; upstream kubelets renew every 10s while
        touching node STATUS only 5-minutely)."""
        inf = getattr(self, "lease_informer", None)
        if inf is None:
            return None
        lease = inf.store.get(f"kube-node-lease/{node_name}")
        if lease is None:
            return None
        rt = (lease.get("spec") or {}).get("renewTime")
        try:
            return float(rt)
        except (TypeError, ValueError):
            return None

    def _wanted_taint(self, node: dict) -> str | None:
        cond = _ready_condition(node)
        if cond is None:
            return None  # no kubelet heartbeat model yet — leave untouched
        if cond.get("status") == "False":
            return TAINT_NOT_READY
        hb = cond.get("lastHeartbeatTime")
        renew = self._lease_renew_time(
            (node.get("metadata") or {}).get("name", ""))
        candidates = [renew]
        if hb is not None:
            candidates.append(float(hb))
        latest = max([t for t in candidates if t is not None],
                     default=None)
        if latest is not None and time.time() - latest > self.grace_period:
            return TAINT_UNREACHABLE
        if cond.get("status") == "Unknown" and renew is None:
            return TAINT_UNREACHABLE
        return None

    def sync(self, key: str) -> None:
        _, name = split_key(key)
        node = self.node_informer.store.get(key) or self.node_informer.store.get(name)
        if node is None:
            return
        wanted = self._wanted_taint(node)
        taints = [t for t in (node.get("spec") or {}).get("taints") or []]
        ours = [t for t in taints
                if t.get("key") in (TAINT_NOT_READY, TAINT_UNREACHABLE)
                and t.get("effect") == "NoExecute"]
        rest = [t for t in taints if t not in ours]
        evict_allowed = True
        if (wanted == TAINT_UNREACHABLE
                and self._staleness_distrusted()
                and not (ours and ours[0].get("key") == wanted)):
            # the staleness evidence spans a connectivity gap (open watch
            # gap, or inside the fresh-grace window after one healed):
            # suppress — an explicit Ready=False still taints, and the
            # disruption-mode FRACTION still counts raw staleness so
            # mass-unready protection engages regardless
            self.taints_suppressed += 1
            return
        if wanted:
            mode = self.mode
            already = bool(ours) and ours[0].get("key") == wanted
            if mode == MODE_FULL:
                # upstream markNodeAsReachable on entering full disruption:
                # the staleness signal itself is distrusted — drop OUR
                # taints and add none, so an apiserver outage leaves zero
                # taint/evict residue to storm through on reconnect
                self.taints_suppressed += 1
                wanted, evict_allowed = None, False
            elif mode == MODE_PARTIAL:
                if self._evictions_halted():
                    # small cluster: halt (upstream setLimiterInZone(0)) —
                    # existing taints stay, nothing new, no evictions
                    evict_allowed = False
                    if not already:
                        self.taints_suppressed += 1
                        return
                elif not already:
                    # large cluster: new taints trickle at the secondary
                    # eviction rate; deferred nodes retry next sweep
                    if not self._take_eviction_token():
                        self.evictions_deferred += 1
                        NODELIFE_DEFERRED.inc()
                        return
        added_ts = None
        if wanted:
            # Carry the existing timestamp if the same taint is already
            # present; otherwise this sync IS the add — the informer copy is
            # stale on this very sync, so the eviction check below must use
            # this value, not whatever the node object says.
            added_ts = (float(ours[0].get("timeAdded", time.time()))
                        if ours and ours[0].get("key") == wanted
                        else time.time())
        new_taints = rest + ([{"key": wanted, "effect": "NoExecute",
                               "timeAdded": added_ts}] if wanted else [])
        if new_taints != taints:
            obj = {**node, "spec": {**(node.get("spec") or {}), "taints": new_taints}}
            try:
                self.client.nodes().update(obj)
            except ApiError as e:
                if e.code not in (404, 409):
                    raise
        if wanted and evict_allowed:
            self._evict_intolerant(node, wanted, added_ts)

    # ---- NoExecute taint eviction ---------------------------------------

    def _evict_intolerant(self, node: dict, taint_key: str,
                          added: float) -> None:
        node_name = (node.get("metadata") or {}).get("name", "")
        taint_obj = Taint(key=taint_key, effect="NoExecute")
        for p in self.pod_informer.store.list():
            if (p.get("spec") or {}).get("nodeName") != node_name:
                continue
            if (p.get("status") or {}).get("phase") in ("Succeeded", "Failed"):
                continue
            pod = Pod.from_dict(p)
            matching = [t for t in pod.spec.tolerations if t.tolerates(taint_obj)]
            if matching:
                secs = [t.toleration_seconds for t in matching]
                if any(s is None for s in secs):
                    continue  # tolerates forever
                if time.time() - added < min(s for s in secs if s is not None):
                    continue  # still within tolerationSeconds
            try:
                self.client.pods(pod.metadata.namespace).evict(pod.metadata.name)
            except ApiError as e:
                if e.code != 404:
                    raise
            else:
                self.evictions += 1
                NODELIFE_EVICTIONS.inc()
