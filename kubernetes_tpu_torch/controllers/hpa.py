"""Horizontal Pod Autoscaler controller (autoscaling/v2, Resource metrics).

Reference: ``pkg/controller/podautoscaler/horizontal.go``
(``reconcileAutoscaler`` + ``computeReplicasForMetrics``): desired =
ceil(current * actualUtilization / targetUtilization), clamped to
[minReplicas, maxReplicas], with a scale-down stabilization window.

Metrics source: upstream reads the metrics API (metrics-server). Here the
equivalent surface is a pluggable ``metrics_fn(pod_dict) -> used millicores``
defaulting to the ``kubernetes-tpu.io/cpu-usage`` pod annotation, which the
hollow kubelet (or a test) publishes — the shape of the data matches
``PodMetrics.containers[].usage.cpu``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

from kubernetes_tpu_torch.api.resource import canonical
from kubernetes_tpu_torch.api.selectors import label_selector_matches
from kubernetes_tpu_torch.api.types import LabelSelector
from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.controllers.base import Controller, active_pods, split_key
from kubernetes_tpu_torch.utils.clock import REAL_CLOCK

USAGE_ANNOTATION = "kubernetes-tpu.io/cpu-usage"
TOLERANCE = 0.1  # upstream defaultTestingTolerance: skip scaling within 10%


def annotation_metrics(pod: dict) -> Optional[int]:
    """Used cpu millicores from the usage annotation (None = no sample)."""
    v = ((pod.get("metadata") or {}).get("annotations") or {}).get(
        USAGE_ANNOTATION)
    if v is None:
        return None
    return canonical("cpu", str(v))


class HorizontalPodAutoscalerController(Controller):
    name = "horizontalpodautoscaler"
    tick_interval = 2.0  # upstream --horizontal-pod-autoscaler-sync-period 15s

    def __init__(self, client, metrics_fn: Callable = annotation_metrics,
                 downscale_stabilization_s: float = 30.0, clock=None):
        super().__init__(client)
        self.metrics_fn = metrics_fn
        self.downscale_stabilization_s = downscale_stabilization_s
        # injectable clock (utils/clock.py): HPA-vs-autoscaler interplay
        # tests advance the stabilization window instead of sleeping it out
        self.clock = clock or REAL_CLOCK
        # key -> [(ts, recommended replicas)]; scale-down takes the max over
        # the stabilization window (upstream stabilizeRecommendation).
        self._recommendations: dict[str, list[tuple[float, int]]] = {}

    def register(self, factory: InformerFactory) -> None:
        self.hpa_informer = factory.informer("horizontalpodautoscalers", None)
        self.hpa_informer.add_event_handler(self.handler())
        self.deploy_informer = factory.informer("deployments", None)
        self.pod_informer = factory.informer("pods", None)

    def tick(self) -> None:
        for hpa in self.hpa_informer.store.list():
            self.enqueue(hpa)

    # -- metric evaluation -------------------------------------------------

    def _target_utilization(self, hpa: dict) -> Optional[int]:
        for m in (hpa.get("spec") or {}).get("metrics") or []:
            if m.get("type") != "Resource":
                continue
            res = m.get("resource") or {}
            if res.get("name") != "cpu":
                continue
            return (res.get("target") or {}).get("averageUtilization")
        return None

    def _pod_utilization(self, pod: dict) -> Optional[float]:
        used = self.metrics_fn(pod)
        if used is None:
            return None
        requested = 0
        for c in (pod.get("spec") or {}).get("containers") or []:
            r = ((c.get("resources") or {}).get("requests") or {}).get("cpu")
            if r:
                requested += canonical("cpu", str(r))
        if not requested:
            return None
        return 100.0 * used / requested

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        hpa = self.hpa_informer.store.get(key)
        if hpa is None:
            self._recommendations.pop(key, None)
            return
        spec = hpa.get("spec") or {}
        ref = spec.get("scaleTargetRef") or {}
        if ref.get("kind") != "Deployment":
            return  # only Deployments are scalable here
        dkey = f"{ns}/{ref.get('name', '')}"
        deploy = self.deploy_informer.store.get(dkey)
        if deploy is None:
            return
        target = self._target_utilization(hpa)
        if target is None:
            return
        dspec = deploy.get("spec") or {}
        current = int(dspec.get("replicas", 1))
        sel = LabelSelector.from_dict(dspec.get("selector"))
        pods = [p for p in active_pods(self.pod_informer.store.list())
                if (p.get("metadata") or {}).get("namespace", "") == ns
                and label_selector_matches(
                    sel, (p.get("metadata") or {}).get("labels") or {})]
        samples = [u for u in (self._pod_utilization(p) for p in pods)
                   if u is not None]
        if not samples:
            self._update_status(ns, hpa, current, current, None)
            return
        avg = sum(samples) / len(samples)
        ratio = avg / float(target)
        desired = current if abs(ratio - 1.0) <= TOLERANCE \
            else math.ceil(current * ratio)
        lo = int(spec.get("minReplicas", 1))
        hi = int(spec.get("maxReplicas", max(current, 1)))
        desired = max(lo, min(hi, desired))
        # Scale-down stabilization: the effective recommendation is the max
        # over the window, seeded with the replica count first observed, so a
        # dip must persist for the whole window before replicas drop.
        now = self.clock.now()
        recs = self._recommendations.setdefault(key, [(now, current)])
        recs.append((now, desired))
        cutoff = now - self.downscale_stabilization_s
        recs[:] = [(t, d) for t, d in recs if t >= cutoff]
        stabilized = max(d for _, d in recs)
        if stabilized > desired:
            desired = min(stabilized, current)
        if desired != current:
            patched = dict(deploy)
            patched["spec"] = {**dspec, "replicas": desired}
            try:
                self.client.resource("deployments", ns).update(patched)
            except ApiError as e:
                if e.code not in (404, 409):
                    raise
                return
        self._update_status(ns, hpa, current, desired, avg)

    def _update_status(self, ns, hpa, current, desired, avg):
        status = {"currentReplicas": current, "desiredReplicas": desired}
        if avg is not None:
            status["currentCPUUtilizationPercentage"] = round(avg, 1)
        if status == (hpa.get("status") or {}):
            return
        out = dict(hpa)
        out["status"] = status
        try:
            self.client.resource("horizontalpodautoscalers", ns) \
                .update_status(out)
        except ApiError as e:
            if e.code not in (404, 409):
                raise
