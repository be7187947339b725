"""Multi-version API machinery — the runtime.Scheme analog.

Reference: ``staging/src/k8s.io/apimachinery/pkg/runtime/scheme.go``: every
kind converts through a HUB version (upstream's __internal); each served
version registers to_hub/from_hub functions, and the apiserver converts
request bodies in and response objects out, so one stored shape serves many
wire shapes. CRDs get the same via their conversion webhooks — here the
scheme is the single registry for both.

Built-in registration mirrors the reference's best-known conversion pair:
``autoscaling/v1`` HorizontalPodAutoscaler (targetCPUUtilizationPercentage)
<-> the stored ``autoscaling/v2`` shape (metrics list) —
``pkg/apis/autoscaling/v1/conversion.go``.
"""

from __future__ import annotations

from typing import Callable, Optional


class Scheme:
    """(kind, version) -> (to_hub, from_hub). The hub version needs no
    registration: it is what the store holds."""

    def __init__(self):
        self._conv: dict[tuple[str, str], tuple[Callable, Callable]] = {}
        self._hub: dict[str, str] = {}

    def register(self, kind: str, version: str, to_hub: Callable,
                 from_hub: Callable, hub_version: str = "v1") -> None:
        self._conv[(kind, version)] = (to_hub, from_hub)
        self._hub[kind] = hub_version

    def converter(self, kind: str, version: str
                  ) -> Optional[tuple[Callable, Callable]]:
        return self._conv.get((kind, version))

    def served_versions(self, kind: str) -> list[str]:
        out = [self._hub.get(kind, "v1")]
        out += [v for (k, v) in self._conv if k == kind]
        return out


# --------------------------------------------- autoscaling/v1 <-> v2 (hub)

# non-cpu metrics ride this annotation through the lossy v1 view, exactly
# like upstream's conversion (pkg/apis/autoscaling/v1/conversion.go) — a
# v1 read-modify-write must not silently delete a v2 memory metric
METRICS_ANNOTATION = "autoscaling.alpha.kubernetes.io/metrics"


def _hpa_v1_to_v2(obj: dict) -> dict:
    """autoscaling/v1 wire shape -> the stored v2 shape: the single
    targetCPUUtilizationPercentage becomes a cpu Utilization metric, and
    metrics preserved through the round-trip annotation are restored."""
    import json as _json
    out = dict(obj)
    spec = dict(out.get("spec") or {})
    pct = spec.pop("targetCPUUtilizationPercentage", None)
    metrics = list(spec.get("metrics") or [])
    md = dict(out.get("metadata") or {})
    ann = dict(md.get("annotations") or {})
    stashed = ann.pop(METRICS_ANNOTATION, None)
    if stashed:
        try:
            metrics += [m for m in _json.loads(stashed)
                        if isinstance(m, dict)]
        except ValueError:
            pass
        md["annotations"] = ann
        if not ann:
            md.pop("annotations", None)
        out["metadata"] = md
    if pct is not None:
        metrics.insert(0, {
            "type": "Resource",
            "resource": {"name": "cpu",
                         "target": {"type": "Utilization",
                                    "averageUtilization": pct}},
        })
    if metrics:
        spec["metrics"] = metrics
    out["spec"] = spec
    out["apiVersion"] = "autoscaling/v2"
    if "status" in out:
        status = dict(out["status"])
        pct_s = status.pop("currentCPUUtilizationPercentage", None)
        if pct_s is not None and not status.get("currentMetrics"):
            status["currentMetrics"] = [{
                "type": "Resource",
                "resource": {"name": "cpu",
                             "current": {"averageUtilization": pct_s}},
            }]
        # installed unconditionally: the v1-only scalar must never reach
        # the stored hub shape
        out["status"] = status
    return out


def _hpa_v2_to_v1(obj: dict) -> dict:
    """Stored v2 -> the v1 wire shape; the cpu Utilization metric narrows
    to targetCPUUtilizationPercentage, every OTHER metric is stashed in the
    round-trip annotation so a v1 PUT of this object can't destroy it."""
    import json as _json
    out = dict(obj)
    spec = dict(out.get("spec") or {})
    metrics = spec.pop("metrics", None) or []
    others = []
    cpu_seen = False
    for m in metrics:
        res = m.get("resource") or {}
        if (not cpu_seen and m.get("type") == "Resource"
                and res.get("name") == "cpu"):
            cpu_seen = True
            pct = (res.get("target") or {}).get("averageUtilization")
            if pct is not None:
                spec["targetCPUUtilizationPercentage"] = pct
                continue
        others.append(m)
    if others:
        md = dict(out.get("metadata") or {})
        ann = dict(md.get("annotations") or {})
        ann[METRICS_ANNOTATION] = _json.dumps(others)
        md["annotations"] = ann
        out["metadata"] = md
    out["spec"] = spec
    out["apiVersion"] = "autoscaling/v1"
    if "status" in out:
        status = dict(out["status"])
        for m in status.pop("currentMetrics", None) or []:
            res = m.get("resource") or {}
            if m.get("type") == "Resource" and res.get("name") == "cpu":
                pct = (res.get("current") or {}).get("averageUtilization")
                if pct is not None:
                    status["currentCPUUtilizationPercentage"] = pct
                break
        # the narrowed status is installed even when no cpu metric exists:
        # currentMetrics is a v2-only field and must never leak into v1
        out["status"] = status
    return out


def default_scheme() -> Scheme:
    s = Scheme()
    s.register("HorizontalPodAutoscaler", "v1",
               to_hub=_hpa_v1_to_v2, from_hub=_hpa_v2_to_v1,
               hub_version="v2")
    return s
