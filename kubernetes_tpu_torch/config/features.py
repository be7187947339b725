"""Feature gates — component-base/featuregate analog.

Reference: ``staging/src/k8s.io/component-base/featuregate/feature_gate.go``
+ ``pkg/features/kube_features.go``. Stages: ALPHA (default off), BETA
(default on), GA (locked on).
"""

from __future__ import annotations

import threading

ALPHA, BETA, GA = "ALPHA", "BETA", "GA"

_DEFAULTS = {
    # gate name: (stage, default)
    "TPUBatchScheduling": (BETA, True),     # the gang batcher (off -> serial mode)
    "TPURelationalPlugins": (BETA, True),   # spread/interpod on device
    "SchedulingGates": (GA, True),
    "PodTopologySpread": (GA, True),
    "MatchLabelKeysInPodTopologySpread": (ALPHA, False),
    "PreemptionSimulation": (BETA, True),
    "IncrementalSnapshots": (BETA, True),
}


class FeatureGate:
    def __init__(self, defaults=None):
        self._lock = threading.Lock()
        self._known = dict(defaults or _DEFAULTS)
        self._overrides: dict[str, bool] = {}

    def enabled(self, name: str) -> bool:
        with self._lock:
            if name in self._overrides:
                return self._overrides[name]
            if name not in self._known:
                raise KeyError(f"unknown feature gate {name!r}")
            return self._known[name][1]

    def set(self, name: str, value: bool):
        with self._lock:
            if name not in self._known:
                raise KeyError(f"unknown feature gate {name!r}")
            stage, _ = self._known[name]
            if stage == GA and not value:
                raise ValueError(f"cannot disable GA feature {name!r}")
            self._overrides[name] = value

    def set_from_map(self, m: dict[str, bool]):
        for k, v in m.items():
            self.set(k, v)

    def known(self) -> dict[str, tuple[str, bool]]:
        with self._lock:
            return dict(self._known)


DEFAULT_FEATURE_GATE = FeatureGate()
