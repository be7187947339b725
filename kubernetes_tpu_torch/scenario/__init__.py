"""Cluster time machine: trace-driven scenario engine.

Production-shaped workloads as versioned, replayable JSONL traces —
generated (diurnal waves, rolling updates, job storms, tenant
onboarding), recorded from live runs (WAL / audit bundles), and played
back through a real clientset by a time-warped driver.
"""

from kubernetes_tpu_torch.scenario.driver import SCENARIO_CONFIGMAP, ScenarioDriver
from kubernetes_tpu_torch.scenario.generate import BUILTINS, builtin_trace
from kubernetes_tpu_torch.scenario.record import trace_from_bundle, trace_from_wal
from kubernetes_tpu_torch.scenario.trace import (TRACE_VERSION, Trace, TraceEvent,
                                           TraceFormatError, TraceManifest)

__all__ = [
    "SCENARIO_CONFIGMAP", "ScenarioDriver", "BUILTINS", "builtin_trace",
    "trace_from_bundle", "trace_from_wal", "TRACE_VERSION", "Trace",
    "TraceEvent", "TraceFormatError", "TraceManifest",
]
