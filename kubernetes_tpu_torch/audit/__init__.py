"""Continuous correctness auditing — trust the control loops, verify them.

Two subsystems share this package:

``auditor`` — a background loop over a resourceVersion-consistent snapshot
of apiserver + scheduler state, checking the invariants a healthy cluster
can never break (no per-resource node overcommit, no double-bind, gang
atomicity, nomination consistency, SchedulerCache-vs-fresh-list parity,
resident-drain-context-vs-cache parity). A confirmed violation increments
``scheduler_invariant_violations_total{invariant}``, writes a replayable
repro bundle to disk, and in fail-fast mode (tests/benches) raises.

``sentinel`` — a runtime device-parity check: every Kth ``drain_step``
dispatch is re-judged against the numpy oracle on the inputs the device
saw, off the hot path. A refuted answer trips the device circuit breaker
with reason ``parity`` — a wrong answer becomes the same observable event
a device *failure* already is.

The port of ``kubernetes_tpu/audit/``.
"""

from kubernetes_tpu_torch.audit.auditor import (  # noqa: F401
    InvariantAuditor,
    InvariantViolationError,
    write_bundle,
)
from kubernetes_tpu_torch.audit.invariants import (  # noqa: F401
    AuditSnapshot,
    Violation,
    run_invariants,
)
from kubernetes_tpu_torch.audit.sentinel import (  # noqa: F401
    ParityError,
    ParitySentinel,
)

__all__ = [
    "AuditSnapshot", "InvariantAuditor", "InvariantViolationError",
    "ParityError", "ParitySentinel", "Violation", "run_invariants",
    "write_bundle",
]
