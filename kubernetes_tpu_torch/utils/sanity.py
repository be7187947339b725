"""Tensor-path sanity checking — the race/NaN "sanitizer" analog.

The reference leans on Go's race detector and strict types; the tensor
path's equivalent hazards are NaN poisoning (a NaN score silently wins or
loses every argmax), out-of-range gathers (clipped silently on TPU), and
assignments pointing at pad nodes. Two tools:

- ``check_step_result`` — host-side invariant sweep over a StepResult for
  tests and debug harnesses (it needs the [P,N] tensors). The scheduler's
  production ``KTPU_CHECK=1`` gate runs ``check_assignment`` per batch —
  the gang path only materializes the final assignment vector, so that is
  the invariant it can check without extra device->host traffic.
- ``checked_evaluate`` — the schedule step with its NaN and bounds
  checks, for tests and debugging sessions (NOT for the hot path).

The PyTorch port of ``kubernetes_tpu/utils/sanity.py``, without the
autoscaler's node-group checks.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _np(x) -> np.ndarray:
    """A host numpy view of a tensor (on any device) or an array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def check_enabled() -> bool:
    return os.environ.get("KTPU_CHECK", "0").lower() in ("1", "true", "on")


def check_step_result(res, n_real_nodes: int) -> list[str]:
    """-> list of invariant violations (empty = clean).

    Invariants: scores are never NaN; feasible entries have finite scores;
    infeasible entries are -inf; an assigned pod's choice is a REAL node
    (not bucket padding) that its own mask marked feasible.
    """
    problems: list[str] = []
    scores = _np(res.scores)
    feasible = _np(res.feasible)
    choice = _np(res.choice)
    assigned = _np(res.assigned)
    if np.isnan(scores).any():
        problems.append(f"NaN scores at {int(np.isnan(scores).sum())} entries")
    if not np.isfinite(scores[feasible]).all():
        problems.append("non-finite score on a feasible (pod, node)")
    if np.isfinite(scores[~feasible]).any():
        problems.append("finite score on an infeasible (pod, node)")
    if assigned.any():
        ch = choice[assigned]
        if (ch < 0).any() or (ch >= n_real_nodes).any():
            problems.append("assignment outside the real node range "
                            f"(max {int(ch.max())} vs {n_real_nodes})")
        else:
            picked = feasible[np.flatnonzero(assigned), ch]
            if not picked.all():
                problems.append("pod assigned to a node its mask rejected")
    return problems


def check_assignment(assignment, n_real_nodes: int) -> list[str]:
    """Bounds sweep for a gang/drain assignment vector ([-1, n_real))."""
    a = _np(assignment)
    bad = (a >= n_real_nodes) | (a < -1)
    if bad.any():
        return [f"{int(bad.sum())} assignments outside [-1, {n_real_nodes})"]
    return []


def checked_evaluate(ct, pb, **kw):
    """``evaluate`` followed by its invariant checks on the tensors it
    returns: raises on a NaN score or an assignment outside the node
    range. The reference instruments the traced program with checkify;
    an eager program can check its outputs directly."""
    from kubernetes_tpu_torch.models.schedule_step import evaluate

    res = evaluate(ct, pb, **kw)
    if bool(torch.isnan(res.scores).any()):
        raise FloatingPointError(
            f"NaN scores at {int(torch.isnan(res.scores).sum())} entries")
    n = int(ct.node_valid.shape[0])
    ch = res.choice[res.assigned]
    if bool(((ch < 0) | (ch >= n)).any()):
        raise IndexError(f"assignment outside [0, {n})")
    return res
