"""Which failures stop the scheduler for good.

One predicate, ``is_fatal``, shared by every place in ``sched/`` that
catches a failure of device work: the scheduler's gang, drain, resolve,
preemption and loop sites, the explainer, the runner's loop and the
planners' own loops (``loop_until_fatal``: the background planner, the
autoscaler's and the descheduler's ``start``). A fatal failure is re-raised there and ends the
runner's loop (``SchedulerRunner.loop_error``); it is never degraded to
the numpy oracle or the host scan, and never retried.

This is a deliberate difference from the reference, whose scheduler feeds
its breaker and degrades to the oracle on an XLA error: the port's rule is
to never degrade around the card.
"""

from __future__ import annotations

import torch

from kubernetes_tpu_torch.audit.sentinel import ParityError
from kubernetes_tpu_torch.models.graphs import GraphError
from kubernetes_tpu_torch.ops.kernels import KernelError


def is_fatal(e: BaseException) -> bool:
    """True for a failure that no retry cures:

    - ``KernelError``: a hand kernel that does not build, load or launch;
    - ``GraphError``: a CUDA graph of the gang rounds that does not
      capture or replay (models/graphs.py; never run eagerly instead);
    - ``ParityError``: the parity sentinel refuted a device answer;
    - ``NotImplementedError``: a feature the port has not got yet;
    - an error of the CUDA runtime (``torch.AcceleratorError``; a torch
      without that class raises ``RuntimeError("CUDA error: ...")``). It
      leaves the CUDA context unusable, so every later launch fails too.

    ``torch.cuda.OutOfMemoryError`` is not fatal: the allocator refused one
    request and the context stays usable, so it keeps the retry path (the
    breaker, the per-batch path, the host scan).
    """
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return False
    if isinstance(e, (KernelError, GraphError, ParityError,
                      NotImplementedError)):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(e, accel):
        return True
    return isinstance(e, RuntimeError) and str(e).startswith("CUDA error")


def loop_until_fatal(owner, interval: float, what: str, log) -> None:
    """The body of a planner's own loop thread (``BackgroundPlanner``,
    ``ClusterAutoscaler``, ``Descheduler``): ``owner.run_once()`` every
    ``interval`` seconds until ``owner._stop`` is set. A failure that
    ``is_fatal`` calls fatal stops the loop for good and is kept as
    ``owner.loop_error``; any other is logged and the loop goes on."""
    while not owner._stop.is_set():
        try:
            owner.run_once()
        except Exception as e:
            if not is_fatal(e):
                log.exception("%s failed", what)
            else:
                # a kernel that fails, a parity refutation, a feature not
                # ported yet or a CUDA error
                owner.loop_error = e
                log.critical("%s stopped for good: %r", what, e)
                return
        owner._stop.wait(interval)
