"""Which failures stop the scheduler for good.

One predicate, ``is_fatal``, shared by every place in ``sched/`` that
catches a failure of device work: the scheduler's gang, drain, resolve,
preemption and loop sites, the explainer, the runner's loop and the
background planner. A fatal failure is re-raised there and ends the
runner's loop (``SchedulerRunner.loop_error``); it is never degraded to
the numpy oracle or the host scan, and never retried.

This is a deliberate difference from the reference, whose scheduler feeds
its breaker and degrades to the oracle on an XLA error: the port's rule is
to never degrade around the card.
"""

from __future__ import annotations

import torch

from kubernetes_tpu_torch.audit.sentinel import ParityError
from kubernetes_tpu_torch.ops.kernels import KernelError


def is_fatal(e: BaseException) -> bool:
    """True for a failure that no retry cures:

    - ``KernelError``: a hand kernel that does not build, load or launch;
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
    if isinstance(e, (KernelError, ParityError, NotImplementedError)):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(e, accel):
        return True
    return isinstance(e, RuntimeError) and str(e).startswith("CUDA error")
