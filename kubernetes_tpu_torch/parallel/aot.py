"""The toolchain fingerprint.

The PyTorch port of ``kubernetes_tpu/parallel/aot.py``, which the durable
kernel cache (``sched/aotcache.py``) builds on:

1. ``toolchain_fingerprint`` — one string that changes iff a library
   built earlier could be wrong for THIS process: the torch version and
   its CUDA, the NVIDIA driver, the card's name and compute capability,
   ``nvcc --version``, the flags ``ops/kernels`` builds with, and any
   caller-declared config knobs. The cache invalidates wholesale on a
   mismatch. (The reference's ``lowering_fingerprint`` covers jax, jaxlib,
   the backend and XLA's flags.)

2. The counterpart of ``CompileMeter`` is two counters: what costs a
   warm start time on the card here is an ``nvcc`` run
   (``ops/kernels.BUILDS``; a library found on disk costs none) and a CUDA
   graph capture (``models/graphs.CAPTURES``). Their readers
   (``AotExecutableCache.stats``, ``Scheduler.warm_drain``) take them
   since a base, so that a "zero builds" gate counts only the builds that
   really ran.

The reference's ``serialize_compiled``/``deserialize_compiled`` have no
counterpart: a CUDA graph holds device addresses and cannot be written
to disk, and PyTorch serializes no compiled program of eager ops. The
one artifact of the port that persists is the ``nvcc``-built library;
the graphs are captured again by every process (the warm ladder,
``Scheduler.warm_drain``).
"""

from __future__ import annotations

import hashlib
import json
import subprocess


def _run(cmd) -> str | None:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def toolchain(knobs: dict | None = None) -> dict:
    """The document ``toolchain_fingerprint`` digests."""
    import torch

    from kubernetes_tpu_torch.ops import kernels
    device = {"name": None, "capability": None}
    if torch.cuda.is_available():
        device = {"name": torch.cuda.get_device_name(0),
                  "capability": list(torch.cuda.get_device_capability(0))}
    try:
        nvcc = _run([kernels._nvcc(), "--version"])
    except kernels.KernelError:
        nvcc = None
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "driver": _run(["nvidia-smi", "--query-gpu=driver_version",
                        "--format=csv,noheader"]),
        "device": device,
        "nvcc": nvcc,
        "nvccFlags": list(kernels.NVCC_FLAGS),
        "knobs": knobs or {},
    }


def toolchain_fingerprint(knobs: dict | None = None) -> str:
    """Hex digest of everything that must match for a cached library to be
    trusted by this process. ``knobs``: the caller's config that changes
    what is built or captured; JSON-serializable."""
    return hashlib.sha256(json.dumps(toolchain(knobs), sort_keys=True,
                                     default=str).encode()).hexdigest()
