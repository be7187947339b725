"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C entry point. ``build`` compiles
the sources with ``nvcc`` for Hopper (``sm_90a``) into shared libraries
under ``build/kernels/`` at the root of the checkout, one ``nvcc`` per
source, all started together; ``library`` loads one with ``ctypes``,
building it at first use. A library's file name carries a hash of its
source, so an edited kernel is rebuilt and a stale one is never loaded.

While a durable cache is armed (``sched/aotcache.py``: ``arm``), the
libraries are built into and loaded from its ``entries`` directory
instead, and each is checked against the cache's manifest before it is
loaded: a damaged entry is deleted and rebuilt (counted by the cache),
never loaded. ``disarm`` restores ``build/kernels/``.

``BUILDS`` counts the ``nvcc`` builds this process ran (a library found on
disk costs none): the planners' ``CompileCounter`` (encode/overlay.py)
reads it to prove a window built nothing. ``LAUNCHES`` counts the launches
of each kernel. A wrapper calls ``count_launch`` where it launches its
kernel and nowhere else, so a caller can set the counts to 0, run a path,
and see which kernels it went through. A launch made while a CUDA graph
is captured runs at each replay, not then: it is tallied in ``CAPTURED``
and the graph adds it to ``LAUNCHES`` at every replay
(``models/graphs.py``). A launch by a device mesh's shard
(parallel/mesh.py) also adds one to ``SHARD_LAUNCHES[(name, i, j)]``,
so a caller can see that every shard launched.

``KernelError`` is what a kernel's build, load, launch or input check
raises. It is never degraded around: the scheduler's circuit breaker lets
it escape instead of moving the work off the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from kubernetes_tpu_torch.utils.atomicio import atomic_publish

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

KERNELS = ("count_pn",)
LAUNCHES = {name: 0 for name in KERNELS}
CAPTURED = {name: 0 for name in KERNELS}
SHARD_LAUNCHES: dict = {}
BUILDS = 0
# libraries loaded without a build: found on disk at first use (an armed
# cache's entry, or an earlier build's)
HITS = 0

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# BUILDS moves under this one: build() also runs under _LOCK (library())
_COUNT_LOCK = threading.Lock()
# the armed cache: (entries directory, verify(path) -> bool) or None
_ARMED = None


class KernelError(RuntimeError):
    """A hand-written kernel failed to build, load or launch."""


class KernelInputError(KernelError, ValueError):
    """A kernel's wrapper refused its inputs or its launch geometry."""


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        SHARD_LAUNCHES.clear()


def count_launch(name: str) -> None:
    """One launch of kernel ``name`` by its wrapper; under a CUDA graph's
    capture it is tallied for the graph's replays instead."""
    import torch
    from kubernetes_tpu_torch.parallel import mesh
    capturing = (torch.cuda.is_available()
                 and torch.cuda.is_current_stream_capturing())
    shard = mesh.current()
    with _COUNT_LOCK:
        if capturing:
            CAPTURED[name] += 1
            return
        LAUNCHES[name] += 1
        if shard is not None:
            key = (name, shard.i, shard.j)
            SHARD_LAUNCHES[key] = SHARD_LAUNCHES.get(key, 0) + 1


def arm(directory, verify=None) -> None:
    """Build into and load from ``directory`` (a durable cache's entries);
    ``verify(path)`` judges a library before it is loaded and deletes it
    when it is damaged. Loaded libraries are forgotten."""
    global _ARMED
    with _LOCK:
        _ARMED = (Path(directory), verify)
        _LIBS.clear()


def disarm() -> None:
    """Back to ``build/kernels/`` (loaded libraries are forgotten)."""
    global _ARMED
    with _LOCK:
        _ARMED = None
        _LIBS.clear()


def build_dir() -> Path:
    return _ARMED[0] if _ARMED is not None else BUILD_DIR


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise KernelError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return build_dir() / f"lib{name}-{digest}.so"


def _present(path: Path) -> bool:
    """The library is on disk and, under an armed cache, intact (a
    damaged one is deleted by the cache's check, so it is built anew)."""
    if not path.exists():
        return False
    verify = _ARMED[1] if _ARMED is not None else None
    return verify is None or verify(path)


def build(names=KERNELS) -> dict[str, dict]:
    """Compile every named kernel whose library is missing, in parallel.
    -> {name: {"path", "built", "ptxas"}}; raises with nvcc's output if a
    build fails."""
    build_dir().mkdir(parents=True, exist_ok=True)
    jobs = {}
    out = {}
    for name in names:
        path = _lib_path(name)
        out[name] = {"path": str(path), "built": False, "ptxas": ""}
        if _present(path):
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, path)
    global BUILDS
    with _COUNT_LOCK:
        BUILDS += len(jobs)
    failed = []
    for name, (proc, tmp, path) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        atomic_publish(str(tmp), str(path))
        out[name].update(built=True, ptxas=log.strip())
    if failed:
        raise KernelError("nvcc failed for " + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            global HITS
            path = _lib_path(name)
            if not _present(path):
                build((name,))
            else:
                HITS += 1
            try:
                lib = _load(path)
            except OSError as e:
                raise KernelError(f"cannot load {path}: {e}") from e
            _LIBS[name] = lib
        return lib


def _load(path: Path):
    return ctypes.CDLL(str(path))
