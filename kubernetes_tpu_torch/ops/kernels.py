"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C entry point. ``build`` compiles
the sources with ``nvcc`` for Hopper (``sm_90a``) into shared libraries
under ``build/kernels/`` at the root of the checkout, one ``nvcc`` per
source, all started together; ``library`` loads one with ``ctypes``,
building it at first use. A library's file name carries a hash of its
source, so an edited kernel is rebuilt and a stale one is never loaded.

``LAUNCHES`` counts the launches of each kernel. A wrapper adds one where
it launches its kernel and nowhere else, so a caller can set the counts to
0, run a path, and see which kernels it went through.

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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

KERNELS = ("count_pn",)
LAUNCHES = {name: 0 for name in KERNELS}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


class KernelError(RuntimeError):
    """A hand-written kernel failed to build, load or launch."""


class KernelInputError(KernelError, ValueError):
    """A kernel's wrapper refused its inputs or its launch geometry."""


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=KERNELS) -> dict[str, dict]:
    """Compile every named kernel whose library is missing, in parallel.
    -> {name: {"path", "built", "ptxas"}}; raises with nvcc's output if a
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    out = {}
    for name in names:
        path = _lib_path(name)
        out[name] = {"path": str(path), "built": False, "ptxas": ""}
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, path)
    failed = []
    for name, (proc, tmp, path) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, path)
        out[name].update(built=True, ptxas=log.strip())
    if failed:
        raise KernelError("nvcc failed for " + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build((name,))
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise KernelError(f"cannot load {path}: {e}") from e
            _LIBS[name] = lib
        return lib
