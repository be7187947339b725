"""Durable kernel cache — warm start without building.

The PyTorch port of ``kubernetes_tpu/sched/aotcache.py``. The reference
persists every XLA executable its warm ladder compiles; in the port the
one artifact that persists is a kernel library ``nvcc`` built
(``ops/kernels.py``), and the CUDA graphs of the rounds are captured again
by every process (``models/graphs.py``; a graph holds device addresses, so
it cannot be written to disk). This module keeps the reference's
discipline on those libraries, in a cache directory (``aotCacheDir``):

  fingerprint   ``FINGERPRINT.json`` pins the toolchain (torch and its
                CUDA, the NVIDIA driver, the card and its compute capability,
                ``nvcc --version`` and the build flags) and the declared
                config knobs, through parallel/aot.toolchain_fingerprint.
                A mismatch at boot invalidates the cache WHOLESALE
                (counted).
  integrity     ``MANIFEST.json`` records each entry's size and sha256 at
                seal time. The boot scan deletes (and counts, under
                ``scheduler_aot_cache_errors_total``) any truncated or
                bit-flipped library BEFORE ``ctypes`` can load it, and
                every load is checked against the manifest again
                (``ops/kernels.arm``): a rejected entry is rebuilt, never
                loaded.
  atomicity     fingerprint and manifest commit through
                utils/atomicio.atomic_write_json (temp file + fsync +
                rename).
  bound         a size GC evicts the least recently used entries past
                ``max_bytes`` (counted as ``reason="rotation"``).

An unmanifested library (a crash between its build and the seal) is kept
and re-hashed, as the reference keeps an unmanifested entry:
``ops/kernels.build`` renames its output into place only once ``nvcc``
has finished, so the file is whole; the manifest exists to catch the
torn or flipped bytes of a later write and to pin what the seal saw.

Correctness backstop: the runner forces the parity sentinel to sample the
FIRST drain after a boot from a cache with entries (the canary).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time
from pathlib import Path
from typing import Optional

from kubernetes_tpu_torch.metrics.registry import (
    AOT_CACHE_BOOT_MS,
    AOT_CACHE_BYTES,
    AOT_CACHE_ENTRIES,
    AOT_CACHE_ERRORS,
    AOT_CACHE_INVALIDATIONS,
)
from kubernetes_tpu_torch.models import graphs
from kubernetes_tpu_torch.ops import kernels
from kubernetes_tpu_torch.parallel.aot import toolchain_fingerprint
from kubernetes_tpu_torch.utils.atomicio import atomic_write_json

_LOG = logging.getLogger(__name__)

FINGERPRINT_FILE = "FINGERPRINT.json"
MANIFEST_FILE = "MANIFEST.json"
ENTRY_SUFFIX = ".so"             # ops/kernels' libraries
DEFAULT_MAX_BYTES = 512 * 1024 * 1024
# the device types whose scheduler launches the kernels: a runner with a
# cache readies every library at boot there (``ready_kernels``)
KERNEL_DEVICES = ("cuda",)


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class AotExecutableCache:
    """One managed library-cache directory (``root/entries`` + fingerprint
    + manifest). ``activate()`` arms it process-wide (``ops/kernels``
    builds into and loads from ``entries``); ``seal()`` commits the
    manifest after the warm ladder has built new entries."""

    def __init__(self, root: str, knobs: Optional[dict] = None,
                 max_bytes: int = DEFAULT_MAX_BYTES):
        self.root = os.path.abspath(root)
        self.entries_dir = os.path.join(self.root, "entries")
        self.knobs = dict(knobs or {})
        self.max_bytes = int(max_bytes)
        self.fingerprint = toolchain_fingerprint(self.knobs)
        self.active = False
        # counted degrades (mirrored into the registry metrics; kept as
        # plain ints too so one cache instance's stats don't read another
        # incarnation's process-wide counters)
        self.errors = 0          # corrupt/unreadable entries deleted
        self.invalidations = 0   # fingerprint wholesale + rotation GC
        self.boot: dict = {}     # last activate() report
        self._manifest: dict = {}
        # (kernels.BUILDS, graphs.CAPTURES, kernels.HITS) at activation
        self._meter_base: Optional[tuple] = None
        self._sealed_sig: Optional[tuple] = None

    # ---- boot ------------------------------------------------------------

    def activate(self) -> dict:
        """Fingerprint-check, integrity-scan, GC and ARM the cache (points
        ``ops/kernels`` at ``entries/``). Returns the boot report also kept
        as ``self.boot``. Never raises on cache damage — every rejected
        entry is a counted rebuild, and a stale cache is invalidated
        wholesale."""
        t0 = time.monotonic()
        os.makedirs(self.entries_dir, exist_ok=True)
        stale = self._fingerprint_stale()
        if stale:
            self._invalidate_all(reason="fingerprint")
        manifest = self._load_manifest()
        kept, swept = self._integrity_scan(manifest)
        rotated = self._gc(kept)
        for name in rotated:
            kept.pop(name, None)
        self._commit_meta(kept)
        kernels.arm(self.entries_dir, verify=self._verify)
        self._meter_base = (kernels.BUILDS, graphs.CAPTURES, kernels.HITS)
        n_bytes = sum(e["bytes"] for e in kept.values())
        self.boot = {
            "entries": len(kept),
            "bytes": n_bytes,
            "loadMs": round((time.monotonic() - t0) * 1000.0, 1),
            "fingerprintStale": stale,
            "corruptSwept": swept,
            "rotated": len(rotated),
        }
        AOT_CACHE_ENTRIES.set(len(kept))
        AOT_CACHE_BYTES.set(n_bytes)
        AOT_CACHE_BOOT_MS.set(self.boot["loadMs"])
        self.active = True
        _LOG.info(
            "kernel cache armed at %s: %d entries (%.1f KB) in %sms%s%s",
            self.root, len(kept), n_bytes / 1e3, self.boot["loadMs"],
            f", {swept} corrupt swept" if swept else "",
            " after WHOLESALE fingerprint invalidation" if stale else "")
        return self.boot

    def ready_kernels(self, device) -> int:
        """Build or load every kernel library now, where ``device`` (a
        ``torch.device``) is of a type in ``KERNEL_DEVICES`` (the
        reference's warm ladder compiles every program whatever the
        workload): a cold boot fills the cache and a restart loads from
        it, whether or not its first pops reach a kernel. A library that
        does not build raises ``KernelError`` (fatal, as at a launch).
        -> the libraries readied."""
        if device.type not in KERNEL_DEVICES:
            return 0
        for name in kernels.KERNELS:
            kernels.library(name)
        return len(kernels.KERNELS)

    def _fingerprint_stale(self) -> bool:
        path = os.path.join(self.root, FINGERPRINT_FILE)
        try:
            with open(path) as f:
                recorded = json.load(f).get("fingerprint")
        except FileNotFoundError:
            return False  # first boot: nothing to distrust
        except (OSError, ValueError, AttributeError):
            return True   # unreadable fingerprint = unverifiable cache
        return recorded != self.fingerprint

    def _invalidate_all(self, reason: str) -> None:
        """Wholesale: every entry goes, and the manifest with them."""
        n = 0
        for name in self._listdir():
            try:
                os.unlink(os.path.join(self.entries_dir, name))
                if name.endswith(ENTRY_SUFFIX):
                    n += 1
            except OSError:
                pass
        try:
            os.unlink(os.path.join(self.root, MANIFEST_FILE))
        except OSError:
            pass
        self.invalidations += n
        AOT_CACHE_INVALIDATIONS.inc({"reason": reason}, by=max(n, 1))
        _LOG.warning("kernel cache %s: %d entries invalidated wholesale "
                     "(%s)", self.root, n, reason)

    def _load_manifest(self) -> dict:
        path = os.path.join(self.root, MANIFEST_FILE)
        try:
            with open(path) as f:
                doc = json.load(f)
            return dict(doc.get("entries") or {})
        except FileNotFoundError:
            return {}
        except (OSError, ValueError, AttributeError, TypeError):
            # an unreadable manifest means NO entry is verifiable
            AOT_CACHE_ERRORS.inc({"reason": "manifest"})
            self.errors += 1
            return {}

    def _integrity_scan(self, manifest: dict) -> tuple[dict, int]:
        """Every library on disk either matches its manifest checksum or is
        deleted before ``ctypes`` can load it; an unmanifested one is kept
        and re-hashed. Leftover temp files of an interrupted build go
        (uncounted: they were never entries)."""
        for name in self._listdir(".tmp"):
            try:
                os.unlink(os.path.join(self.entries_dir, name))
            except OSError:
                pass
        kept: dict = {}
        swept = 0
        for name in self._listdir(ENTRY_SUFFIX):
            path = os.path.join(self.entries_dir, name)
            want = manifest.get(name)
            try:
                digest = _sha256_file(path)
                size = os.path.getsize(path)
            except OSError:
                self._sweep_entry(name, "unreadable")
                swept += 1
                continue
            if want is not None and (want.get("sha256") != digest
                                     or want.get("bytes") != size):
                self._sweep_entry(name, "corrupt")
                swept += 1
                continue
            kept[name] = {"sha256": digest, "bytes": size,
                          "sealed": (want or {}).get("sealed", False)}
        self._manifest = dict(kept)
        return kept, swept

    def _sweep_entry(self, name: str, reason: str) -> None:
        self.errors += 1
        AOT_CACHE_ERRORS.inc({"reason": reason})
        try:
            os.unlink(os.path.join(self.entries_dir, name))
        except OSError:
            pass
        _LOG.warning("kernel cache entry %s rejected (%s) — deleted; the "
                     "kernel is built again on first use", name, reason)

    def _verify(self, path) -> bool:
        """``ops/kernels``' check before a load: a manifested library must
        still match its checksum (a mismatch is swept, counted, and built
        again); one built since the last seal is trusted."""
        name = Path(path).name
        want = self._manifest.get(name)
        if want is None:
            return True
        try:
            ok = (os.path.getsize(path) == want["bytes"]
                  and _sha256_file(str(path)) == want["sha256"])
        except OSError:
            ok = False
        if not ok:
            self._manifest.pop(name, None)
            self._sweep_entry(name, "corrupt")
        return ok

    def _gc(self, kept: dict) -> list[str]:
        """Size bound: evict the least recently used entries (access time,
        falling back to mtime) until under ``max_bytes``."""
        total = sum(e["bytes"] for e in kept.values())
        if total <= self.max_bytes:
            return []

        def used_ts(name: str) -> float:
            try:
                st = os.stat(os.path.join(self.entries_dir, name))
            except OSError:
                return 0.0
            return max(st.st_atime, st.st_mtime)

        rotated: list[str] = []
        for name in sorted(kept, key=used_ts):
            if total <= self.max_bytes:
                break
            total -= kept[name]["bytes"]
            try:
                os.unlink(os.path.join(self.entries_dir, name))
            except OSError:
                pass
            rotated.append(name)
        if rotated:
            self.invalidations += len(rotated)
            AOT_CACHE_INVALIDATIONS.inc({"reason": "rotation"},
                                        by=len(rotated))
            _LOG.info("kernel cache rotated %d entries past the %d-byte "
                      "bound", len(rotated), self.max_bytes)
        return rotated

    def _commit_meta(self, entries: dict) -> None:
        atomic_write_json(os.path.join(self.root, FINGERPRINT_FILE),
                          {"fingerprint": self.fingerprint,
                           "knobs": self.knobs}, indent=1, default=str)
        atomic_write_json(os.path.join(self.root, MANIFEST_FILE),
                          {"entries": entries}, indent=1)
        self._sealed_sig = self._dir_sig()

    @staticmethod
    def disarm() -> None:
        """Detach ``ops/kernels`` from any cache directory: it builds into
        and loads from ``build/kernels/`` again (tests restore the
        process-global default)."""
        kernels.disarm()

    # ---- steady state ----------------------------------------------------

    def _listdir(self, suffix: str = "") -> list[str]:
        try:
            return sorted(n for n in os.listdir(self.entries_dir)
                          if n.endswith(suffix))
        except OSError:
            return []

    def _dir_sig(self) -> tuple:
        return tuple((n, self._size(n)) for n in self._listdir(ENTRY_SUFFIX))

    def _size(self, name: str) -> int:
        try:
            return os.path.getsize(os.path.join(self.entries_dir, name))
        except OSError:
            return 0

    def seal(self, force: bool = False) -> int:
        """Re-hash and commit the manifest for the CURRENT entry set —
        called after the warm ladder (and on the status cadence) so
        libraries built since the last seal become verifiable at the next
        boot. Cheap no-op when the entry set hasn't changed. Returns the
        number of manifested entries."""
        if not self.active:
            return 0
        if not force and self._dir_sig() == self._sealed_sig:
            return len(self._sealed_sig or ())
        entries: dict = {}
        for name in self._listdir(ENTRY_SUFFIX):
            path = os.path.join(self.entries_dir, name)
            try:
                entries[name] = {"sha256": _sha256_file(path),
                                 "bytes": os.path.getsize(path),
                                 "sealed": True}
            except OSError:
                continue  # racing eviction; next seal re-judges
        try:
            self._commit_meta(entries)
        except OSError:
            self.errors += 1
            AOT_CACHE_ERRORS.inc({"reason": "io"})
            _LOG.warning("kernel cache manifest commit failed",
                         exc_info=True)
            return len(entries)
        self._manifest = dict(entries)
        AOT_CACHE_ENTRIES.set(len(entries))
        AOT_CACHE_BYTES.set(sum(e["bytes"] for e in entries.values()))
        return len(entries)

    def stats(self) -> dict:
        """Status-surface block. ``realBuilds`` is ``nvcc`` work since
        activation — 0 after a warm boot is the warm-start property
        itself; ``realCompiles`` is the same count under the reference's
        name (its compile meter's genuine compiles); ``hits`` counts the
        libraries loaded since without a build; ``captures`` counts the
        CUDA graphs captured since, which every process pays (its warm
        ladder)."""
        entries = self._listdir(ENTRY_SUFFIX)
        stats = {"enabled": True, "dir": self.root,
                 "entries": len(entries),
                 "bytes": sum(self._size(n) for n in entries),
                 "errors": self.errors,
                 "invalidations": self.invalidations,
                 "bootEntries": self.boot.get("entries"),
                 "bootLoadMs": self.boot.get("loadMs")}
        if self._meter_base is not None:
            builds0, captures0, hits0 = self._meter_base
            stats["realBuilds"] = kernels.BUILDS - builds0
            stats["realCompiles"] = stats["realBuilds"]
            stats["hits"] = kernels.HITS - hits0
            stats["captures"] = graphs.CAPTURES - captures0
        return stats


def resolve_cache_dir(cfg) -> Optional[str]:
    """The effective cache directory: ``KTPU_AOT_CACHE`` overrides
    config (``"0"``/``"off"`` disable; any other value is a path), else
    ``cfg.aot_cache_dir``; None = disabled (the default)."""
    env = os.environ.get("KTPU_AOT_CACHE")
    if env is not None:
        s = env.strip()
        if s.lower() in ("", "0", "off", "none", "false"):
            return None
        return s
    return getattr(cfg, "aot_cache_dir", None)


def cache_knobs(cfg) -> dict:
    """Config knobs that change what is built enough to distrust old
    entries wholesale: none. The reference's executables are specialized
    to the batch size, the drain depth, the fused fold and the mesh; the
    one artifact kept here, an ``nvcc``-built library, depends on none of
    them (its name hashes its source; the toolchain and ``NVCC_FLAGS`` are
    in the fingerprint already). A graph captured at those shapes is never
    written to disk."""
    return {}
