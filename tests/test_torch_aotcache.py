"""The port's durable kernel cache (sched/aotcache.py) — the failure menu.

The cases of ``tests/test_aotcache.py``, on the port's one persistent
artifact: the ``nvcc``-built kernel libraries of ``ops/kernels``. A
stand-in for ``nvcc`` (a small script, through a monkeypatched
``kernels._nvcc``) writes the libraries on the CPU, and a monkeypatched
``kernels._load`` records what would be handed to ``ctypes``. The contract
is the reference's: damage degrades to a COUNTED rebuild — never a crash,
never a damaged library loaded — and an intact cache makes the restart
build nothing. Every test restores ``ops/kernels``' build directory
(``AotExecutableCache.disarm``), so nothing leaks into the next test file.
"""

from __future__ import annotations

import json
import os
import stat
import sys

import pytest

from kubernetes_tpu_torch.config.types import (SchedulerConfiguration,
                                               ValidationError, validate)
from kubernetes_tpu_torch.metrics.registry import AOT_CACHE_ERRORS
from kubernetes_tpu_torch.ops import kernels
from kubernetes_tpu_torch.parallel.aot import toolchain_fingerprint
from kubernetes_tpu_torch.sched.aotcache import (
    ENTRY_SUFFIX,
    FINGERPRINT_FILE,
    MANIFEST_FILE,
    AotExecutableCache,
    cache_knobs,
    resolve_cache_dir,
)

pytestmark = pytest.mark.disaster

STAND_IN = """#!{python}
import sys
args = sys.argv[1:]
if args == ["--version"]:
    print("stand-in nvcc, release 0.0")
    sys.exit(0)
out = args[args.index("-o") + 1]
with open(args[-1], "rb") as src, open(out, "wb") as lib:
    lib.write(b"library of " + src.read() * 64)
"""


@pytest.fixture
def toolchain(tmp_path, monkeypatch):
    """Two kernel sources and a stand-in nvcc; -> their names. The build
    directory and the loaded libraries are restored afterwards."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a", "b"):
        (csrc / f"{name}.cu").write_text(f"// kernel {name}\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(STAND_IN.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    loads = []

    def load(path):
        loads.append((str(path), path.read_bytes()))
        return object()

    monkeypatch.setattr(kernels, "CSRC", csrc)
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(kernels, "_load", load)
    yield {"names": ("a", "b"), "loads": loads, "csrc": csrc}
    AotExecutableCache.disarm()


@pytest.fixture
def cache_root(tmp_path, toolchain):
    yield str(tmp_path / "aot")


def _entries(cache) -> list:
    return [n for n in os.listdir(cache.entries_dir)
            if n.endswith(ENTRY_SUFFIX)]


def _populate(root: str, knobs=None, names=("a",)) -> int:
    """Activate a fresh cache at ``root``, build ``names`` into it, seal,
    and return the sealed entry count."""
    cache = AotExecutableCache(root, knobs={"k": 1} if knobs is None
                               else knobs)
    cache.activate()
    before = kernels.BUILDS
    kernels.build(names)
    assert kernels.BUILDS - before == len(names)
    n = cache.seal()
    assert n == len(names)
    AotExecutableCache.disarm()
    return n


# ---- warm restart ------------------------------------------------------------

def test_warm_restart_loads_instead_of_building(cache_root, toolchain):
    n = _populate(cache_root)
    cache = AotExecutableCache(cache_root, knobs={"k": 1})
    boot = cache.activate()
    assert boot["entries"] == n
    assert boot["fingerprintStale"] is False
    assert boot["corruptSwept"] == 0 and boot["rotated"] == 0
    kernels.library("a")
    stats = cache.stats()
    assert stats["realBuilds"] == 0, stats  # the headline property
    assert stats["errors"] == 0 and stats["invalidations"] == 0
    (path, _blob), = toolchain["loads"]
    assert os.path.dirname(path) == cache.entries_dir


# ---- corruption --------------------------------------------------------------

def _flip(path):
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(blob))


def test_bitflip_swept_and_rebuilt_not_loaded(cache_root, toolchain):
    _populate(cache_root)
    probe = AotExecutableCache(cache_root, knobs={"k": 1})
    victim = os.path.join(probe.entries_dir, _entries(probe)[0])
    intact = open(victim, "rb").read()
    _flip(victim)
    cache = AotExecutableCache(cache_root, knobs={"k": 1})
    boot = cache.activate()
    assert boot["corruptSwept"] == 1 and cache.errors == 1
    assert not os.path.exists(victim)  # deleted before ctypes could load it
    base = kernels.BUILDS
    kernels.library("a")
    assert kernels.BUILDS - base == 1
    # the library loaded is the rebuilt one, never the flipped bytes
    assert toolchain["loads"] == [(victim, intact)]
    assert cache.stats()["errors"] == 1


def test_damage_after_boot_is_rebuilt_at_load(cache_root, toolchain):
    """A library damaged after the boot scan is caught by the check
    before the load: swept, counted and built again."""
    _populate(cache_root)
    cache = AotExecutableCache(cache_root, knobs={"k": 1})
    assert cache.activate()["entries"] == 1
    victim = os.path.join(cache.entries_dir, _entries(cache)[0])
    intact = open(victim, "rb").read()
    _flip(victim)
    errors = AOT_CACHE_ERRORS.get({"reason": "corrupt"})
    kernels.library("a")
    assert cache.errors == 1
    assert AOT_CACHE_ERRORS.get({"reason": "corrupt"}) == errors + 1
    assert toolchain["loads"] == [(victim, intact)]


def test_truncation_swept(cache_root):
    _populate(cache_root)
    probe = AotExecutableCache(cache_root, knobs={"k": 1})
    victim = os.path.join(probe.entries_dir, _entries(probe)[0])
    with open(victim, "r+b") as f:
        f.truncate(max(1, os.path.getsize(victim) // 2))
    cache = AotExecutableCache(cache_root, knobs={"k": 1})
    boot = cache.activate()
    assert boot["corruptSwept"] == 1
    assert not os.path.exists(victim)


def test_corrupt_manifest_counted_entries_survive(cache_root):
    """A garbage manifest is a counted error, but the libraries are NOT
    thrown away: ``kernels.build`` renames a library into place only once
    nvcc has finished, so unverifiable-but-present beats a cold build."""
    n = _populate(cache_root)
    with open(os.path.join(cache_root, MANIFEST_FILE), "w") as f:
        f.write("{torn")
    cache = AotExecutableCache(cache_root, knobs={"k": 1})
    boot = cache.activate()
    assert cache.errors == 1  # reason="manifest"
    assert boot["entries"] == n and boot["corruptSwept"] == 0
    # and the re-hash re-manifested them for the NEXT boot
    doc = json.load(open(os.path.join(cache_root, MANIFEST_FILE)))
    assert len(doc["entries"]) == n


# ---- fingerprint -------------------------------------------------------------

def test_stale_fingerprint_invalidates_wholesale(cache_root):
    _populate(cache_root, knobs={"k": 1})
    cache = AotExecutableCache(cache_root, knobs={"k": 2})  # knob changed
    boot = cache.activate()
    assert boot["fingerprintStale"] is True
    assert boot["entries"] == 0 and cache.invalidations >= 1
    assert _entries(cache) == []  # nothing salvaged
    # the new fingerprint is committed: the NEXT same-knob boot trusts it
    doc = json.load(open(os.path.join(cache_root, FINGERPRINT_FILE)))
    assert doc["fingerprint"] == cache.fingerprint


def test_unreadable_fingerprint_treated_as_stale(cache_root):
    _populate(cache_root)
    with open(os.path.join(cache_root, FINGERPRINT_FILE), "w") as f:
        f.write("not json")
    cache = AotExecutableCache(cache_root, knobs={"k": 1})
    boot = cache.activate()
    assert boot["fingerprintStale"] is True and boot["entries"] == 0


def test_fingerprint_covers_the_toolchain(toolchain, monkeypatch):
    """Another nvcc, other build flags or another knob: another
    fingerprint."""
    base = toolchain_fingerprint({"k": 1})
    assert toolchain_fingerprint({"k": 1}) == base
    assert toolchain_fingerprint({"k": 2}) != base
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-G",))
    assert toolchain_fingerprint({"k": 1}) != base
    monkeypatch.undo()
    monkeypatch.setattr(kernels, "_nvcc", lambda: "/nonexistent/nvcc")
    assert toolchain_fingerprint({"k": 1}) != base


# ---- size bound --------------------------------------------------------------

def test_gc_rotates_past_max_bytes(cache_root):
    n = _populate(cache_root, names=("a", "b"))
    cache = AotExecutableCache(cache_root, knobs={"k": 1}, max_bytes=1)
    boot = cache.activate()
    assert boot["rotated"] == n and boot["entries"] == 0
    assert cache.invalidations == n  # counted as reason="rotation"


# ---- wiring ------------------------------------------------------------------

def test_resolve_cache_dir_env_override(monkeypatch, tmp_path):
    cfg = SchedulerConfiguration.from_dict(
        {"aotCacheDir": str(tmp_path / "cfg")})
    monkeypatch.delenv("KTPU_AOT_CACHE", raising=False)
    assert resolve_cache_dir(cfg) == str(tmp_path / "cfg")
    for off in ("", "0", "off", "none", "FALSE"):
        monkeypatch.setenv("KTPU_AOT_CACHE", off)
        assert resolve_cache_dir(cfg) is None
    monkeypatch.setenv("KTPU_AOT_CACHE", str(tmp_path / "env"))
    assert resolve_cache_dir(cfg) == str(tmp_path / "env")
    monkeypatch.delenv("KTPU_AOT_CACHE")
    assert resolve_cache_dir(SchedulerConfiguration()) is None


def test_cache_knobs_cover_lowering_config(toolchain, monkeypatch):
    """The cached libraries depend on no scheduler option: the reference's
    knobs (batch size, drain depth, fused fold, mesh) leave the
    fingerprint as it is, so changing them keeps every entry. A changed
    build flag or a caller's knob changes it (wholesale distrust)."""
    base = SchedulerConfiguration()
    other = SchedulerConfiguration(batch_size=512, max_drain_batches=2,
                                   fused_fold=False, mesh_shape=(2, 1))
    assert cache_knobs(base) == cache_knobs(other) == {}
    fp = toolchain_fingerprint(cache_knobs(base))
    assert fp == toolchain_fingerprint(cache_knobs(other))
    assert fp != toolchain_fingerprint({"k": 1})
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-G",))
    assert fp != toolchain_fingerprint(cache_knobs(base))


def test_config_options_and_validation():
    cfg = SchedulerConfiguration.from_dict(
        {"aotCacheDir": "/var/cache/ktpu", "aotCacheMaxMB": 64})
    assert (cfg.aot_cache_dir, cfg.aot_cache_max_mb) == ("/var/cache/ktpu",
                                                         64)
    assert SchedulerConfiguration.from_dict(
        {"aotCacheDir": None}).aot_cache_dir is None
    validate(cfg)
    with pytest.raises(ValidationError, match="aotCacheMaxMB"):
        validate(SchedulerConfiguration(aot_cache_max_mb=0))


def test_disarm_restores_the_build_directory(cache_root):
    default = kernels.build_dir()
    cache = AotExecutableCache(cache_root, knobs={"k": 1})
    cache.activate()
    assert kernels.build_dir() == type(default)(cache.entries_dir)
    AotExecutableCache.disarm()
    assert kernels.build_dir() == default == kernels.BUILD_DIR


def _runner(cfg):
    from kubernetes_tpu_torch.client.clientset import DirectClient
    from kubernetes_tpu_torch.config.features import FeatureGate
    from kubernetes_tpu_torch.sched.runner import SchedulerRunner
    from kubernetes_tpu_torch.store.store import ObjectStore
    return SchedulerRunner(DirectClient(ObjectStore()), cfg,
                           feature_gate=FeatureGate(), device="cpu")


def test_runner_arms_the_cache_and_forces_the_canary(cache_root):
    """Armed before the Scheduler exists; a boot from a cache with entries
    forces the parity sentinel's next drain sample; the status carries
    the aotCache block (sealed on the status cadence)."""
    cfg = SchedulerConfiguration(aot_cache_dir=cache_root,
                                 explainer_enabled=False)
    _populate(cache_root, knobs=cache_knobs(cfg))
    runner = _runner(cfg)
    try:
        assert runner.aot_cache.boot["entries"] == 1
        assert runner.scheduler.sentinel._force_drain is True
        status = runner._aot_cache_status()
        assert status["enabled"] and status["entries"] == 1
        assert status["realBuilds"] == 0
    finally:
        runner.scheduler.close()
    # an empty cache arms without the canary
    empty = _runner(SchedulerConfiguration(
        aot_cache_dir=cache_root + "-empty", explainer_enabled=False))
    try:
        assert empty.aot_cache.boot["entries"] == 0
        assert empty.scheduler.sentinel._force_drain is False
    finally:
        empty.scheduler.close()


def test_runner_counts_a_cache_it_cannot_arm(tmp_path, toolchain):
    """A cache directory that cannot be made is counted, and the runner
    builds afresh into build/kernels/ (the cache is disarmed)."""
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    before = AOT_CACHE_ERRORS.get({"reason": "activate"})
    runner = _runner(SchedulerConfiguration(
        aot_cache_dir=str(blocker / "aot"), explainer_enabled=False))
    try:
        assert runner.aot_cache is None
        assert AOT_CACHE_ERRORS.get({"reason": "activate"}) == before + 1
        assert kernels.build_dir() == kernels.BUILD_DIR
        assert runner._aot_cache_status() == {"enabled": False}
    finally:
        runner.scheduler.close()
