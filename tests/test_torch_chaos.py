"""The port's chaos harness (``kubernetes_tpu_torch/chaos/``) against the
JAX package's, on the CPU.

Every case of ``tests/test_chaos.py`` runs on both packages through
``tests/torch_store_parity.py``: both pass, and their records are equal.
The multichip one (the breaker's mesh level: a burst drops the configured
(1,2) mesh to single-device, the probe reinstalls it) meets its mesh on
the JAX side with XLA's virtual CPU devices and on the port's with logical
``cpu`` shards (``mesh_from_shape`` counts CUDA cards). The cache-on leg of crash recovery runs the
port's kernel cache (``sched/aotcache.py``) with a stand-in ``nvcc``, and
its runners ready the kernel libraries on the CPU as they do on the card
(``aotcache.KERNEL_DEVICES``): the restart builds nothing and loads its
library from the cache.

Then the port's own cases:

- device chaos on the port's seams: a burst of ``breaker_threshold``
  injected ``drain_step`` failures (with the same-cycle per-batch
  fallback's ``gang_schedule`` failing with them, as ChaosChurn's schedule
  has it: a drain's fallback that succeeds resets the count) moves the
  breaker to ``oracle`` without dropping a cycle; after the cooldown (a
  ``FakeClock``) the half-open probe restores ``single`` and the next
  drain runs on the port's path; the bindings equal a run without chaos,
  and the runner's loop, started for the last wave, ends with no error;
- C1 under chaos: the same seam raising a CUDA error stops the runner
  (``loop_error`` set), and the oracle places no pod;
- the seed and the sites: ``active_chaos_seed()`` returns the installed
  schedule's seed; a ``thread.loop`` ``die`` at the port's
  ``chaos_point("loop")`` is restarted by the watchdog; an error at
  ``chaos_point("resolve")`` requeues the drain's pods, which bind later.
"""

from __future__ import annotations

import stat
import sys
import time

import pytest

import torch_store_parity as parity
from kubernetes_tpu.chaos import hooks as ref_hooks
from kubernetes_tpu_torch.chaos import (ChaosDeviceError, DeviceChaos, Fault,
                                        FaultSchedule, ThreadChaos, hooks)
from kubernetes_tpu_torch.client.clientset import DirectClient
from kubernetes_tpu_torch.config.types import SchedulerConfiguration
from kubernetes_tpu_torch.metrics.registry import LOOP_ERRORS
from kubernetes_tpu_torch.sched import aotcache
from kubernetes_tpu_torch.sched.faults import is_fatal
from kubernetes_tpu_torch.sched.resilience import DeviceCircuitBreaker
from kubernetes_tpu_torch.sched.runner import SchedulerRunner
from kubernetes_tpu_torch.store.store import ObjectStore
from kubernetes_tpu_torch.testing.wrappers import make_node, make_pod
from kubernetes_tpu_torch.utils.clock import FakeClock

NAME = "test_chaos"
WARM_CACHE = "test_crash_recovery_warm_from_cache_restart_parity"
MESH_CASE = "test_breaker_mesh_degrade_and_restore"
CASES = parity.cases(NAME)

STAND_IN = """#!{python}
import sys
args = sys.argv[1:]
if args == ["--version"]:
    print("stand-in nvcc, release 0.0")
    sys.exit(0)
out = args[args.index("-o") + 1]
with open(args[-1], "rb") as src, open(out, "wb") as lib:
    lib.write(b"library of " + src.read())
"""


@pytest.fixture(scope="module")
def shared():
    yield from parity.shared_fixtures()


@pytest.fixture
def cpu_devices(monkeypatch):
    """The port's ``mesh_from_shape`` over 8 logical ``cpu`` shards, as
    the JAX side's over XLA's 8 virtual CPU devices."""
    from kubernetes_tpu_torch.parallel import mesh as mesh_mod
    real = mesh_mod.mesh_from_shape
    monkeypatch.setattr(
        mesh_mod, "mesh_from_shape",
        lambda shape, devices=None: real(shape, devices=devices
                                         or ["cpu"] * 8))


@pytest.fixture
def stand_in_kernels(tmp_path, monkeypatch):
    """The port's runners ready the kernel libraries on the CPU too, built
    by a stand-in ``nvcc`` and loaded by a recording ``_load``; the build
    directory is restored afterwards. -> the loaded paths."""
    from kubernetes_tpu_torch.ops import kernels
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(STAND_IN.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    loads = []
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(kernels, "_load",
                        lambda path: loads.append(str(path)) or object())
    monkeypatch.setattr(aotcache, "KERNEL_DEVICES", ("cuda", "cpu"))
    yield loads
    aotcache.AotExecutableCache.disarm()


@pytest.mark.parametrize("fname,params", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_reference_case_on_both_packages(fname, params, tmp_path, shared,
                                         request):
    loads = (request.getfixturevalue("stand_in_kernels")
             if fname == WARM_CACHE else None)
    if fname == MESH_CASE:
        request.getfixturevalue("cpu_devices")
    try:
        ref, port = parity.both(NAME, fname, params, tmp_path, shared)
    finally:
        # test_chaos.py's autouse fixture: no schedule outlives its case
        ref_hooks.uninstall()
        hooks.uninstall()
    assert port == ref
    if loads is not None:
        # the restarted runners loaded the cold run's library
        assert len(loads) >= 2 and len(set(loads)) == 1, loads


def test_chaos_cases_are_selected():
    assert len(CASES) == 19
    assert MESH_CASE in {c[1] for c in CASES}


# ---- the port's own cases -------------------------------------------------

THRESHOLD = 2
POP = 8   # 2 batches of 4: a deep pop takes the drain


def _nodes(n=4):
    return [make_node(f"n{i}")
            .capacity({"cpu": "8", "memory": "16Gi", "pods": "32"})
            .label("kubernetes.io/hostname", f"n{i}").obj().to_dict()
            for i in range(n)]


def _forced(prefix, n, n_nodes=4, cpu="100m"):
    """Pods whose nodeSelector names their node: every correct run, on
    any path, places them alike."""
    return [make_pod(f"{prefix}{i}").req({"cpu": cpu})
            .node_selector({"kubernetes.io/hostname": f"n{i % n_nodes}"})
            .obj().to_dict() for i in range(n)]


def _free(prefix, n):
    """Pods with no selector, placed by score: where the oracle's wave
    loaded two nodes, a path that lost its placements would place them
    elsewhere than a run without chaos."""
    return [make_pod(f"{prefix}{i}").req({"cpu": "500m", "memory": "1Gi"})
            .obj().to_dict() for i in range(n)]


def _runner(store, **cfg):
    client = DirectClient(store)
    for n in _nodes():
        client.nodes().create(n)
    cfg = SchedulerConfiguration(
        batch_size=POP // 2, max_drain_batches=2,
        breaker_threshold=THRESHOLD, backoff_initial_s=0.01,
        backoff_max_s=0.05, watchdog_interval_s=0.05,
        explainer_enabled=False, parity_sample_every=0, **cfg)
    runner = SchedulerRunner(client, cfg, device="cpu")
    runner.start(start_loop=False)
    runner.scheduler._drain_ready = lambda pend: False
    return client, runner


def _drive(client, runner, pods) -> int:
    """Create ``pods``, wait until all are queued, then run_once until the
    queue and the pipeline are empty -> the pods each pop bound, summed."""
    sched = runner.scheduler
    client.pods().create_many(pods)
    deadline = time.monotonic() + 20.0
    while (runner.queue.stats()["active"] < len(pods)
           and time.monotonic() < deadline):
        time.sleep(0.01)
    bound = 0
    for _ in range(20):
        if runner.queue.stats()["active"] == 0 and not sched._pending:
            break
        bound += sched.run_once(wait=0.01)
    bound += sched._resolve_pending()
    sched.wait_for_bindings()
    return bound


def _bindings(client) -> dict:
    return {p["metadata"]["name"]: p["spec"].get("nodeName")
            for p in client.pods().list()}


def _waves(chaos: bool) -> dict:
    """Six waves of POP pods through one runner: the burst, the oracle
    (its pods on two of the four nodes, 1 CPU each), a probe, another
    probe and one after the restore (half of each placed by score), and
    a last wave through the runner's own loop.
    -> the store's bindings and what each wave saw."""
    store = ObjectStore()
    client, runner = _runner(store)
    sched = runner.scheduler
    clock = FakeClock(0.0)
    sched.breaker = DeviceCircuitBreaker(levels=("single", "oracle"),
                                         threshold=THRESHOLD,
                                         cooldown_s=10.0, clock=clock)
    warm = [make_pod(f"warm{i}").req({"cpu": "100m"}).obj()
            for i in range(POP)]
    assert sched.warm_drain(warm, slot_headroom=64)
    schedule = FaultSchedule([
        Fault("device.drain", "runtime", 0, THRESHOLD),
        Fault("device.gang", "runtime", 0, THRESHOLD - 1)], seed=11)
    device = DeviceChaos(schedule).install() if chaos else None
    seen = {}
    errs = lambda: {s: LOOP_ERRORS.get({"site": s})  # noqa: E731
                    for s in ("device_drain", "device_gang", "run_once")}
    try:
        e0 = errs()
        seen["burst"] = (_drive(client, runner, _forced("a", POP)),
                         sched.breaker.mode, sched.breaker.trips)
        seen["oracle"] = (_drive(client, runner,
                                 _forced("b", POP, n_nodes=2, cpu="1")),
                          sched.breaker.mode)
        clock.advance(11.0)
        seen["probe"] = (_drive(client, runner, _forced("c", POP)),
                         sched.breaker.mode, sched.breaker.restores)
        clock.advance(11.0)
        seen["restore"] = (_drive(client, runner, _forced("r", POP // 2)
                                  + _free("u", POP // 2)),
                           sched.breaker.mode, sched.breaker.restores)
        drains = schedule.peek("device.drain")
        seen["after"] = (_drive(client, runner, _forced("d", POP // 2)
                                + _free("v", POP // 2)),
                         sched.breaker.mode)
        seen["drain_ops_after_restore"] = (schedule.peek("device.drain")
                                           - drains)
        # the last wave through the runner's own loop
        runner.start_loop()
        client.pods().create_many(_forced("e", POP))
        deadline = time.monotonic() + 20.0
        while (not all(_bindings(client).values())
               and time.monotonic() < deadline):
            time.sleep(0.02)
        seen["loop_error"] = runner.loop_error
        seen["errors"] = {s: n - e0[s] for s, n in errs().items()}
        seen["report"] = schedule.report() if chaos else None
    finally:
        if device is not None:
            device.uninstall()
        runner.stop()
    seen["bindings"] = _bindings(client)
    return seen


def test_device_burst_degrades_to_oracle_and_probe_restores():
    got = _waves(chaos=True)
    clean = _waves(chaos=False)
    # the burst: the drain failed, its fallback failed, the breaker tripped
    # and the oracle bound the pop in the same cycle
    assert got["burst"] == (POP, "oracle", 1)
    assert got["oracle"] == (POP, "oracle")
    # the first half-open probe's drain is the burst's last fault: the
    # probe fails and re-arms the cooldown, and the pop still binds; the
    # next probe's drain succeeds and restores the rounds
    assert got["probe"] == (POP, "oracle", 0)
    assert got["restore"] == (POP, "single", 1)
    # the next drain runs on the port's path again
    assert got["after"] == (POP, "single")
    assert got["drain_ops_after_restore"] >= 1
    assert got["errors"]["device_drain"] == THRESHOLD
    assert got["errors"]["device_gang"] == THRESHOLD - 1
    assert got["errors"]["run_once"] == 0
    rep = got["report"]
    assert rep["classes"]["device.drain:runtime"]["fires"] == THRESHOLD
    assert rep["classes"]["device.drain:runtime"]["recovered"] >= 1
    assert rep["unrecovered_sites"] == []
    assert got["loop_error"] is None and clean["loop_error"] is None
    assert clean["burst"] == (POP, "single", 0)
    assert got["bindings"] == clean["bindings"]
    # the pods placed by score on the restored rounds kept off the two
    # nodes that the oracle's wave loaded
    free = {n: node for n, node in got["bindings"].items()
            if n[0] in "uv"}
    assert len(free) == POP and set(free.values()) <= {"n2", "n3"}, free
    assert len(got["bindings"]) == 6 * POP and all(got["bindings"].values())


def test_injected_device_error_is_not_fatal_and_cuda_error_is():
    err = None
    schedule = FaultSchedule([Fault("device.drain", "runtime", 0)])
    with DeviceChaos(schedule):
        from kubernetes_tpu_torch.models import gang
        try:
            gang.drain_step()
        except ChaosDeviceError as e:
            err = e
    assert str(err).startswith("INTERNAL:") and not is_fatal(err)
    assert isinstance(err, RuntimeError)
    assert is_fatal(RuntimeError("CUDA error: an illegal memory access"))


def test_cuda_error_at_the_drain_seam_stops_the_runner(monkeypatch):
    """C1 under chaos: the seam DeviceChaos patches raises a CUDA error
    instead: the loop ends for good with it, and no pod goes to the
    oracle (nothing binds)."""
    from kubernetes_tpu_torch.models import gang
    calls = []

    def broken(*a, **kw):
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    store = ObjectStore()
    client, runner = _runner(store)
    sched = runner.scheduler
    warm = [make_pod(f"warm{i}").req({"cpu": "100m"}).obj()
            for i in range(POP)]
    assert sched.warm_drain(warm, slot_headroom=64)
    oracle = []
    monkeypatch.setattr(sched, "_schedule_oracle",
                        lambda *a: oracle.append(a) or 0)
    monkeypatch.setattr(gang, "drain_step", broken)
    client.pods().create_many(_forced("a", POP))
    deadline = time.monotonic() + 20.0
    while (runner.queue.stats()["active"] < POP
           and time.monotonic() < deadline):
        time.sleep(0.01)
    runner.start_loop()
    try:
        deadline = time.monotonic() + 20.0
        while runner.loop_error is None and time.monotonic() < deadline:
            time.sleep(0.02)
        assert "CUDA error" in str(runner.loop_error)
        assert calls and not oracle
        assert sched.breaker.mode == "single" and sched.breaker.trips == 0
        assert not any(_bindings(client).values())
    finally:
        with pytest.raises(RuntimeError, match="CUDA error"):
            runner.stop()


def test_active_chaos_seed_reads_the_installed_schedule(monkeypatch):
    from kubernetes_tpu.audit.auditor import \
        active_chaos_seed as ref_active_chaos_seed
    from kubernetes_tpu_torch.audit.auditor import active_chaos_seed
    monkeypatch.setenv("KTPU_CHAOS_SEED", "5")
    assert active_chaos_seed() == ref_active_chaos_seed() == 5
    hooks.install(ThreadChaos(FaultSchedule([], seed=1234)))
    ref_hooks.install(ref_hooks.ThreadChaos(
        ref_hooks.FaultSchedule([], seed=1234)))
    try:
        assert active_chaos_seed() == ref_active_chaos_seed() == 1234
    finally:
        hooks.uninstall()
        ref_hooks.uninstall()
    monkeypatch.delenv("KTPU_CHAOS_SEED")
    assert active_chaos_seed() is None


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_loop_death_at_the_loop_site_is_revived():
    store = ObjectStore()
    client, runner = _runner(store)
    schedule = FaultSchedule([Fault("thread.loop", "die", 2)])
    hooks.install(ThreadChaos(schedule))
    try:
        runner.start_loop()
        deadline = time.monotonic() + 20.0
        while (runner._watchdog.restarts < 1
               and time.monotonic() < deadline):
            time.sleep(0.02)
        assert runner._watchdog.restarts >= 1
        assert schedule.report()["classes"]["thread.loop:die"]["fires"] == 1
        hooks.uninstall()
        client.pods().create_many(_forced("p", 4))
        deadline = time.monotonic() + 20.0
        while (not all(_bindings(client).values())
               and time.monotonic() < deadline):
            time.sleep(0.02)
        assert all(_bindings(client).values())
        assert runner.loop_error is None
    finally:
        hooks.uninstall()
        runner.stop()


def test_resolve_site_error_requeues_the_drain():
    """An injected error at ``chaos_point("resolver")`` sends the fetch
    back to the scheduling thread, and one at ``chaos_point("resolve")``
    (that inline fetch) loses the drain's winners: its pods are requeued,
    and a later pop binds them."""
    store = ObjectStore()
    client, runner = _runner(store)
    sched = runner.scheduler
    warm = [make_pod(f"warm{i}").req({"cpu": "100m"}).obj()
            for i in range(POP)]
    assert sched.warm_drain(warm, slot_headroom=64)
    schedule = FaultSchedule([Fault("thread.resolver", "error", 0),
                              Fault("thread.resolve", "error", 0)])
    before = {s: LOOP_ERRORS.get({"site": s})
              for s in ("resolver", "drain_resolve")}
    hooks.install(ThreadChaos(schedule))
    try:
        _drive(client, runner, _forced("a", POP))
        for _ in range(20):
            if all(_bindings(client).values()):
                break
            sched.run_once(wait=0.05)
            sched._resolve_pending()
            sched.wait_for_bindings()
        assert {s: LOOP_ERRORS.get({"site": s}) - n
                for s, n in before.items()} == {"resolver": 1,
                                                "drain_resolve": 1}
        rep = schedule.report()
        for klass in ("thread.resolver:error", "thread.resolve:error"):
            assert rep["classes"][klass]["fires"] == 1
        # the next drain's fetch ran on the resolver again; the inline
        # fetch runs only when the resolver fails, so its span stays open
        assert rep["classes"]["thread.resolver:error"]["recovered"] == 1
        assert rep["unrecovered_sites"] == ["thread.resolve"]
        assert all(_bindings(client).values())
    finally:
        hooks.uninstall()
        runner.stop()


def test_device_seams_are_the_ports():
    """Each seam of the port's DeviceChaos names a module of the port and
    an attribute its callers look up at call time."""
    from kubernetes_tpu_torch.chaos import device
    assert {s[0] for s in device._SEAMS} == {"device.gang", "device.drain",
                                            "device.preempt"}
    for _site, mod, attr in device._SEAMS:
        assert mod.startswith("kubernetes_tpu_torch.")
    schedule = FaultSchedule([])
    chaos = DeviceChaos(schedule).install()
    try:
        from kubernetes_tpu_torch.models import gang
        from kubernetes_tpu_torch.sched import preemption, scheduler
        for fn in (gang.gang_schedule, gang.drain_step,
                   scheduler.gang_schedule, preemption.preempt_wave):
            assert hasattr(fn, "__wrapped__")
    finally:
        chaos.uninstall()
    assert not hasattr(gang.drain_step, "__wrapped__")
