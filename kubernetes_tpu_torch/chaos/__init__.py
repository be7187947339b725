"""Chaos harness — seeded, schedule-driven fault injection at every seam.

The scheduler is one stateless-ish client in a state-convergence loop:
the apiserver, not the scheduler, is the source of truth, so every
failure — API errors, dropped watch streams, device miscompiles, stalled
threads, its own crash — must degrade into a retry/relist/rebuild, never
a hang or a loss. This package injects those failures deterministically
(one seed replays a whole run) so the product's self-healing — informer
relist, the device circuit breaker, the thread watchdog, bind retries,
crash recovery — is exercised instead of assumed.

    schedule = FaultSchedule.generate(seed_from_env())
    client = ChaosClient(HTTPClient(url), schedule)       # API + watch
    with DeviceChaos(schedule):                           # device programs
        hooks.install(ThreadChaos(schedule))              # thread seams
        ... run the workload ...
        hooks.uninstall()
    print(schedule.report())   # per-fault-class recovery spans

Exports resolve LAZILY (PEP 562): product code imports only the tiny
``chaos.hooks`` seam (scheduler.py's chaos_point), and executing this
``__init__`` must not make the whole injection harness — api.py's
clientset wrapper, device.py's program patcher — load-bearing for the
production scheduler. Harness modules import only when a chaos run
actually reaches for them.
"""

_EXPORTS = {
    "Fault": "schedule", "FaultSchedule": "schedule",
    "seed_from_env": "schedule",
    "ChaosError": "hooks", "ChaosDeviceError": "hooks",
    "ChaosThreadDeath": "hooks", "ThreadChaos": "hooks",
    "chaos_point": "hooks",
    "ChaosClient": "api", "ChaosResource": "api", "ChaosWatch": "api",
    "DeviceChaos": "device",
    "ApiServerProcess": "apiserver", "InProcessApiServer": "apiserver",
    "free_port": "apiserver",
    "SchedulerProcess": "scheduler",
}

__all__ = sorted(_EXPORTS) + ["hooks"]


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
