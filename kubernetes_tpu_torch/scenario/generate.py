"""Builtin scenario generators — production-shaped workloads as pure
functions ``(params, seed) -> Trace``.

Every generator derives ALL randomness from one ``random.Random(seed)``
and rounds every timestamp to 4 decimals, so the same (params, seed)
produces the same bytes on every machine — the committed golden fixture
``scenario-smoke.trace.jsonl`` pins this across toolchain drift (the tests
hold both packages' ``smoke(seed=0)`` to it).

The template pools reuse ``testing/workloads.py`` shapes (same
heterogeneous capacities/labels the existing benches schedule), so a
scenario's pods stress the same filter/score paths as the synthetic
churn they replace — just with correlated arrival times instead of a
uniform drip.
"""

from __future__ import annotations

import math
import random

from kubernetes_tpu_torch.scenario.trace import Trace, TraceEvent, TraceManifest

_ZONES = [f"zone-{i}" for i in range(4)]


def _node_template(cpu: str = "32", mem: str = "128Gi",
                   pods: str = "110") -> dict:
    # same shape make_node(...).obj().to_dict() produces (the driver
    # stamps metadata.name + the hostname label at materialize time)
    return {"kind": "Node", "metadata": {"labels": {}},
            "spec": {},
            "status": {"capacity": {"cpu": cpu, "memory": mem,
                                    "pods": pods},
                       "allocatable": {"cpu": cpu, "memory": mem,
                                       "pods": pods}}}


def _pod_template(rng: random.Random, app: str) -> dict:
    """One heterogeneous pod spec drawn from the workloads.py request
    pool (cpu/mem choices match mixed_heterogeneous)."""
    return {"kind": "Pod",
            "metadata": {"labels": {"app": app}},
            "spec": {"schedulerName": "default-scheduler",
                     "restartPolicy": "Always",
                     "containers": [{
                         "name": "c0",
                         "resources": {"requests": {
                             "cpu": rng.choice(
                                 ["100m", "250m", "500m", "1"]),
                             "memory": rng.choice(
                                 ["128Mi", "512Mi", "1Gi"])}}}]},
            "status": {"phase": "Pending"}}


def _templates(rng: random.Random, n_pod_templates: int = 4) -> dict:
    out = {"node": _node_template()}
    for i in range(n_pod_templates):
        out[f"pod-t{i}"] = _pod_template(rng, app=f"svc-{i}")
    return out


def _pick(rng: random.Random, n_pod_templates: int) -> str:
    return f"pod-t{rng.randrange(n_pod_templates)}"


def _r(t: float) -> float:
    return round(t, 4)


def diurnal_burst(params: dict | None = None, seed: int = 0) -> Trace:
    """Sinusoidal arrival waves + superimposed burst noise: the diurnal
    load curve a production scheduler actually faces. Wave pods arrive
    at the sinusoid's inverse-CDF quantiles (dense at the crest, sparse
    in the trough) with per-pod jitter; each burst dumps a correlated
    clump within ~100ms."""
    p = {"pods": 120, "nodes": 24, "cycles": 2, "period_s": 6.0,
         "bursts": 2, "burst_pods": 24, "templates": 4,
         "p99_slo_s": None, **(params or {})}
    rng = random.Random(seed)
    nt = int(p["templates"])
    templates = _templates(rng, nt)
    duration = float(p["period_s"]) * int(p["cycles"])
    events: list[TraceEvent] = []
    # inverse-CDF over intensity 1 + 0.8*sin: integrate on a fine grid,
    # then place pod i at the time where cumulative mass hits (i+.5)/N
    grid = 2048
    cum = [0.0]
    for g in range(grid):
        t = duration * (g + 0.5) / grid
        lam = 1.0 + 0.8 * math.sin(2 * math.pi * t / float(p["period_s"]))
        cum.append(cum[-1] + lam)
    total = cum[-1]
    n = int(p["pods"])
    for i in range(n):
        target = (i + 0.5) / n * total
        g = next(gi for gi in range(grid) if cum[gi + 1] >= target)
        t = duration * (g + rng.random()) / grid
        cycle = min(int(t // float(p["period_s"])), int(p["cycles"]) - 1)
        events.append(TraceEvent(
            at_s=_r(t), verb="create", kind="Pod", ns="default",
            name=f"dw-{i}", template=_pick(rng, nt),
            phase=f"wave-{cycle}"))
    for b in range(int(p["bursts"])):
        # bursts land near the crest of a cycle picked per-burst
        cycle = rng.randrange(int(p["cycles"]))
        t0 = (cycle + 0.25) * float(p["period_s"]) \
            + rng.uniform(-0.2, 0.2) * float(p["period_s"])
        t0 = min(max(t0, 0.0), duration)
        for j in range(int(p["burst_pods"])):
            events.append(TraceEvent(
                at_s=_r(t0 + rng.random() * 0.1), verb="create",
                kind="Pod", ns="default", name=f"db-{b}-{j}",
                template=_pick(rng, nt), phase=f"burst-{b}"))
    gates = {}
    if p["p99_slo_s"] is not None:
        gates["p99AttemptLatencySeconds"] = float(p["p99_slo_s"])
    manifest = TraceManifest(
        name="diurnal-burst", seed=seed,
        description=(f"{n} wave pods over {int(p['cycles'])} sinusoid "
                     f"cycles + {int(p['bursts'])} correlated bursts of "
                     f"{int(p['burst_pods'])}"),
        fleet=[{"template": "node", "count": int(p["nodes"]),
                "prefix": "sn"}],
        templates=templates, slo_gates=gates)
    return Trace(manifest, events)


def rolling_update(params: dict | None = None, seed: int = 0) -> Trace:
    """Controller-driven rollout: the old ReplicaSet's pods exist from
    t=0, then create+delete streams shaped by maxSurge/maxUnavailable
    walk the fleet to the new generation — the create/delete correlation
    no Poisson churn produces."""
    p = {"replicas": 24, "nodes": 12, "max_surge": 4,
         "max_unavailable": 2, "step_s": 0.4, "templates": 2,
         **(params or {})}
    rng = random.Random(seed)
    nt = int(p["templates"])
    templates = _templates(rng, nt)
    events: list[TraceEvent] = []
    n = int(p["replicas"])
    for i in range(n):
        events.append(TraceEvent(
            at_s=_r(rng.random() * 0.2), verb="create", kind="Pod",
            ns="default", name=f"old-{i}", template=_pick(rng, nt),
            phase="pre"))
    surge, unavail = int(p["max_surge"]), int(p["max_unavailable"])
    created = deleted = 0
    t = 1.0  # old generation gets a beat to bind before the rollout
    step = 0
    while deleted < n:
        # surge phase: bring up new pods (bounded by maxSurge ahead)
        while created < n and created - deleted < surge:
            events.append(TraceEvent(
                at_s=_r(t + rng.random() * 0.05), verb="create",
                kind="Pod", ns="default", name=f"new-{created}",
                template=_pick(rng, nt), phase=f"roll-{step // 4}"))
            created += 1
        # drain phase: take down old pods (bounded by maxUnavailable)
        for _ in range(min(unavail, created - deleted, n - deleted)):
            events.append(TraceEvent(
                at_s=_r(t + 0.05 + rng.random() * 0.05), verb="delete",
                kind="Pod", ns="default", name=f"old-{deleted}",
                phase=f"roll-{step // 4}"))
            deleted += 1
        t += float(p["step_s"])
        step += 1
    manifest = TraceManifest(
        name="rolling-update", seed=seed,
        description=(f"{n}-replica rollout, maxSurge={surge} "
                     f"maxUnavailable={unavail}"),
        fleet=[{"template": "node", "count": int(p["nodes"]),
                "prefix": "sn"}],
        templates=templates)
    return Trace(manifest, events)


def job_waves(params: dict | None = None, seed: int = 0) -> Trace:
    """Batch job storms: waves of short-lived jobs created together and
    deleted together ``lifetime_s`` later. The final wave stays resident
    so a replay still has a 100%-bound gate to hold."""
    p = {"waves": 3, "jobs_per_wave": 16, "nodes": 12,
         "wave_interval_s": 2.0, "lifetime_s": 1.5, "templates": 2,
         **(params or {})}
    rng = random.Random(seed)
    nt = int(p["templates"])
    templates = _templates(rng, nt)
    events: list[TraceEvent] = []
    waves = int(p["waves"])
    for w in range(waves):
        t0 = w * float(p["wave_interval_s"])
        for j in range(int(p["jobs_per_wave"])):
            name = f"job-{w}-{j}"
            events.append(TraceEvent(
                at_s=_r(t0 + rng.random() * 0.15), verb="create",
                kind="Pod", ns="jobs", name=name,
                template=_pick(rng, nt), phase=f"jobwave-{w}"))
            if w < waves - 1:  # final wave stays resident
                events.append(TraceEvent(
                    at_s=_r(t0 + float(p["lifetime_s"])
                            + rng.random() * 0.15),
                    verb="delete", kind="Pod", ns="jobs", name=name,
                    phase=f"jobwave-{w}"))
    manifest = TraceManifest(
        name="job-waves", seed=seed,
        description=(f"{waves} waves x {int(p['jobs_per_wave'])} jobs, "
                     f"lifetime {p['lifetime_s']}s"),
        fleet=[{"template": "node", "count": int(p["nodes"]),
                "prefix": "sn"}],
        templates=templates)
    return Trace(manifest, events)


def tenant_onboarding(params: dict | None = None, seed: int = 0) -> Trace:
    """New tenants land on a LIVE fleet: each onboarding is one burst of
    creates into the tenant's namespace, staggered tenant-by-tenant, on
    top of a small steady background."""
    p = {"tenants": 3, "pods_per_tenant": 12, "background_pods": 8,
         "nodes": 12, "stagger_s": 1.5, "templates": 2,
         **(params or {})}
    rng = random.Random(seed)
    nt = int(p["templates"])
    templates = _templates(rng, nt)
    events: list[TraceEvent] = []
    duration = int(p["tenants"]) * float(p["stagger_s"]) + 1.0
    for i in range(int(p["background_pods"])):
        events.append(TraceEvent(
            at_s=_r(rng.random() * duration), verb="create", kind="Pod",
            ns="default", name=f"bg-{i}", template=_pick(rng, nt),
            phase="background"))
    for ten in range(int(p["tenants"])):
        t0 = 0.5 + ten * float(p["stagger_s"])
        for i in range(int(p["pods_per_tenant"])):
            events.append(TraceEvent(
                at_s=_r(t0 + rng.random() * 0.2), verb="create",
                kind="Pod", ns=f"tenant-{ten}", name=f"tp-{ten}-{i}",
                template=_pick(rng, nt), tenant=f"tenant-{ten}",
                phase=f"onboard-{ten}"))
    manifest = TraceManifest(
        name="tenant-onboarding", seed=seed,
        description=(f"{int(p['tenants'])} tenant onboarding bursts of "
                     f"{int(p['pods_per_tenant'])} pods onto a live "
                     "fleet"),
        fleet=[{"template": "node", "count": int(p["nodes"]),
                "prefix": "sn"}],
        templates=templates)
    return Trace(manifest, events)


def autoscaler_thrash(params: dict | None = None, seed: int = 0) -> Trace:
    """Scale-up/scale-down oscillation: bursts of pending pods big enough
    to overflow the base fleet arrive, bind, then vanish almost entirely a
    beat later — the arrival pattern that whipsaws an autoscaler between
    "add nodes NOW" and "this capacity is provably unneeded" every period.
    A small resident floor keeps utilization non-zero so scale-down is a
    judgment call, not a no-op; ``survivors`` pods of each burst stay
    behind so consecutive swings compound instead of resetting."""
    p = {"swings": 4, "burst_pods": 24, "survivors": 2, "floor_pods": 6,
         "nodes": 6, "period_s": 2.0, "templates": 4, **(params or {})}
    rng = random.Random(seed)
    nt = int(p["templates"])
    templates = _templates(rng, nt)
    events: list[TraceEvent] = []
    for i in range(int(p["floor_pods"])):
        events.append(TraceEvent(
            at_s=_r(rng.random() * 0.2), verb="create", kind="Pod",
            ns="default", name=f"floor-{i}", template=_pick(rng, nt),
            phase="floor"))
    period = float(p["period_s"])
    burst = int(p["burst_pods"])
    survivors = min(int(p["survivors"]), burst)
    for s in range(int(p["swings"])):
        t0 = 0.5 + s * period
        for j in range(burst):
            name = f"thrash-{s}-{j}"
            events.append(TraceEvent(
                at_s=_r(t0 + rng.random() * 0.15), verb="create",
                kind="Pod", ns="default", name=name,
                template=_pick(rng, nt), phase=f"swing-{s}-up"))
            if j >= survivors:
                # the collapse: most of the burst evaporates mid-period,
                # flipping the fleet from overflow to under-utilization
                events.append(TraceEvent(
                    at_s=_r(t0 + 0.5 * period + rng.random() * 0.15),
                    verb="delete", kind="Pod", ns="default", name=name,
                    phase=f"swing-{s}-down"))
    manifest = TraceManifest(
        name="autoscaler-thrash", seed=seed,
        description=(f"{int(p['swings'])} scale-up/down swings of "
                     f"{burst} pods ({survivors} survive each) over a "
                     f"{int(p['floor_pods'])}-pod floor"),
        fleet=[{"template": "node", "count": int(p["nodes"]),
                "prefix": "sn"}],
        templates=templates)
    return Trace(manifest, events)


def smoke(params: dict | None = None, seed: int = 0) -> Trace:
    """The committed golden fixture: a small diurnal-burst trace sized
    for tests and ``BENCH_SCENARIO=builtin:smoke``."""
    p = {"pods": 24, "nodes": 8, "cycles": 2, "period_s": 2.0,
         "bursts": 1, "burst_pods": 8, **(params or {})}
    t = diurnal_burst(p, seed=seed)
    t.manifest.name = "smoke"
    return t


BUILTINS = {
    "diurnal-burst": diurnal_burst,
    "rolling-update": rolling_update,
    "job-waves": job_waves,
    "tenant-onboarding": tenant_onboarding,
    "autoscaler-thrash": autoscaler_thrash,
    "smoke": smoke,
}


def builtin_trace(name: str, seed: int = 0,
                  params: dict | None = None) -> Trace:
    """Resolve a builtin by name — the ``builtin:<name>`` half of
    ``BENCH_SCENARIO`` and the ``ktpu scenario generate`` catalog."""
    fn = BUILTINS.get(name)
    if fn is None:
        raise KeyError(f"unknown builtin scenario {name!r} "
                       f"(catalog: {', '.join(sorted(BUILTINS))})")
    return fn(params, seed=seed)
