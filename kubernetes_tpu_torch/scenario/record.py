"""Recorders — turn a live run's artifacts into replayable traces.

Two capture paths, both offline (they read files a run already wrote,
never touch a live store):

* :func:`trace_from_wal` replays a durable store's ``wal.jsonl`` into a
  trace: every journaled mutation becomes a timed event, nodes present
  before the first pod op become the manifest fleet, and the active
  chaos seed (if the run had one) rides the manifest so the replay
  faces the same fault schedule. Any failed bench window or production
  incident with a WAL on disk is now a scenario file.

* :func:`trace_from_bundle` converts an audit repro bundle (the JSON
  the invariant auditor writes on every confirmed violation) into a
  trace: the pending pod batch at violation time becomes a correlated
  create burst, and the bundle's ``chaosSeed`` arms the same schedule —
  the "replay the incident" button the bundle always promised.
"""

from __future__ import annotations

import json
from typing import Optional

from kubernetes_tpu_torch.scenario.generate import _node_template, _pod_template
from kubernetes_tpu_torch.scenario.trace import (Trace, TraceEvent,
                                           TraceFormatError, TraceManifest)

#: kinds a recorded trace replays; everything else in a WAL (leases,
#: events, configmaps...) is control-plane chatter the scheduler stack
#: regenerates itself — replaying it would fight the live controllers
REPLAYED_KINDS = ("Pod", "Node")


def _strip_server_fields(obj: dict) -> dict:
    """Drop server-minted metadata so the replay target mints its own
    (a recorded uid/resourceVersion would collide or confuse)."""
    obj = json.loads(json.dumps(obj))  # deep copy, JSON-safe
    md = obj.get("metadata") or {}
    for k in ("uid", "resourceVersion", "creationTimestamp",
              "deletionTimestamp", "managedFields"):
        md.pop(k, None)
    return obj


def trace_from_wal(wal_path: str, name: str = "wal-capture",
                   spacing_s: float = 0.05,
                   chaos_seed: Optional[int] = None,
                   chaos_profile: str = "churn",
                   max_events: int = 5000) -> Trace:
    """Parse a durable store's ``wal.jsonl`` into a trace.

    WAL entries carry rv order but no wall time; creates are offset by
    their objects' ``creationTimestamp`` where present, and everything
    else advances by ``spacing_s`` — order is exact, pacing is a
    faithful-enough reconstruction for replay.
    """
    entries = []
    with open(wal_path, "rb") as f:
        for line in f:
            if not line.endswith(b"\n"):
                break  # torn tail: same trust boundary as WAL restore
            try:
                e = json.loads(line)
            except ValueError:
                break
            if e.get("kind") in REPLAYED_KINDS:
                entries.append(e)
    if not entries:
        raise TraceFormatError(f"{wal_path}: no replayable Pod/Node "
                               "entries")
    entries = entries[:max_events]

    fleet: list = []
    events: list[TraceEvent] = []
    seen: set = set()
    saw_pod = False
    t = 0.0
    t0_wall: Optional[float] = None
    for e in entries:
        kind, ns, nm = e["kind"], e.get("ns", ""), e["name"]
        key = (kind, ns, nm)
        obj = e.get("obj")
        if e["op"] == "set":
            verb = "update" if key in seen else "create"
            seen.add(key)
            if kind == "Node" and not saw_pod and verb == "create":
                # pre-existing fleet: seeded before replay starts
                fleet.append({"obj": _strip_server_fields(obj)})
                continue
            if kind == "Pod":
                saw_pod = True
            ct = ((obj or {}).get("metadata") or {}) \
                .get("creationTimestamp")
            if verb == "create" and isinstance(ct, (int, float)):
                if t0_wall is None:
                    t0_wall = float(ct)
                t = max(t, float(ct) - t0_wall)
            else:
                t += spacing_s
            events.append(TraceEvent(
                at_s=round(t, 4), verb=verb, kind=kind, ns=ns, name=nm,
                obj=_strip_server_fields(obj) if obj else None,
                phase="recorded"))
        elif e["op"] == "del":
            seen.discard(key)
            t += spacing_s
            events.append(TraceEvent(
                at_s=round(t, 4), verb="delete", kind=kind, ns=ns,
                name=nm, phase="recorded"))
    chaos = ({"seed": int(chaos_seed), "profile": chaos_profile}
             if chaos_seed is not None else None)
    manifest = TraceManifest(
        name=name, seed=int(chaos_seed or 0),
        description=f"captured from WAL {wal_path} "
                    f"({len(events)} events)",
        fleet=fleet, templates={}, chaos=chaos)
    return Trace(manifest, events)


def trace_from_bundle(bundle, name: Optional[str] = None,
                      nodes: int = 8, spacing_s: float = 0.05) -> Trace:
    """Convert an audit repro bundle (path or parsed dict) to a trace.

    The bundle records the pending pod batch (ns/name keys) and the
    chaos seed at violation time, not full specs — the conversion pairs
    each key with the standard heterogeneous pod template and replays
    the batch as one correlated burst under the same fault schedule.
    """
    if isinstance(bundle, str):
        with open(bundle) as f:
            bundle = json.load(f)
    batch = bundle.get("podBatch") or []
    if not batch:
        raise TraceFormatError("bundle carries no podBatch to replay")
    import random
    rng = random.Random(0)
    templates = {"node": _node_template(),
                 "incident-pod": _pod_template(rng, app="incident")}
    events: list[TraceEvent] = []
    t = 0.0
    for key in batch:
        ns, _, nm = key.partition("/")
        events.append(TraceEvent(
            at_s=round(t, 4), verb="create", kind="Pod",
            ns=ns or "default", name=nm, template="incident-pod",
            phase="incident"))
        t += spacing_s
    seed = bundle.get("chaosSeed")
    chaos = ({"seed": int(seed), "profile": "churn"}
             if seed is not None else None)
    manifest = TraceManifest(
        name=name or f"bundle-{bundle.get('invariant', 'incident')}",
        seed=int(seed or 0),
        description=(f"audit bundle replay: {bundle.get('invariant')} "
                     f"at rv {bundle.get('resourceVersion')} "
                     f"({len(batch)} pending pods)"),
        fleet=[{"template": "node", "count": int(nodes),
                "prefix": "sn"}],
        templates=templates, chaos=chaos)
    return Trace(manifest, events)
