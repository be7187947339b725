"""Trace format — the cluster time machine's on-disk scenario schema.

A trace is one JSONL file: line 1 is the manifest header (seed, node
fleet spec, object templates, chaos profile, SLO gates), every following
line is one event (``at_s`` offset from replay start, verb, object
template ref or inline object, tenant, phase, optional chaos-fault ref).
Serialization is canonical (sorted keys, no whitespace), so the SAME
trace always produces the SAME bytes: save -> load -> save is bit-equal,
and generator determinism is testable as string equality.

The format is versioned: a loader refuses a version it does not know
instead of guessing — a silently misread incident trace would "replay"
something other than the incident.
"""

from __future__ import annotations

import copy
import json
from dataclasses import dataclass, field
from typing import Iterator, Optional

TRACE_KIND = "ktpu-trace"
TRACE_VERSION = 1

#: verbs a trace event may carry (the driver rejects anything else at
#: load time, not at dispatch time — a typo'd verb fails the whole file)
VERBS = ("create", "update", "delete")

TENANT_LABEL = "kubernetes-tpu.io/scenario-tenant"


class TraceFormatError(ValueError):
    """The file is not a loadable trace (unknown version/kind, bad verb,
    malformed line). Deliberately loud: replaying a misparsed incident
    would manufacture false evidence."""


@dataclass
class TraceEvent:
    """One timed action against the cluster.

    ``template`` names a manifest template the driver materializes (with
    this event's name/ns/tenant stamped in); ``obj`` is an inline object
    for recorded traces whose specs came from a live WAL. delete events
    need neither.
    """
    at_s: float
    verb: str
    kind: str  # Pod | Node
    ns: str
    name: str
    template: str = ""
    tenant: str = ""
    phase: str = ""
    fault: str = ""  # chaos-fault site ref (informational; the schedule
    #                  itself rides the manifest's chaos block)
    obj: Optional[dict] = None

    def key(self) -> str:
        return f"{self.kind}:{self.ns}/{self.name}"

    def to_dict(self) -> dict:
        d = {"at_s": self.at_s, "verb": self.verb, "kind": self.kind,
             "ns": self.ns, "name": self.name}
        for k in ("template", "tenant", "phase", "fault"):
            v = getattr(self, k)
            if v:
                d[k] = v
        if self.obj is not None:
            d["obj"] = self.obj
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TraceEvent":
        verb = d.get("verb")
        if verb not in VERBS:
            raise TraceFormatError(f"unknown event verb {verb!r} "
                                   f"(known: {', '.join(VERBS)})")
        return cls(at_s=float(d["at_s"]), verb=verb, kind=d["kind"],
                   ns=d.get("ns", "default"), name=d["name"],
                   template=d.get("template", ""),
                   tenant=d.get("tenant", ""), phase=d.get("phase", ""),
                   fault=d.get("fault", ""), obj=d.get("obj"))


@dataclass
class TraceManifest:
    """Line 1 of the file: everything the driver needs BEFORE t=0."""
    name: str
    seed: int = 0
    description: str = ""
    #: node fleet seeded before replay starts. Entries are either
    #: ``{"template": ref, "count": n, "prefix": p}`` (materialized) or
    #: ``{"obj": {...}}`` (inline, e.g. recorded from a WAL).
    fleet: list = field(default_factory=list)
    #: named object templates events reference by ``template``
    templates: dict = field(default_factory=dict)
    #: ``{"profile": ..., "seed": ...}`` — arm a FaultSchedule on the
    #: scheduler's transport for the replay window; None = no chaos
    chaos: Optional[dict] = None
    #: hard gates the bench case applies to the replay's result JSON
    #: (check_slo_gates vocabulary: p99AttemptLatencySeconds etc.)
    slo_gates: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        d = {"kind": TRACE_KIND, "version": TRACE_VERSION,
             "name": self.name, "seed": self.seed,
             "fleet": self.fleet, "templates": self.templates,
             "sloGates": self.slo_gates}
        if self.description:
            d["description"] = self.description
        if self.chaos is not None:
            d["chaos"] = self.chaos
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TraceManifest":
        if d.get("kind") != TRACE_KIND:
            raise TraceFormatError(
                f"not a {TRACE_KIND} file (kind={d.get('kind')!r})")
        v = d.get("version")
        if v != TRACE_VERSION:
            raise TraceFormatError(
                f"unknown trace version {v!r} (this build reads "
                f"version {TRACE_VERSION}); refusing to guess")
        return cls(name=d.get("name", "<unnamed>"),
                   seed=int(d.get("seed", 0)),
                   description=d.get("description", ""),
                   fleet=list(d.get("fleet") or []),
                   templates=dict(d.get("templates") or {}),
                   chaos=d.get("chaos"),
                   slo_gates=dict(d.get("sloGates") or {}))


def _canon(d: dict) -> str:
    return json.dumps(d, sort_keys=True, separators=(",", ":"))


class Trace:
    """Manifest + time-ordered events, loadable/saveable/canonical."""

    def __init__(self, manifest: TraceManifest,
                 events: list[TraceEvent]):
        self.manifest = manifest
        # stable sort: events at the same offset keep generation order,
        # so a sorted file round-trips bit-identically
        self.events = sorted(events, key=lambda e: e.at_s)

    # ---- serialization ---------------------------------------------------

    def to_lines(self) -> list[str]:
        return ([_canon(self.manifest.to_dict())]
                + [_canon(e.to_dict()) for e in self.events])

    def save(self, path: str) -> str:
        from kubernetes_tpu_torch.utils.atomicio import atomic_write
        atomic_write(path, "\n".join(self.to_lines()) + "\n")
        return path

    @classmethod
    def loads(cls, text: str) -> "Trace":
        lines = [ln for ln in text.splitlines() if ln.strip()]
        if not lines:
            raise TraceFormatError("empty trace file")
        try:
            head = json.loads(lines[0])
        except ValueError as e:
            raise TraceFormatError(f"manifest line is not JSON: {e}")
        manifest = TraceManifest.from_dict(head)
        events = []
        for i, ln in enumerate(lines[1:], start=2):
            try:
                events.append(TraceEvent.from_dict(json.loads(ln)))
            except TraceFormatError:
                raise
            except (ValueError, KeyError, TypeError) as e:
                raise TraceFormatError(f"bad event at line {i}: {e}")
        return cls(manifest, events)

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls.loads(f.read())

    def __eq__(self, other) -> bool:
        return (isinstance(other, Trace)
                and self.to_lines() == other.to_lines())

    # ---- derived views ---------------------------------------------------

    def duration_s(self) -> float:
        return self.events[-1].at_s if self.events else 0.0

    def phases(self) -> list[str]:
        """Phase labels in first-appearance order."""
        seen: dict = {}
        for e in self.events:
            seen.setdefault(e.phase or "default", None)
        return list(seen)

    def namespaces(self) -> list[str]:
        return sorted({e.ns for e in self.events if e.kind == "Pod"})

    def resident_pods(self) -> dict:
        """(ns, name) -> creating event, for pods created and never
        deleted by the trace — the set a replay gates 100% binding on."""
        live: dict = {}
        for e in self.events:
            if e.kind != "Pod":
                continue
            if e.verb == "create":
                live[(e.ns, e.name)] = e
            elif e.verb == "delete":
                live.pop((e.ns, e.name), None)
        return live

    def describe(self) -> dict:
        verbs: dict = {}
        phases: dict = {}
        for e in self.events:
            verbs[e.verb] = verbs.get(e.verb, 0) + 1
            ph = e.phase or "default"
            phases[ph] = phases.get(ph, 0) + 1
        return {"name": self.manifest.name,
                "version": TRACE_VERSION,
                "seed": self.manifest.seed,
                "description": self.manifest.description,
                "events": len(self.events),
                "duration_s": round(self.duration_s(), 3),
                "fleet_nodes": len(self.fleet_nodes()),
                "verbs": verbs, "phases": phases,
                "tenants": sorted({e.tenant for e in self.events
                                   if e.tenant}),
                "resident_pods": len(self.resident_pods()),
                "chaos": self.manifest.chaos,
                "sloGates": self.manifest.slo_gates}

    # ---- materialization -------------------------------------------------

    def _from_template(self, ref: str, kind: str, ns: str, name: str,
                       tenant: str) -> dict:
        tmpl = self.manifest.templates.get(ref)
        if tmpl is None:
            raise TraceFormatError(f"event references unknown template "
                                   f"{ref!r}")
        obj = copy.deepcopy(tmpl)
        md = obj.setdefault("metadata", {})
        md["name"] = name
        if kind == "Pod":
            md["namespace"] = ns
        elif kind == "Node":
            md.setdefault("labels", {})["kubernetes.io/hostname"] = name
        if tenant:
            md.setdefault("labels", {})[TENANT_LABEL] = tenant
        return obj

    def materialize(self, ev: TraceEvent) -> dict:
        """The full object dict an event creates/updates."""
        if ev.obj is not None:
            obj = copy.deepcopy(ev.obj)
            md = obj.setdefault("metadata", {})
            md.setdefault("name", ev.name)
            if ev.kind == "Pod":
                md.setdefault("namespace", ev.ns)
            return obj
        return self._from_template(ev.template or "pod", ev.kind,
                                   ev.ns, ev.name, ev.tenant)

    def fleet_nodes(self) -> list[dict]:
        """Node objects to seed before replay starts."""
        out: list[dict] = []
        for entry in self.manifest.fleet:
            if "obj" in entry:
                out.append(copy.deepcopy(entry["obj"]))
                continue
            ref = entry.get("template", "node")
            prefix = entry.get("prefix", "sn")
            for i in range(int(entry.get("count", 0))):
                out.append(self._from_template(
                    ref, "Node", "", f"{prefix}{i}",
                    entry.get("tenant", "")))
        return out

    def __iter__(self) -> Iterator[TraceEvent]:
        return iter(self.events)

    def __len__(self) -> int:
        return len(self.events)
