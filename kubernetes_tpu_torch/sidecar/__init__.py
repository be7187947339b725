"""Scheduling sidecar: the gRPC bridge a reference-world scheduler delegates
to. It holds an encoded snapshot pushed ONCE and kept current by deltas, and
every scheduling batch is tagged with the pusher's snapshot generation —
stale generations are rejected."""

from kubernetes_tpu_torch.sidecar.server import SidecarServer

__all__ = ["SidecarServer"]
