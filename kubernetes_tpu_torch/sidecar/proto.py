"""Wire protocol for the scheduling sidecar — msgpack frames over gRPC.

The port's copy of ``kubernetes_tpu/sidecar/proto.py``; ``msgpack`` is
imported where a frame is packed, so the engine runs without it.

The reference negotiates protobuf on the wire; here every RPC payload is one
msgpack map (the same binary format the apiserver negotiates,
store/apiserver.py) so the protocol needs no generated code while remaining
a real gRPC/HTTP2 service a Go shim can speak with a three-line codec.

Service: ``ktpu.SchedSidecar``
  PushSnapshot  {nodes: [dict], pods: [dict], generation: int,
                 profile?: {fit_strategy, weights, enabled_filters}}
                -> {generation}
  PushDelta     {base_generation, generation, ops: [ORDERED entries:
                 {op: upsert, pod} | {op: delete, key} |
                 {op: node_upsert, node} | {op: node_delete, name}]}
                -> {generation} | STALE
                (order is semantic — delete-then-re-add of one key must
                 replay in sequence, like a watch stream)
  Filter        {pods: [dict], generation}
                -> {mask: packed bits, pods: P, nodes: N} | STALE
  Score         {pods: [dict], generation}
                -> {scores: f32 bytes, pods: P, nodes: N} | STALE
  Schedule      {pods: [dict], generation}
                -> {assignments: [node name | ""], rounds} | STALE
  Session       bidi stream of the above, tagged {kind, seq, ...body}; one
                response frame per request frame, same seq.

STALE responses are ``{stale: true, server_generation: int}`` — the caller
owns newer (or older) state than the sidecar; it must reconcile via
PushDelta/PushSnapshot and retry. This is the snapshot-generation staleness
token SURVEY §7's sidecar design calls for: the Go scheduler's assume
optimism (``AssumePod``) advances its cache generation before bindings
commit, and the sidecar must never answer from state the client has moved
past.
"""

from __future__ import annotations

SERVICE = "ktpu.SchedSidecar"
METHODS = ("PushSnapshot", "PushDelta", "Filter", "Score", "Schedule")
STREAM_METHOD = "Session"


def pack(obj: dict) -> bytes:
    import msgpack
    return msgpack.packb(obj)


def unpack(data: bytes) -> dict:
    import msgpack
    return msgpack.unpackb(data)


def stale(server_generation: int) -> dict:
    return {"stale": True, "server_generation": server_generation}

