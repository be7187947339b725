"""Sidecar server — the scheduling engine behind a gRPC service.

The PyTorch port of ``kubernetes_tpu/sidecar/server.py``. Reference shape
being replaced: ``pkg/scheduler/extender.go`` sends the full candidate node
list with EVERY HTTP request and gets names back. Here the cluster lives
beside the device: one PushSnapshot, then deltas, and each
Filter/Score/Schedule batch runs over the resident encoding
(encode/snapshot.py + ops/ + models/gang.py).

``_Engine.dispatch`` answers one request without any server, so a caller
can drive the engine in process; ``SidecarServer`` exports it over gRPC.
The engine runs on the card: ``device=None`` means CUDA and raises where
there is none, and the CPU is used only when asked for (``device="cpu"``).

Generation discipline: the CLIENT owns the generation counter (its informer
cache's delta generation). The engine only ever answers batches tagged with
exactly its applied generation; anything else is a STALE reject carrying
the server's generation so the client knows which deltas to re-push.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent import futures
from typing import Optional

import numpy as np

from kubernetes_tpu_torch.device import resolve_device
from kubernetes_tpu_torch.sidecar import proto

_LOG = logging.getLogger(__name__)


class StaleGeneration(Exception):
    def __init__(self, server_gen: int):
        super().__init__(f"stale generation (server at {server_gen})")
        self.server_gen = server_gen


class _Engine:
    """Snapshot + deltas -> encoded cluster on the device; batches -> the
    scheduling pipeline. ``last_timings`` holds the host-clock encode and
    device milliseconds of the last Filter/Score/Schedule."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._nodes: dict[str, dict] = {}
        self._pods: dict[str, dict] = {}
        self._gen: Optional[int] = None
        self._profile: dict = {}
        self._encoder = None
        self._encoded = None  # (gen, nodes list, ct on device, meta)
        self.last_timings: dict[str, float] = {}

    @staticmethod
    def _pod_key(d: dict) -> str:
        md = d.get("metadata") or {}
        return f"{md.get('namespace', 'default')}/{md.get('name', '')}"

    def snapshot(self, nodes: list[dict], pods: list[dict], gen: int,
                 profile: Optional[dict] = None):
        with self._lock:
            self._nodes = {(n.get("metadata") or {}).get("name", ""): n
                           for n in nodes}
            self._pods = {self._pod_key(p): p for p in pods
                          if (p.get("spec") or {}).get("nodeName")}
            self._gen = gen
            if profile is not None:
                self._profile = dict(profile)
            self._encoded = None
            return self._gen

    def delta(self, base_gen: int, gen: int, ops: list[dict]) -> int:
        """Apply an ORDERED op list. Order is semantic: a delete followed by
        a re-add of the same key must leave the object live — flattened
        per-kind lists would lose it (the watch-stream property informers
        rely on: events apply in sequence)."""
        with self._lock:
            if self._gen is None or base_gen != self._gen:
                raise StaleGeneration(-1 if self._gen is None else self._gen)
            for entry in ops:
                op = entry.get("op", "")
                if op == "upsert":
                    p = entry["pod"]
                    k = self._pod_key(p)
                    if (p.get("spec") or {}).get("nodeName"):
                        self._pods[k] = p
                    else:
                        self._pods.pop(k, None)
                elif op == "delete":
                    self._pods.pop(entry["key"], None)
                elif op == "node_upsert":
                    n = entry["node"]
                    self._nodes[(n.get("metadata") or {}).get("name", "")] = n
                elif op == "node_delete":
                    self._nodes.pop(entry["name"], None)
            self._gen = gen
            self._encoded = None
            return self._gen

    def _require(self, gen: int):
        if self._gen is None or gen != self._gen:
            raise StaleGeneration(-1 if self._gen is None else self._gen)

    def _encoded_cluster(self, pending: list):
        """Encoded cluster at the current generation, on the device (cached
        across batches at the same generation). A batch demanding a
        resource outside the cached axis forces a re-encode (the encoder
        zeroes unknown resources, which would silently admit the pod
        anywhere)."""
        from kubernetes_tpu_torch.api.types import Node, Pod
        from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
        if self._encoder is None:
            self._encoder = SnapshotEncoder()
        enc = self._encoded
        if enc is not None and enc[0] == self._gen:
            _, nodes, ct, meta = enc
            known = set(meta.resources)
            if not any(r not in known for p in pending
                       for r in p.resource_requests()):
                return nodes, ct, meta
        nodes = [Node.from_dict(d) for d in self._nodes.values()]
        bound = [Pod.from_dict(d) for d in self._pods.values()]
        ct, meta = self._encoder.encode_cluster(nodes, bound,
                                               pending_pods=pending)
        ct = ct.to(self.device)
        self._encoded = (self._gen, nodes, ct, meta)
        return nodes, ct, meta

    def _batch(self, pod_dicts: list[dict], gen: int):
        from kubernetes_tpu_torch.api.types import Pod
        t0 = time.perf_counter()
        self._require(gen)
        pods = [Pod.from_dict(d) for d in pod_dicts]
        nodes, ct, meta = self._encoded_cluster(pods)
        pb = self._encoder.encode_pods(pods, meta).to(self.device)
        self.last_timings = {"encode_ms": (time.perf_counter() - t0) * 1e3}
        return pods, nodes, ct, meta, pb

    def _timed(self, t0: float) -> None:
        self.last_timings["device_ms"] = (time.perf_counter() - t0) * 1e3

    def filter(self, pod_dicts: list[dict], gen: int) -> dict:
        from kubernetes_tpu_torch.ops.filters import run_filters
        with self._lock:
            pods, nodes, ct, meta, pb = self._batch(pod_dicts, gen)
            t0 = time.perf_counter()
            mask = run_filters(ct, pb, enabled=self._enabled()).cpu().numpy()
            self._timed(t0)
            m = mask[:len(pods), :len(nodes)]
            return {"mask": np.packbits(m, axis=None).tobytes(),
                    "pods": len(pods), "nodes": len(nodes)}

    def score(self, pod_dicts: list[dict], gen: int) -> dict:
        from kubernetes_tpu_torch.ops.filters import run_filters
        from kubernetes_tpu_torch.ops.scores import combined_score
        with self._lock:
            pods, nodes, ct, meta, pb = self._batch(pod_dicts, gen)
            t0 = time.perf_counter()
            mask = run_filters(ct, pb, enabled=self._enabled())
            scores = combined_score(
                ct, pb, mask, weights=self._weights(),
                fit_strategy=self._profile.get("fit_strategy",
                                               "LeastAllocated")).cpu().numpy()
            self._timed(t0)
            s = scores[:len(pods), :len(nodes)].astype(np.float32)
            return {"scores": s.tobytes(), "pods": len(pods),
                    "nodes": len(nodes)}

    def schedule(self, pod_dicts: list[dict], gen: int) -> dict:
        from kubernetes_tpu_torch.models.gang import gang_schedule
        with self._lock:
            pods, nodes, ct, meta, pb = self._batch(pod_dicts, gen)
            t0 = time.perf_counter()
            assignment, rounds = gang_schedule(
                ct, pb, seed=0,
                fit_strategy=self._profile.get("fit_strategy",
                                               "LeastAllocated"),
                topo_keys=meta.topo_keys,
                weights=self._weights(),
                enabled_filters=self._enabled())
            self._timed(t0)
            out = []
            for i in range(len(pods)):
                a = int(assignment[i])
                out.append(meta.node_names[a] if a >= 0 else "")
            return {"assignments": out, "rounds": int(rounds)}

    def _enabled(self):
        ef = self._profile.get("enabled_filters")
        return tuple(ef) if ef else None

    def _weights(self):
        w = self._profile.get("weights")
        return dict(w) if w else None

    def dispatch(self, method: str, req: dict) -> dict:
        """Answer one request frame. Engine errors come back as
        ``{"error": ...}`` frames, stale generations as STALE frames."""
        try:
            if method == "PushSnapshot":
                gen = self.snapshot(req.get("nodes", []), req.get("pods", []),
                                    int(req["generation"]),
                                    profile=req.get("profile"))
                return {"generation": gen}
            if method == "PushDelta":
                gen = self.delta(int(req["base_generation"]),
                                 int(req["generation"]),
                                 req.get("ops", []))
                return {"generation": gen}
            if method == "Filter":
                return self.filter(req.get("pods", []),
                                   int(req["generation"]))
            if method == "Score":
                return self.score(req.get("pods", []), int(req["generation"]))
            if method == "Schedule":
                return self.schedule(req.get("pods", []),
                                     int(req["generation"]))
            return {"error": f"unknown method {method!r}"}
        except StaleGeneration as e:
            return proto.stale(e.server_gen)
        except Exception as e:  # engine errors surface as frames, not aborts
            _LOG.exception("sidecar %s failed", method)
            return {"error": str(e)}


class SidecarServer:
    """gRPC server exporting the engine. ``start()`` binds and serves;
    unary methods + the ``Session`` bidi stream share one engine."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 max_workers: int = 8, device=None):
        import grpc
        self.engine = _Engine(device)
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers))
        self._server.add_generic_rpc_handlers((self._handler(),))
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        self.address = f"{host}:{self.port}"

    def _handler(self):
        import grpc
        engine = self.engine

        def unary(method):
            def call(req: dict, ctx) -> dict:
                return engine.dispatch(method, req)
            return grpc.unary_unary_rpc_method_handler(
                call, request_deserializer=proto.unpack,
                response_serializer=proto.pack)

        def session(request_iterator, ctx):
            for frame in request_iterator:
                kind = frame.get("kind", "")
                resp = engine.dispatch(kind, frame)
                resp["seq"] = frame.get("seq", 0)
                resp["kind"] = kind
                yield resp

        handlers = {m: unary(m) for m in proto.METHODS}
        handlers[proto.STREAM_METHOD] = grpc.stream_stream_rpc_method_handler(
            session, request_deserializer=proto.unpack,
            response_serializer=proto.pack)
        return grpc.method_handlers_generic_handler(proto.SERVICE, handlers)

    # ---- lifecycle -------------------------------------------------------

    def start(self) -> "SidecarServer":
        self._server.start()
        return self

    def stop(self, grace: float = 1.0):
        self._server.stop(grace).wait()
