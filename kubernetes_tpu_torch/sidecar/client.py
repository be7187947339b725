"""Sidecar client — the external scheduler's side of the bridge.

Stands in for the Go shim the north star describes (an out-of-tree plugin
set delegating PreFilter/Filter/Score over gRPC behind a
``KubeSchedulerProfile``): it mirrors the scheduler's informer cache — a
local store of nodes + bound pods with a monotone generation counter (the
``cache.delta_info`` twin) — journals every change as a delta, and
reconciles on STALE rejects by re-pushing exactly the deltas the sidecar
missed before retrying. Assume-optimism is modeled the same way the
reference's scheduler cache does: ``observe_binding`` advances the local
generation BEFORE the sidecar hears about it, which is precisely the race
the generation token exists to catch.

The port's copy of ``kubernetes_tpu/sidecar/client.py``, on the port's
``sidecar/proto.py``: ``grpc`` is imported when a client is made and
``msgpack`` when a frame is packed, so the module imports without either.
It speaks the same wire protocol, to the port's server or the reference's.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from kubernetes_tpu_torch.sidecar import proto


class SidecarClient:
    def __init__(self, address: str, profile: Optional[dict] = None,
                 journal_limit: int = 65536):
        import grpc
        self._chan = grpc.insecure_channel(address)
        self._call = {
            m: self._chan.unary_unary(
                proto.method_path(m), request_serializer=proto.pack,
                response_deserializer=proto.unpack,
                _registered_method=False)
            for m in proto.METHODS
        }
        self._lock = threading.Lock()
        self._nodes: dict[str, dict] = {}
        self._pods: dict[str, dict] = {}
        self._gen = 0
        self._profile = profile
        # delta journal since the last successful push: [(gen, entry)];
        # bounded — overflow forces a full re-push (TooOld analog)
        self._journal: list[tuple[int, dict]] = []
        self._journal_limit = journal_limit
        self._pushed_gen: Optional[int] = None
        self.stale_retries = 0  # observability: how often the race fired

    # ---- local state (the informer-cache mirror) -------------------------

    @staticmethod
    def _pod_key(d: dict) -> str:
        md = d.get("metadata") or {}
        return f"{md.get('namespace', 'default')}/{md.get('name', '')}"

    def upsert_node(self, node: dict):
        with self._lock:
            self._nodes[(node.get("metadata") or {}).get("name", "")] = node
            self._bump({"op": "node_upsert", "node": node})

    def delete_node(self, name: str):
        with self._lock:
            self._nodes.pop(name, None)
            self._bump({"op": "node_delete", "name": name})

    def observe_binding(self, pod: dict):
        """A pod bound (by us or anyone): local gen advances NOW — the
        sidecar learns of it on the next push or stale-reject round-trip."""
        with self._lock:
            self._pods[self._pod_key(pod)] = pod
            self._bump({"op": "upsert", "pod": pod})

    def observe_delete(self, pod_key: str):
        with self._lock:
            self._pods.pop(pod_key, None)
            self._bump({"op": "delete", "key": pod_key})

    def _bump(self, entry: dict):
        self._gen += 1
        self._journal.append((self._gen, entry))
        if len(self._journal) > self._journal_limit:
            self._journal = []  # compacted away: next sync is a full push
            self._pushed_gen = None

    @property
    def generation(self) -> int:
        with self._lock:
            return self._gen

    # ---- sync ------------------------------------------------------------

    def push_snapshot(self):
        with self._lock:
            req = {"nodes": list(self._nodes.values()),
                   "pods": list(self._pods.values()),
                   "generation": self._gen}
            if self._profile is not None:
                req["profile"] = self._profile
        out = self._call["PushSnapshot"](req)
        with self._lock:
            self._pushed_gen = out["generation"]
            self._journal = [(g, e) for g, e in self._journal
                             if g > out["generation"]]
        return out["generation"]

    def _push_deltas(self, server_gen: int):
        """Re-push everything the sidecar missed (journal entries after
        ``server_gen``); full snapshot when the journal can't cover that
        range contiguously (never pushed, compacted, or unknown gen)."""
        with self._lock:
            pending = [(g, e) for g, e in self._journal if g > server_gen]
            # sound only when the journal contiguously covers
            # (server_gen, local_gen]
            can_delta = (server_gen >= 0
                         and len(pending) == self._gen - server_gen
                         and (not pending
                              or pending[0][0] == server_gen + 1))
            delta = None
            if can_delta and not pending:
                return  # already in sync
            if can_delta:
                # journal ORDER is preserved on the wire: a delete followed
                # by a same-key re-add must replay in sequence
                delta = {"base_generation": server_gen,
                         "generation": self._gen,
                         "ops": [e for _g, e in pending]}
        if delta is None:
            self.push_snapshot()
            return
        out = self._call["PushDelta"](delta)
        if out.get("stale"):
            self.push_snapshot()
            return
        with self._lock:
            self._pushed_gen = out["generation"]
            self._journal = [(g, e) for g, e in self._journal
                             if g > out["generation"]]

    # ---- scheduling verbs (retry-on-stale) -------------------------------

    def _stale_retry(self, method: str, req: dict, retries: int = 3) -> dict:
        for _ in range(retries):
            req["generation"] = self.generation
            out = self._call[method](req)
            if not out.get("stale"):
                return out
            self.stale_retries += 1
            self._push_deltas(int(out["server_generation"]))
        raise RuntimeError(f"{method}: still stale after {retries} syncs")

    def filter(self, pods: list[dict]) -> np.ndarray:
        out = self._stale_retry("Filter", {"pods": pods})
        P, N = out["pods"], out["nodes"]
        bits = np.unpackbits(np.frombuffer(out["mask"], np.uint8),
                             count=P * N)
        return bits.reshape(P, N).astype(bool)

    def score(self, pods: list[dict]) -> np.ndarray:
        out = self._stale_retry("Score", {"pods": pods})
        return np.frombuffer(out["scores"], np.float32).reshape(
            out["pods"], out["nodes"])

    def schedule(self, pods: list[dict]) -> list[str]:
        out = self._stale_retry("Schedule", {"pods": pods})
        return list(out["assignments"])

    def close(self):
        self._chan.close()
