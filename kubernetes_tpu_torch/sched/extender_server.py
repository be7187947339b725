"""Extender server — expose the tensor scheduler to a foreign control plane
via the scheduler-extender webhook protocol.

The PyTorch port of ``kubernetes_tpu/sched/extender_server.py``. The
reference's precedent is the other direction only (``extender.go`` calls
out); here the same wire shapes (``ExtenderArgs`` in,
``ExtenderFilterResult``/``HostPriorityList`` out —
``staging/src/k8s.io/kube-scheduler/extender/v1/types.go``) make the
filter/score pipeline consumable by ANY scheduler that supports extenders:
point a stock kube-scheduler's ``extenders:`` config at this server and its
pods are filtered/scored by the one-shot [1,N] ``evaluate`` on the card.

Cluster state: the caller either wires a clientset (nodes + bound pods are
listed per request) or pushes state via ``set_cluster`` (tests, embedding).
Each request is encoded by a private ``SnapshotEncoder``, as in the
reference. ``device``: where ``evaluate`` runs — the card unless the
caller asks for the CPU.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.device import resolve_device
from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
from kubernetes_tpu_torch.sched.extender import MAX_EXTENDER_PRIORITY


class TPUExtenderServer:
    def __init__(self, client=None, host: str = "127.0.0.1", port: int = 0,
                 device=None):
        self._client = client
        self.device = resolve_device(device)
        self._nodes: list[Node] = []
        self._bound: list[Pod] = []
        self._lock = threading.Lock()
        self._httpd = ThreadingHTTPServer((host, port), self._handler())
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    # -- state -------------------------------------------------------------

    def set_cluster(self, nodes: list[Node], bound_pods: list[Pod]) -> None:
        with self._lock:
            self._nodes = list(nodes)
            self._bound = list(bound_pods)

    def _cluster(self):
        if self._client is not None:
            nodes = [Node.from_dict(n) for n in self._client.nodes().list()]
            bound = [p for p in (Pod.from_dict(d)
                                 for d in self._client.pods(None).list())
                     if p.spec.node_name]
            return nodes, bound
        with self._lock:
            return list(self._nodes), list(self._bound)

    # -- the one-pod device program ---------------------------------------

    def _evaluate(self, pod: Pod, node_names: Optional[list[str]]):
        """-> (names, feasible [N] bool, scores [N] f32) over the requested
        node subset (None = every known node)."""
        from kubernetes_tpu_torch.models.schedule_step import evaluate
        nodes, bound = self._cluster()
        if node_names is not None:
            allow = set(node_names)
            nodes = [n for n in nodes if n.metadata.name in allow]
        names = [n.metadata.name for n in nodes]
        if not nodes:
            return [], np.zeros(0, bool), np.zeros(0, np.float32)
        enc = SnapshotEncoder()
        ct, meta = enc.encode_cluster(nodes, bound, pending_pods=[pod])
        pb = enc.encode_pods([pod], meta)
        res = evaluate(ct.to(self.device), pb.to(self.device),
                       topo_keys=meta.topo_keys)
        feas = res.feasible[0, :len(nodes)].cpu().numpy()
        scores = res.scores[0, :len(nodes)].cpu().numpy()
        return names, feas, scores

    @staticmethod
    def _parse_args(payload: dict):
        """-> (pod, node names | None, request node items | None).
        The response must mirror the request shape: nodeCacheCapable callers
        send/read ``nodenames``; everyone else (including a stock
        kube-scheduler with the default nodeCacheCapable=false) sends full
        node objects and reads ``nodes.items`` back."""
        pod = Pod.from_dict(payload.get("pod") or {})
        if payload.get("nodenames") is not None:
            return pod, list(payload["nodenames"]), None
        items = ((payload.get("nodes") or {}).get("items"))
        if items is not None:
            return pod, [(n.get("metadata") or {}).get("name", "")
                         for n in items], list(items)
        return pod, None, None

    def _filter(self, payload: dict) -> dict:
        pod, node_names, req_items = self._parse_args(payload)
        names, feas, _ = self._evaluate(pod, node_names)
        ok = {n for n, f in zip(names, feas) if f}
        # the reference's wording, so both servers answer alike
        failed = {n: "node is not feasible for pod (TPU filter pipeline)"
                  for n, f in zip(names, feas) if not f}
        if req_items is not None:  # mirror the full-objects request shape
            keep = [it for it in req_items
                    if (it.get("metadata") or {}).get("name", "") in ok]
            return {"nodes": {"items": keep}, "failedNodes": failed}
        return {"nodenames": [n for n in names if n in ok],
                "failedNodes": failed}

    def _prioritize(self, payload: dict) -> list:
        pod, node_names, _req_items = self._parse_args(payload)
        names, feas, scores = self._evaluate(pod, node_names)
        # rescale feasible scores to the extender's 0..10 contract
        vals = np.where(feas, scores, -np.inf)
        finite = vals[np.isfinite(vals)]
        out = []
        for n, v in zip(names, vals):
            if not np.isfinite(v):
                out.append({"host": n, "score": 0})
                continue
            if finite.size and finite.max() > finite.min():
                s = (v - finite.min()) / (finite.max() - finite.min())
            else:
                s = 1.0
            out.append({"host": n, "score": int(round(
                float(s) * MAX_EXTENDER_PRIORITY))})
        return out

    # -- http --------------------------------------------------------------

    def _handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, body) -> None:
                data = json.dumps(body).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                try:
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    if self.path.rstrip("/").endswith("filter"):
                        body = server._filter(payload)
                    elif self.path.rstrip("/").endswith("prioritize"):
                        body = server._prioritize(payload)
                    else:
                        self.send_error(404)
                        return
                except Exception as e:  # wire errors into the protocol shape
                    body = {"error": str(e)}
                self._reply(body)
        return Handler

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "TPUExtenderServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="tpu-extender")
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=2.0)
