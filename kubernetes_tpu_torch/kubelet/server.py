"""Kubelet API server — the node-local HTTP surface the apiserver proxies.

Reference: ``pkg/kubelet/server/server.go``: every kubelet serves
``/containerLogs/<ns>/<pod>/<container>``, ``/exec/...``,
``/portForward/...`` (SPDY/WebSocket upstream; plain HTTP + an
``Upgrade: tcp`` socket hijack here) plus ``/metrics`` and ``/healthz``.
kubectl never talks to it directly: the apiserver's pod ``log``/``exec``/
``portForward`` subresources proxy through the node's
``status.daemonEndpoints.kubeletEndpoint`` — wired the same way in
store/apiserver.py.

Port-forward is REAL byte plumbing: the hollow runtime runs a tiny echo
server per sandbox (the "application" in the container), and
``/portForward`` splices the hijacked client socket onto it, exactly the
stream shape kubectl port-forward expects end to end.
"""

from __future__ import annotations

import json
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


class _ContainerApp:
    """The process inside the hollow container for port-forward targets: a
    loopback TCP echo server prefixed with the pod identity."""

    def __init__(self, pod_uid: str):
        self.pod_uid = pod_uid
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(8)
        self.port = self._srv.getsockname()[1]
        self._stop = False
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while not self._stop:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_one, args=(conn,),
                             daemon=True).start()

    def _serve_one(self, conn: socket.socket):
        with conn:
            conn.sendall(f"pod {self.pod_uid[:8]} ready\n".encode())
            while True:
                data = conn.recv(4096)
                if not data:
                    return
                conn.sendall(b"echo: " + data)

    def close(self):
        self._stop = True
        try:
            self._srv.close()
        except OSError:
            pass


class KubeletServer:
    """Serves the kubelet API for one kubelet. ``uid_of(ns, pod)`` resolves
    names to runtime sandbox uids (the kubelet's pod manager plays this
    role upstream)."""

    def __init__(self, runtime, uid_of, node_name: str = ""):
        self.runtime = runtime
        self.uid_of = uid_of
        self.node_name = node_name
        self._apps: dict[str, _ContainerApp] = {}
        self._lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _send(self, code: int, body: bytes,
                      ctype: str = "text/plain"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                parts = [p for p in self.path.split("?")[0].split("/") if p]
                if parts[:1] == ["healthz"]:
                    return self._send(200, b"ok")
                if parts[:1] == ["metrics"]:
                    # the kubelet's Prometheus endpoint (upstream serves
                    # cadvisor + kubelet metrics here); the process-global
                    # registry carries this node's counters
                    from kubernetes_tpu_torch.metrics.registry import REGISTRY
                    return self._send(200, REGISTRY.expose_text().encode())
                if parts[:1] == ["containerLogs"] and len(parts) == 4:
                    _, ns, pod, ctr = parts
                    uid = outer.uid_of(ns, pod)
                    if uid is None:
                        return self._send(404, b"pod not found")
                    lines = outer.runtime.logs(uid, ctr)
                    return self._send(200, ("\n".join(lines) + "\n").encode()
                                      if lines else b"")
                return self._send(404, b"not found")

            def do_POST(self):
                parts = [p for p in self.path.split("?")[0].split("/") if p]
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b"{}"
                if parts[:1] == ["exec"] and len(parts) == 4:
                    _, ns, pod, ctr = parts
                    uid = outer.uid_of(ns, pod)
                    if uid is None:
                        return self._send(404, b"pod not found")
                    try:
                        command = json.loads(body).get("command") or []
                    except json.JSONDecodeError:
                        return self._send(400, b"bad request")
                    code, out_text = outer.runtime.exec(uid, ctr, command)
                    return self._send(
                        200, json.dumps({"exit_code": code,
                                         "output": out_text}).encode(),
                        "application/json")
                if parts[:1] == ["portForward"] and len(parts) == 3:
                    _, ns, pod = parts
                    uid = outer.uid_of(ns, pod)
                    if uid is None:
                        return self._send(404, b"pod not found")
                    app = outer._app_for(uid)
                    # hijack: acknowledge the upgrade, then splice raw bytes
                    # between the client socket and the container app
                    self.send_response(101)
                    self.send_header("Upgrade", "tcp")
                    self.send_header("Connection", "Upgrade")
                    self.end_headers()
                    self.wfile.flush()
                    _splice(self.connection, ("127.0.0.1", app.port))
                    self.close_connection = True
                    return None
                return self._send(404, b"not found")

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()

    def _app_for(self, uid: str) -> _ContainerApp:
        with self._lock:
            app = self._apps.get(uid)
            if app is None:
                app = self._apps[uid] = _ContainerApp(uid)
            return app

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        with self._lock:
            for app in self._apps.values():
                app.close()
            self._apps.clear()


def connect_upgrade(addr: tuple, path: str, extra_headers: str = ""):
    """Dial ``addr``, send the Upgrade: tcp POST for ``path``, consume the
    101 header block. Returns ``(socket, leftover_bytes)``; raises OSError
    (with the socket closed) when the peer is unreachable or refuses — so
    callers can report BEFORE committing their own side of the upgrade."""
    upstream = socket.create_connection(addr, timeout=10.0)
    try:
        upstream.sendall((f"POST {path} HTTP/1.1\r\n"
                          f"Host: {addr[0]}\r\n"
                          f"{extra_headers}"
                          "Upgrade: tcp\r\nConnection: Upgrade\r\n"
                          "Content-Length: 0\r\n\r\n").encode())
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = upstream.recv(1024)
            if not chunk:
                raise OSError("peer closed during upgrade")
            buf += chunk
        if b" 101 " not in buf.split(b"\r\n", 1)[0]:
            raise OSError("upgrade refused")
    except OSError:
        try:
            upstream.close()
        except OSError:
            pass
        raise
    return upstream, buf.split(b"\r\n\r\n", 1)[1]


def splice_upgraded(client_sock: socket.socket, upstream: socket.socket,
                    leftover: bytes) -> bool:
    """Forward any post-handshake bytes, then splice; both sockets are
    closed on any failure. The second half shared by upgrade_and_splice
    and the apiserver's proxy (which dials via connect_upgrade first so
    unreachable kubelets surface as 502)."""
    try:
        if leftover:
            client_sock.sendall(leftover)
        _splice_sockets(client_sock, upstream)
    except OSError:
        for sk in (client_sock, upstream):
            try:
                sk.close()
            except OSError:
                pass
        return False
    return True


def upgrade_and_splice(client_sock: socket.socket, addr: tuple, path: str,
                       extra_headers: str = "") -> bool:
    """connect_upgrade + splice_upgraded: the whole client leg in one call
    (the ktpu CLI's path)."""
    try:
        upstream, leftover = connect_upgrade(addr, path, extra_headers)
    except OSError:
        try:
            client_sock.close()
        except OSError:
            pass
        return False
    return splice_upgraded(client_sock, upstream, leftover)


def _splice(client_sock: socket.socket, target: tuple) -> None:
    """Connect to the container app, then pump (see _splice_sockets)."""
    try:
        upstream = socket.create_connection(target, timeout=5.0)
    except OSError:
        try:
            client_sock.close()
        except OSError:
            pass
        return
    _splice_sockets(client_sock, upstream)


def _splice_sockets(a: socket.socket, b: socket.socket) -> None:
    """Bidirectional byte pump between two live sockets — the data plane of
    port-forward (also used by the apiserver's proxy leg)."""
    def pump(src: socket.socket, dst: socket.socket):
        try:
            while True:
                data = src.recv(4096)
                if not data:
                    break
                dst.sendall(data)
        except OSError:
            pass
        finally:
            for s in (src, dst):
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

    t = threading.Thread(target=pump, args=(b, a), daemon=True)
    t.start()
    pump(a, b)
    t.join(timeout=5.0)
    for s in (a, b):
        try:
            s.close()
        except OSError:
            pass
