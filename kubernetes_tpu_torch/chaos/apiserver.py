"""Apiserver kill/restart chaos — the control plane dies mid-flight.

``chaos/api.py`` injects faults into every seam AROUND the apiserver;
this module kills the apiserver itself. Two orchestrators share one
contract — the restarted server re-serves from the same ``data_dir`` (WAL
+ snapshot replay, ``store.py``) on the SAME port, so every client's base
URL stays valid and reconnection is pure retry/relist discipline:

  ApiServerProcess   a real subprocess (the ScaleFleet ``_serve`` pattern,
                     durable + fixed-port): ``kill()`` SIGKILLs it —
                     in-flight WAL appends tear exactly like a box losing
                     power — ``stop()`` shuts it down gracefully, and
                     ``restart()`` brings a fresh process up on the same
                     port/data_dir with ``/readyz`` 503 until replay
                     completes. The DisasterChurn bench drives this one.

  InProcessApiServer the tier-1 variant: stop/start an in-process
                     APIServer across the same data_dir/port without
                     subprocess spawn cost. ``stop(graceful=False)``
                     severs sockets and skips the store's clean close —
                     as kill-like as one process can be to itself.

Port stability matters: a restarted server on a NEW port would be a
different cluster to every HTTPClient; on the same port, clients see
refused connections (their backoff's job) and then the same apiserver
with the same state (minus any torn tail)."""

from __future__ import annotations

import multiprocessing as mp
import socket
import time
import urllib.error
import urllib.request
from typing import Optional


def free_port(host: str = "127.0.0.1") -> int:
    """A currently-free TCP port. Small bind race window — acceptable for
    local orchestration (the server binds with SO_REUSEADDR moments
    later, and a collision surfaces loudly at start())."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def _serve_durable(conn, host: str, port: int, data_dir: str) -> None:
    """Subprocess entry: durable apiserver with async WAL replay (readyz
    gates on it) until told to stop. Anything but a graceful "stop"
    message (including a SIGKILL of this process) leaves the data_dir
    exactly as the crash left it."""
    from kubernetes_tpu_torch.store.apiserver import APIServer
    server = APIServer(host=host, port=port, data_dir=data_dir,
                       async_restore=True).start()
    conn.send(server.port)
    conn.recv()  # any message = graceful stop
    server.stop()
    conn.send("stopped")


class ApiServerProcess:
    """Subprocess apiserver with a stable (host, port, data_dir) identity
    across kill/restart cycles."""

    def __init__(self, data_dir: str, host: str = "127.0.0.1",
                 port: Optional[int] = None):
        self.data_dir = data_dir
        self.host = host
        self.port = port or free_port(host)
        self.url = f"http://{host}:{self.port}"
        self.restarts = 0
        self._ctx = mp.get_context("spawn")
        self._proc = None
        self._conn = None

    def start(self, ready_timeout: float = 60.0) -> "ApiServerProcess":
        if self._proc is not None and self._proc.is_alive():
            raise RuntimeError("apiserver process already running")
        parent, child = self._ctx.Pipe()
        self._proc = self._ctx.Process(
            target=_serve_durable,
            args=(child, self.host, self.port, self.data_dir), daemon=True)
        self._proc.start()
        self._conn = parent
        if not parent.poll(ready_timeout):
            raise TimeoutError("apiserver subprocess never bound its port")
        bound = parent.recv()
        assert bound == self.port, f"bound {bound}, wanted {self.port}"
        return self

    def wait_ready(self, timeout: float = 60.0) -> float:
        """Poll /readyz until 200 -> seconds waited. Raises on timeout:
        a server that never finishes WAL replay is a failed restart, and
        a missing readiness number must never read as a fast one."""
        t0 = time.monotonic()
        deadline = t0 + timeout
        while time.monotonic() < deadline:
            try:
                with urllib.request.urlopen(self.url + "/readyz",
                                            timeout=2.0) as resp:
                    if resp.status == 200:
                        return time.monotonic() - t0
            except urllib.error.HTTPError:
                pass  # 503: replay in progress
            except OSError:
                pass  # refused: process still starting
            time.sleep(0.05)
        raise TimeoutError(f"/readyz not 200 within {timeout}s")

    @property
    def alive(self) -> bool:
        return self._proc is not None and self._proc.is_alive()

    def kill(self) -> None:
        """SIGKILL — no WAL close, no snapshot fold, sockets die
        mid-conversation. The crash the WAL exists for."""
        if self._proc is not None:
            self._proc.kill()
            self._proc.join(timeout=10.0)

    def stop(self, timeout: float = 10.0) -> None:
        """Graceful: the server closes its store (WAL flushed) first."""
        if self._proc is None:
            return
        if self._proc.is_alive():
            try:
                self._conn.send("stop")
                self._conn.poll(timeout)
            except (BrokenPipeError, OSError):
                pass
            self._proc.join(timeout=timeout)
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=5.0)

    def restart(self, ready_timeout: float = 60.0,
                graceful: bool = False) -> float:
        """Bounce the server (default: SIGKILL) and bring a fresh process
        up from the same data_dir on the same port -> seconds from
        restart begin to /readyz 200."""
        if graceful:
            self.stop()
        else:
            self.kill()
        self._proc = None
        self.restarts += 1
        self.start(ready_timeout)
        return self.wait_ready(ready_timeout)


class InProcessApiServer:
    """Tier-1 stop/start: the same data_dir served across restarts on a
    stable port, no subprocess. SO_REUSEADDR (http.server default) lets
    the successor bind the port the predecessor just released."""

    def __init__(self, data_dir: str, host: str = "127.0.0.1",
                 port: Optional[int] = None):
        self.data_dir = data_dir
        self.host = host
        self.port = port or free_port(host)
        self.url = f"http://{host}:{self.port}"
        self.server = None
        self.restarts = 0

    def start(self, async_restore: bool = False):
        from kubernetes_tpu_torch.store.apiserver import APIServer
        if self.server is not None:
            raise RuntimeError("in-process apiserver already running")
        self.server = APIServer(host=self.host, port=self.port,
                                data_dir=self.data_dir,
                                async_restore=async_restore).start()
        return self.server

    def stop(self, graceful: bool = True) -> None:
        """``graceful=False`` severs sockets and abandons the store
        WITHOUT closing the WAL cleanly — the closest one process gets to
        SIGKILLing itself (line-buffered appends are already on disk, so
        committed records survive exactly as they would a real kill)."""
        srv = self.server
        if srv is None:
            return
        self.server = None
        if graceful:
            srv.stop()
            return
        srv._stopping.set()
        if srv._thread is not None:
            srv._httpd.shutdown()
        srv._httpd.close_all_connections()
        srv._httpd.server_close()
        # deliberately NOT srv.store.close(): a killed process never
        # flushes; the dangling file object is garbage-collected

    def restart(self, graceful: bool = False, async_restore: bool = False):
        """Stop (kill-like by default) and re-serve the same data_dir on
        the same port -> the new APIServer."""
        self.stop(graceful=graceful)
        self.restarts += 1
        return self.start(async_restore=async_restore)
