"""Front-door replica subprocess — a raft node + apiserver pair that can
be SIGKILLed and reborn, plus in-process storm watchers driven over a
control pipe.

The WatchStorm bench needs ~10k concurrent watchers against a 3-node
front door on a single-core box. Ten thousand HTTP streams would measure
the bench harness, not the serving plane, so the storm watchers live
INSIDE each replica subprocess as plain ``store.watch()`` queues: the
replica's fan-out path does exactly the work a real stream fans into
(the per-watcher queue put IS the cost being measured), while the
control pipe attaches cohorts and collects per-watcher event signatures
(count / rv-sum / rv-xor / last-rv) for the gap-free gate. A modest
number of REAL HTTP watch streams (the bench's sentinel informers) ride
alongside through the spread client.

Same subprocess dialect as ``chaos/apiserver.py``'s ApiServerProcess:
spawn context, module-level entry fn, Pipe handshake with bound ports,
kill()/stop()/restart() with a stable (node_id, ports) identity — a
reborn replica comes back EMPTY and resyncs from the leader via the
raft snapshot path."""

from __future__ import annotations

import multiprocessing as mp
import time
import urllib.error
import urllib.request
from typing import Optional


def _serve_replica(conn, node_id: str, host: str, raft_port: int,
                   api_port: int, peers: dict, api_urls: dict) -> None:
    """Subprocess entry: serve one front-door node until told to stop,
    answering control commands over ``conn``. A SIGKILL of this process
    (no "stop" message) is the disaster the bench's heal leg exercises."""
    from kubernetes_tpu_torch.store.apiserver import APIServer
    from kubernetes_tpu_torch.store.replication import RaftNode, ReplicatedStore
    from kubernetes_tpu_torch.store.store import ERROR, ObjectStore, TooOld
    store = ObjectStore()
    node = RaftNode(node_id, store, peers, port=raft_port)
    api = APIServer(host=host, port=api_port,
                    store=ReplicatedStore(node))
    api.api_urls = dict(api_urls)
    api.start()
    conn.send({"api_port": api.port, "raft_port": node.port})
    cohorts: dict = {}  # cohort name -> list[Watcher]
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            break
        cmd = msg[0]
        if cmd == "stop":
            api.stop()
            node.stop()
            conn.send("stopped")
            break
        elif cmd == "status":
            conn.send(node.status())
        elif cmd == "wait_rv":
            # block (bounded) until replication has applied >= rv here
            target, timeout = msg[1], msg[2]
            deadline = time.monotonic() + timeout
            while store.snapshot_rv() < target \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
            conn.send(store.snapshot_rv() >= target)
        elif cmd == "attach":
            cohort, kind, n, since_rv = msg[1], msg[2], msg[3], msg[4]
            ws = []
            too_old = 0
            for _ in range(n):
                try:
                    ws.append(store.watch(kind, since_rv=since_rv))
                except TooOld:
                    too_old += 1
            cohorts.setdefault(cohort, []).extend(ws)
            conn.send({"attached": len(ws), "too_old": too_old})
        elif cmd == "collect":
            # drain every watcher in the cohort and histogram their event
            # signatures — gap-free means ONE signature covers them all
            sigs: dict = {}
            severed = 0
            for w in cohorts.pop(msg[1], []):
                count = rv_sum = rv_xor = last_rv = 0
                while True:
                    try:
                        ev = w._q.get_nowait()
                    except Exception:  # ktpu-lint: disable=KTL002 -- queue.Empty ends the drain; the queue is this process's own
                        break
                    if ev.type == ERROR:
                        severed += 1
                        break
                    count += 1
                    rv_sum += ev.resource_version
                    rv_xor ^= ev.resource_version
                    last_rv = ev.resource_version
                w.stop()
                key = (count, rv_sum, rv_xor, last_rv)
                sigs[key] = sigs.get(key, 0) + 1
            conn.send({"signatures": sigs, "severed": severed})
        elif cmd == "watch_stats":
            conn.send(store.watch_stats())
        elif cmd == "frontdoor":
            conn.send(api.frontdoor_status())
        else:
            conn.send({"error": f"unknown command {cmd!r}"})


class ReplicaProcess:
    """One front-door node in a subprocess, with a stable
    (node_id, raft_port, api_port) identity across kill/restart."""

    def __init__(self, node_id: str, raft_port: int, api_port: int,
                 peers: dict, api_urls: dict, host: str = "127.0.0.1"):
        self.node_id = node_id
        self.host = host
        self.raft_port = raft_port
        self.api_port = api_port
        self.peers = dict(peers)
        self.api_urls = dict(api_urls)
        self.url = f"http://{host}:{api_port}"
        self.restarts = 0
        self._ctx = mp.get_context("spawn")
        self._proc = None
        self._conn = None

    def start(self, ready_timeout: float = 120.0) -> "ReplicaProcess":
        if self._proc is not None and self._proc.is_alive():
            raise RuntimeError(f"replica {self.node_id} already running")
        parent, child = self._ctx.Pipe()
        self._proc = self._ctx.Process(
            target=_serve_replica,
            args=(child, self.node_id, self.host, self.raft_port,
                  self.api_port, self.peers, self.api_urls), daemon=True)
        self._proc.start()
        self._conn = parent
        if not parent.poll(ready_timeout):
            raise TimeoutError(
                f"replica {self.node_id} never bound its ports")
        bound = parent.recv()
        assert bound["api_port"] == self.api_port, bound
        return self

    def call(self, msg: tuple, timeout: float = 120.0):
        """Send one control command, block for its reply. The control
        conversation is strictly request/reply from a single orchestrator
        thread — no interleaving to guard against."""
        self._conn.send(msg)
        if not self._conn.poll(timeout):
            raise TimeoutError(
                f"replica {self.node_id}: no reply to {msg[0]!r} "
                f"within {timeout}s")
        return self._conn.recv()

    def wait_ready(self, timeout: float = 120.0) -> float:
        """Poll /readyz until 200 -> seconds waited (the replica gates
        readiness on replay lag, so this also bounds resync-to-fresh).
        Raises on timeout — a missing heal number must never read fast."""
        t0 = time.monotonic()
        deadline = t0 + timeout
        while time.monotonic() < deadline:
            try:
                with urllib.request.urlopen(self.url + "/readyz",
                                            timeout=2.0) as resp:
                    if resp.status == 200:
                        return time.monotonic() - t0
            except urllib.error.HTTPError:
                pass  # 503: stale or still restoring
            except OSError:
                pass  # refused: process still starting
            time.sleep(0.05)
        raise TimeoutError(f"replica {self.node_id}: /readyz not 200 "
                           f"within {timeout}s")

    @property
    def alive(self) -> bool:
        return self._proc is not None and self._proc.is_alive()

    def kill(self) -> None:
        """SIGKILL — watch streams die mid-event, the raft peer goes
        silent, and every in-process storm watcher evaporates."""
        if self._proc is not None:
            self._proc.kill()
            self._proc.join(timeout=10.0)

    def stop(self, timeout: float = 15.0) -> None:
        if self._proc is None:
            return
        if self._proc.is_alive():
            try:
                self._conn.send(("stop",))
                self._conn.poll(timeout)
            except (BrokenPipeError, OSError):
                pass
            self._proc.join(timeout=timeout)
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=5.0)

    def restart(self, ready_timeout: float = 120.0) -> float:
        """Kill (if alive) and rebirth EMPTY on the same identity — the
        leader detects the gap and snapshot-resyncs it. -> seconds from
        restart begin to /readyz 200."""
        self.kill()
        self._proc = None
        self.restarts += 1
        self.start(ready_timeout)
        return self.wait_ready(ready_timeout)
