"""Replicated store — raft-shaped quorum replication for the control plane.

Reference role: etcd. The reference's apiserver is a CLIENT of a raft
quorum (``apiserver/pkg/storage/etcd3`` over etcd's raft log); this module
gives the in-process ObjectStore the same availability story: a static
peer group where every journaled mutation replicates to a quorum before
the write returns, followers apply entries in log order (rv IS the log
index), heartbeat loss triggers a term-based leader election won by the
most up-to-date peer, and a diverged or lagging replica resyncs from the
leader's snapshot.

Simplifications vs raft, stated plainly:
- The leader applies locally BEFORE quorum ack (semi-synchronous): a
  leader that dies after applying but before replicating can briefly have
  served reads of an entry the new term never commits; the rejoining
  ex-leader detects the divergence and full-resyncs from the new leader.
  (etcd serves linearizable reads through the quorum; this trades that
  corner for zero changes to the hot write path.)
- Divergence is found by raft's log-matching check: every entry carries
  the term it was written in, and a follower whose entry at an rv the
  leader sends has another term answers ``resync`` (a snapshot install).
  A count of rvs alone would miss an ex-leader's uncommitted suffix that
  a new term's log of equal or greater length covers.
- Membership is static (the peer list); no joint consensus.
- The in-memory replication window is bounded; peers beyond it catch up
  by snapshot, like raft's InstallSnapshot.
- A write on the leader kicks the ticker, which replicates at once (raft
  sends AppendEntries on a new entry); a writer waits one round trip for
  its quorum, not up to a heartbeat period.

Transport is JSON over HTTP on a dedicated port per node — the analog of
etcd's peer protocol.
"""

from __future__ import annotations

import bisect
import json
import logging
import random
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from kubernetes_tpu_torch.store.store import ObjectStore

_LOG = logging.getLogger(__name__)

HEARTBEAT_S = 0.15
ELECTION_MIN_S, ELECTION_MAX_S = 0.6, 1.2
WINDOW = 10_000  # replication log window; beyond it -> snapshot resync


class NotLeader(Exception):
    def __init__(self, leader_hint: Optional[str]):
        super().__init__(f"not the leader (try {leader_hint})")
        self.leader_hint = leader_hint


class QuorumLost(Exception):
    """The write could not reach a quorum within the timeout."""


class RaftNode:
    """One member of the replication group, wrapping one ObjectStore.

    ``peers``: node_id -> base URL of every OTHER member. The wrapped
    store's journal feeds the replication log; use ``store`` for reads on
    any node and route mutations through the leader (``ensure_leader`` /
    ``wait_commit`` — or APIServer-level routing)."""

    def __init__(self, node_id: str, store: ObjectStore,
                 peers: dict[str, str], host: str = "127.0.0.1",
                 port: int = 0):
        self.node_id = node_id
        self.store = store
        self.peers = dict(peers)
        self.quorum = (len(peers) + 1) // 2 + 1
        self._lock = threading.Condition()
        self.term = 0
        self.voted_for: Optional[str] = None
        self.role = "follower"
        self.leader_id: Optional[str] = None
        self._last_heartbeat = time.monotonic()
        # replication log: rv-ordered journaled entries with their term
        self._log: list[tuple[int, dict]] = []
        self._log_base = store.snapshot_rv()
        # rv mirror maintained under the RAFT lock only: _on_journal fires
        # under the STORE lock and other raft paths hold the raft lock —
        # calling back into the store from under the raft lock would be an
        # ABBA deadlock
        self._rv_cache = self._log_base
        self._match: dict[str, int] = {p: 0 for p in peers}
        self.commit_rv = 0
        # Last instant this node confirmed it had applied everything up to
        # the leader's commit index (append handler, raft-lock domain).
        # replica_lag() = now - this; the replica /readyz gates on it.
        # None until the FIRST confirmation: a node born empty is
        # infinitely stale, not fresh — it must not serve reads before
        # replication has ever spoken to it.
        self._caught_up_mono: Optional[float] = None
        self._stop = threading.Event()
        # set by a write on the leader: the ticker replicates at once
        # instead of at its next heartbeat
        self._kick = threading.Event()
        store.subscribe_journal(self._on_journal)

        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _send(self, code: int, obj: dict):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                req = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/raft/append":
                    return self._send(200, outer._handle_append(req))
                if self.path == "/raft/vote":
                    return self._send(200, outer._handle_vote(req))
                return self._send(404, {})

            def do_GET(self):
                if self.path == "/raft/status":
                    return self._send(200, outer.status())
                if self.path == "/raft/snapshot":
                    return self._send(200, outer.store.snapshot_blob())
                return self._send(404, {})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self.url = f"http://{host}:{self.port}"
        self._threads = [
            threading.Thread(target=self._httpd.serve_forever, daemon=True),
            threading.Thread(target=self._ticker, daemon=True),
        ]
        for t in self._threads:
            t.start()

    # ---- public ----------------------------------------------------------

    def status(self) -> dict:
        with self._lock:
            return {"node": self.node_id, "term": self.term,
                    "role": self.role, "leader": self.leader_id,
                    "rv": self._last_rv(), "commit_rv": self.commit_rv}

    def is_leader(self) -> bool:
        with self._lock:
            return self.role == "leader"

    def ensure_leader(self) -> None:
        with self._lock:
            if self.role != "leader":
                raise NotLeader(self.leader_id and
                                self.peers.get(self.leader_id))

    def replica_lag(self) -> float:
        """Replay staleness bound: seconds since this node last confirmed
        it was applied up to the leader's commit index. 0.0 on the leader
        (it IS the commit frontier). Grows without bound while the leader
        is unreachable or replay falls behind — a read replica's /readyz
        gates on this staying under its staleness budget, which is what
        makes \"bounded staleness\" a contract instead of a hope."""
        with self._lock:
            if self.role == "leader":
                return 0.0
            if self._caught_up_mono is None:
                return float("inf")
            return max(0.0, time.monotonic() - self._caught_up_mono)

    def wait_commit(self, rv: int, timeout: float = 5.0) -> None:
        """Block until ``rv`` is quorum-replicated (call after a mutation
        on the leader's store). Raises QuorumLost on timeout — the entry
        is applied locally but its durability is NOT established."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while self.commit_rv < rv:
                if self.role != "leader":
                    raise NotLeader(self.leader_id and
                                    self.peers.get(self.leader_id))
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise QuorumLost(f"rv {rv} not committed in time")
                self._lock.wait(min(remaining, 0.05))

    def kick(self) -> None:
        """Replicate now: a writer waiting for its quorum need not wait for
        the next heartbeat (raft sends AppendEntries on a new entry)."""
        self._kick.set()

    def stop(self):
        self._stop.set()
        self._kick.set()
        self._httpd.shutdown()
        self._httpd.server_close()

    # ---- journal tap (leader write path) ---------------------------------

    def _on_journal(self, entry: dict):
        # fires under the STORE lock: O(1) append only. A replicated entry
        # carries the term it was written in; a local write is this term's.
        with self._lock:
            self._log.append((int(entry.get("term", self.term)), entry))
            self._rv_cache = int(entry["rv"])
            if len(self._log) > WINDOW:
                del self._log[:WINDOW // 2]
                self._log_base = int(self._log[0][1]["rv"]) - 1
            if self.role == "leader":
                # the leader's own append counts toward its quorum: a
                # single-node group commits here, having no peer to ack
                self._advance_commit_locked()
            self._lock.notify_all()

    def _term_at_locked(self, rv: int) -> Optional[int]:
        """The term of the entry at ``rv`` in the log window, or None when
        the window does not hold it (before its base, or past its end)."""
        i = bisect.bisect_left(self._log, rv, key=lambda te: int(te[1]["rv"]))
        if i < len(self._log) and int(self._log[i][1]["rv"]) == rv:
            return self._log[i][0]
        return None

    def _last_rv(self) -> int:
        # raft-lock domain only (see _rv_cache)
        return self._rv_cache

    # ---- ticker: heartbeats (leader) / election timeout (follower) -------

    def _ticker(self):
        election_due = time.monotonic() + random.uniform(
            ELECTION_MIN_S, ELECTION_MAX_S)
        while not self._stop.is_set():
            self._kick.wait(HEARTBEAT_S / 2)
            self._kick.clear()
            if self._stop.is_set():
                break
            with self._lock:
                role = self.role
                last_hb = self._last_heartbeat
            now = time.monotonic()
            if role == "leader":
                self._replicate_all()
            elif now - last_hb > ELECTION_MAX_S and now > election_due:
                self._campaign()
                election_due = now + random.uniform(
                    ELECTION_MIN_S, ELECTION_MAX_S)

    # ---- leader side -----------------------------------------------------

    def _replicate_all(self):
        for peer_id in self.peers:
            try:
                self._replicate_one(peer_id)
            except Exception:  # ktpu-lint: disable=KTL002 -- unreachable peer: retried next replication tick; peer health is visible in /replication status
                pass  # unreachable peer: retried next tick

    def _replicate_one(self, peer_id: str):
        with self._lock:
            if self.role != "leader":
                return
            term = self.term
            match = self._match.get(peer_id, 0)
            base = self._log_base
            entries = [dict(e, term=t) for t, e in self._log
                       if int(e["rv"]) > match]
            if match < base:
                # behind the log window (including a fresh empty follower
                # against a log whose base predates it): snapshot
                entries = None
            prev = match
            prev_term = self._term_at_locked(prev)
        if entries is None:
            self._send_snapshot(peer_id)
            return
        req = {"term": term, "leader": self.node_id, "prev_rv": prev,
               "prev_term": prev_term, "entries": entries,
               "commit_rv": self.commit_rv}
        resp = self._post(self.peers[peer_id], "/raft/append", req)
        if resp is None:
            return
        with self._lock:
            if resp.get("term", 0) > self.term:
                self._step_down(resp["term"])
                return
            if resp.get("ok"):
                self._match[peer_id] = int(resp.get("match_rv", prev))
            elif resp.get("resync"):
                self._match[peer_id] = -1  # force snapshot next pass
            else:
                self._match[peer_id] = int(resp.get("match_rv", 0))
            self._advance_commit_locked()
        if self._match.get(peer_id, 0) < 0:
            self._send_snapshot(peer_id)

    def _send_snapshot(self, peer_id: str):
        blob = self.store.snapshot_blob()
        with self._lock:
            term = self.term
        resp = self._post(self.peers[peer_id], "/raft/append",
                          {"term": term, "leader": self.node_id,
                           "snapshot": blob, "commit_rv": self.commit_rv})
        if resp and resp.get("ok"):
            with self._lock:
                self._match[peer_id] = int(blob["rv"])
                self._advance_commit_locked()

    def _advance_commit_locked(self):
        ranks = sorted([self._last_rv()]
                       + [max(v, 0) for v in self._match.values()],
                       reverse=True)
        new_commit = ranks[self.quorum - 1]
        if new_commit > self.commit_rv:
            self.commit_rv = new_commit
            self._lock.notify_all()

    # ---- follower side ---------------------------------------------------

    def _handle_append(self, req: dict) -> dict:
        with self._lock:
            if req["term"] < self.term:
                return {"ok": False, "term": self.term}
            if req["term"] > self.term or self.role != "follower":
                self.term = req["term"]
                self.role = "follower"
                self.voted_for = None
            self.leader_id = req["leader"]
            self._last_heartbeat = time.monotonic()
        my_rv = self.store.snapshot_rv()
        if "snapshot" in req:
            self.store.load_snapshot_blob(req["snapshot"])
            with self._lock:
                self._log.clear()
                self._log_base = int(req["snapshot"]["rv"])
                self._rv_cache = self._log_base
                self.commit_rv = max(self.commit_rv,
                                     min(int(req["commit_rv"]),
                                         self._log_base))
                self._caught_up_mono = time.monotonic()
            return {"ok": True, "term": req["term"],
                    "match_rv": int(req["snapshot"]["rv"])}
        prev = int(req.get("prev_rv", 0))
        entries = req.get("entries", [])
        if my_rv > prev + len(entries):
            # I have entries the leader does not know about — a divergent
            # uncommitted suffix from a dead term. Full resync.
            return {"ok": False, "term": req["term"], "resync": True}
        if my_rv < prev:
            # gap: ask the leader to back up to what I actually have
            return {"ok": False, "term": req["term"], "match_rv": my_rv}
        if self._log_mismatch(prev, req.get("prev_term"), entries, my_rv):
            # log matching: an entry I hold at an rv the leader sends was
            # written in another term — mine is a dead term's suffix
            return {"ok": False, "term": req["term"], "resync": True}
        for entry in req.get("entries", []):
            self.store.apply_replicated(entry)
        new_rv = self.store.snapshot_rv()
        with self._lock:
            self._rv_cache = max(self._rv_cache, new_rv)
            self.commit_rv = max(self.commit_rv, int(req["commit_rv"]))
            if new_rv >= self.commit_rv:
                # applied through the leader's commit frontier: current
                self._caught_up_mono = time.monotonic()
        return {"ok": True, "term": req["term"],
                "match_rv": self.store.snapshot_rv()}

    def _log_mismatch(self, prev: int, prev_term, entries: list,
                      my_rv: int) -> bool:
        """True when the term of an entry this node holds disagrees with
        the leader's for the same rv: at ``prev``, or at any rv up to
        ``my_rv`` among ``entries``. An rv outside the window is taken as
        agreeing (the snapshot that set the window's base came from a
        leader)."""
        with self._lock:
            if prev > 0 and prev_term is not None:
                mine = self._term_at_locked(prev)
                if mine is not None and mine != int(prev_term):
                    return True
            for e in entries:
                rv = int(e["rv"])
                if rv > my_rv:
                    break
                mine = self._term_at_locked(rv)
                if (mine is not None and "term" in e
                        and mine != int(e["term"])):
                    return True
        return False

    def _handle_vote(self, req: dict) -> dict:
        with self._lock:
            up_to_date = int(req["last_rv"]) >= self._rv_cache
            if req.get("pre"):
                # PreVote (raft §9.6): answer "would I vote?" WITHOUT
                # touching term state — a node that cannot win (stale log,
                # or the group has a live leader) cannot inflate terms and
                # depose a healthy leader just by being partitioned
                fresh_leader = (time.monotonic() - self._last_heartbeat
                                < ELECTION_MIN_S) or self.role == "leader"
                return {"granted": up_to_date and not fresh_leader,
                        "term": self.term}
            if req["term"] < self.term:
                return {"granted": False, "term": self.term}
            if req["term"] > self.term:
                self.term = req["term"]
                self.role = "follower"
                self.voted_for = None
            if up_to_date and self.voted_for in (None, req["candidate"]):
                self.voted_for = req["candidate"]
                self._last_heartbeat = time.monotonic()  # reset my timer
                return {"granted": True, "term": self.term}
            return {"granted": False, "term": self.term}

    # ---- elections -------------------------------------------------------

    def _campaign(self):
        with self._lock:
            term_probe = self.term + 1
            last_rv = self._rv_cache
        # PreVote round: no term bump until a majority says it would vote
        pre = 1
        for url in self.peers.values():
            resp = self._post(url, "/raft/vote",
                              {"term": term_probe, "pre": True,
                               "candidate": self.node_id,
                               "last_rv": last_rv})
            if resp and resp.get("granted"):
                pre += 1
        if pre < self.quorum:
            return
        with self._lock:
            self.term += 1
            self.role = "candidate"
            self.voted_for = self.node_id
            term = self.term
            last_rv = self._rv_cache
        votes = 1
        for peer_id, url in self.peers.items():
            resp = self._post(url, "/raft/vote",
                              {"term": term, "candidate": self.node_id,
                               "last_rv": last_rv})
            if resp is None:
                continue
            if resp.get("term", 0) > term:
                with self._lock:
                    self._step_down(resp["term"])
                return
            if resp.get("granted"):
                votes += 1
        with self._lock:
            if self.role != "candidate" or self.term != term:
                return
            if votes >= self.quorum:
                self.role = "leader"
                self.leader_id = self.node_id
                self._match = {p: 0 for p in self.peers}
                self._advance_commit_locked()  # a single node: its own log
                # my own log is the group's: committed entries are at least
                # quorum-replicated already, so start commit from my rv
                # once a quorum of matches confirms (next replicate pass)
                _LOG.info("raft: %s is leader for term %d (%d votes)",
                          self.node_id, term, votes)
        if self.is_leader():
            self._replicate_all()

    def _step_down(self, term: int):
        self.term = term
        self.role = "follower"
        self.voted_for = None

    # ---- transport -------------------------------------------------------

    @staticmethod
    def _post(url: str, path: str, obj: dict) -> Optional[dict]:
        try:
            req = urllib.request.Request(
                url + path, data=json.dumps(obj).encode(),
                headers={"Content-Type": "application/json"},
                method="POST")
            with urllib.request.urlopen(req, timeout=2.0) as resp:
                return json.loads(resp.read())
        except Exception:  # ktpu-lint: disable=KTL002 -- peer status probe: unreachable = None, the caller renders the peer as down
            return None


class ReplicatedStore:
    """The ObjectStore surface with quorum-gated mutations: reads hit the
    local store; every mutation requires leadership and blocks until the
    resulting rv is quorum-replicated. Hand this to an APIServer and the
    control plane writes with etcd's durability contract."""

    def __init__(self, node: RaftNode, commit_timeout: float = 5.0):
        self.node = node
        self.inner = node.store
        self.commit_timeout = commit_timeout
        # the writers' time in wait_commit: count, total and longest
        self._waits = [0, 0.0, 0.0]
        self._waits_lock = threading.Lock()

    def _gated(self, fn, *a, **kw):
        self.node.ensure_leader()
        out = fn(*a, **kw)
        self.node.kick()
        t0 = time.monotonic()
        try:
            self.node.wait_commit(self.inner.snapshot_rv(),
                                  timeout=self.commit_timeout)
        finally:
            waited = time.monotonic() - t0
            with self._waits_lock:
                self._waits[0] += 1
                self._waits[1] += waited
                self._waits[2] = max(self._waits[2], waited)
        return out

    def commit_wait_stats(self) -> dict:
        """Writes that waited for their quorum here, and the milliseconds
        they waited in all and at most."""
        with self._waits_lock:
            n, total, longest = self._waits
        return {"count": n, "totalMs": round(total * 1000.0, 3),
                "maxMs": round(longest * 1000.0, 3)}

    # mutations: quorum-gated
    def create(self, *a, **kw):
        return self._gated(self.inner.create, *a, **kw)

    def create_many(self, *a, **kw):
        return self._gated(self.inner.create_many, *a, **kw)

    def update(self, *a, **kw):
        return self._gated(self.inner.update, *a, **kw)

    def delete(self, *a, **kw):
        return self._gated(self.inner.delete, *a, **kw)

    def bind_many(self, *a, **kw):
        return self._gated(self.inner.bind_many, *a, **kw)

    def update_status_many(self, *a, **kw):
        return self._gated(self.inner.update_status_many, *a, **kw)

    def heartbeat_many(self, *a, **kw):
        return self._gated(self.inner.heartbeat_many, *a, **kw)

    def renew_leases(self, *a, **kw):
        return self._gated(self.inner.renew_leases, *a, **kw)

    # everything else (reads, watches, metadata) passes through.
    # EVERY mutating verb must be gated above: one slipping through here
    # would mutate a FOLLOWER's store locally — divergence the next
    # snapshot resync silently papers over.
    def __getattr__(self, name):
        return getattr(self.inner, name)
