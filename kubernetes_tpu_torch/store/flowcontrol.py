"""API Priority and Fairness — classification, queuesets, fair dispatch.

Reference: ``staging/src/k8s.io/apiserver/pkg/util/flowcontrol/`` — flow
schemas match requests to priority levels; each level runs a QUEUESET:

- Requests carry a flow distinguisher (user / agent); shuffle sharding
  (``fairqueuing/queueset``'s dealer) hashes each flow onto ``hand_size``
  of the level's ``n_queues`` queues and enqueues on the least-loaded of
  that hand — an elephant flow can congest at most its hand, so a mouse
  flow whose hand overlaps in even one queue keeps progressing.
- Seats (assured concurrency) dispatch fairly ACROSS queues: when a seat
  frees, the next request comes from the next non-empty queue in
  round-robin order (the uniform-cost simplification of upstream's
  virtual-time fair queuing — every queue gets equal service share).
- Bounded queues: overflow and queue-wait timeouts reject 429 with
  Retry-After, exactly the client-observable contract upstream ships.

Priority levels isolate classes of traffic from each other; queuesets
isolate flows WITHIN a level. ``exempt`` levels bypass everything.
"""

from __future__ import annotations

import hashlib
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Optional


class RejectedError(Exception):
    def __init__(self, retry_after: float = 1.0):
        super().__init__("too many requests")
        self.retry_after = retry_after


# ------------------------------------------------------------------ queueset

def shuffle_shard(flow: str, n_queues: int, hand_size: int,
                  salt: str = "") -> list[int]:
    """Deterministic dealer (fairqueuing ``shufflesharding.Dealer``): a
    64-bit hash of the flow deals ``hand_size`` distinct queue indices out
    of ``n_queues``. Two flows share a full hand with probability
    ~(hand/n)^hand — vanishing — so one flow's congestion rarely covers
    another's whole hand."""
    h = int.from_bytes(
        hashlib.sha256(f"{salt}/{flow}".encode()).digest()[:8], "big")
    hand: list[int] = []
    for i in range(min(hand_size, n_queues)):
        card = h % (n_queues - i)
        h //= (n_queues - i)
        # map into the remaining deck: indices already dealt shift the card
        for dealt in sorted(hand):
            if card >= dealt:
                card += 1
        hand.append(card)
        hand.sort()
    return hand


class _Ticket:
    __slots__ = ("event", "canceled", "queue_idx")

    def __init__(self, queue_idx: int):
        self.event = threading.Event()
        self.canceled = False
        self.queue_idx = queue_idx


class QueueSet:
    """One priority level's fair-queuing machinery. All methods are called
    under the owning FlowController's condition lock."""

    def __init__(self, concurrency: int, n_queues: int = 64,
                 hand_size: int = 8, queue_length: int = 50,
                 name: str = ""):
        self.concurrency = concurrency
        self.n_queues = max(1, n_queues)
        self.hand_size = max(1, min(hand_size, self.n_queues))
        self.queue_length = queue_length
        self.name = name
        self.queues: list[deque] = [deque() for _ in range(self.n_queues)]
        self.active = 0
        self._rr = 0  # fair-dispatch pointer

    def _waiting(self) -> int:
        return sum(len(q) for q in self.queues)

    def try_admit(self, flow: str) -> Optional[_Ticket]:
        """None = seat taken immediately; a ticket = caller must wait on it.
        Raises RejectedError when the chosen queue is full."""
        if self.active < self.concurrency and self._waiting() == 0:
            self.active += 1
            return None
        hand = shuffle_shard(flow, self.n_queues, self.hand_size, self.name)
        qi = min(hand, key=lambda i: len(self.queues[i]))
        if len(self.queues[qi]) >= self.queue_length:
            raise RejectedError()
        t = _Ticket(qi)
        self.queues[qi].append(t)
        return t

    def dispatch(self):
        """A seat freed (or a waiter canceled): hand seats to waiters, one
        per non-empty queue in round-robin order."""
        n = self.n_queues
        while self.active < self.concurrency:
            granted = False
            for step in range(n):
                qi = (self._rr + step) % n
                q = self.queues[qi]
                while q:
                    t = q.popleft()
                    if t.canceled:
                        continue
                    self.active += 1
                    t.event.set()
                    self._rr = (qi + 1) % n  # next queue gets next turn
                    granted = True
                    break
                if granted:
                    break
            if not granted:
                return

    def cancel(self, t: _Ticket):
        t.canceled = True
        try:
            # dead tickets must not occupy queue_length slots (a saturated
            # level with timing-out retries would otherwise 429 forever)
            self.queues[t.queue_idx].remove(t)
        except ValueError:
            pass  # already dispatched or dropped


# ------------------------------------------------------------- configuration

@dataclass
class PriorityLevel:
    name: str
    concurrency: int          # assured concurrency shares (seats)
    queue_length: int = 50    # waiting requests per queue before 429
    exempt: bool = False
    n_queues: int = 64        # queueset width (1 = plain FIFO)
    hand_size: int = 8

    qs: Optional[QueueSet] = field(default=None, repr=False)

    def queueset(self) -> QueueSet:
        if self.qs is None:
            self.qs = QueueSet(self.concurrency, self.n_queues,
                               self.hand_size, self.queue_length, self.name)
        return self.qs


@dataclass
class FlowSchema:
    """Match rules -> priority level. Rules match on verb group and/or a
    user-agent substring (upstream matches full RequestInfo + user)."""

    name: str
    level: str
    verbs: tuple[str, ...] = ()       # () = all ("get", "list", "watch", ...)
    agent_substr: str = ""            # "" = all agents
    paths: tuple[str, ...] = ()       # path prefixes; () = all


class FlowController:
    """classify() -> acquire/release around request execution.

    ``flow`` is the flow distinguisher (authenticated user name, falling
    back to the client agent): requests of the same flow share queues;
    different flows are isolated by shuffle sharding + fair dispatch."""

    def __init__(self, levels: Optional[list[PriorityLevel]] = None,
                 schemas: Optional[list[FlowSchema]] = None):
        self._cv = threading.Condition()
        self.levels = {pl.name: pl for pl in levels or default_levels()}
        self.schemas = schemas if schemas is not None else default_schemas()
        self.rejected_total = 0
        # (level, flow) -> requests given a seat (exempt ones included):
        # upstream's apiserver_flowcontrol_dispatched_requests_total, by flow
        self.dispatched: dict[tuple[str, str], int] = {}

    def _count(self, level: PriorityLevel, flow: str) -> None:
        key = (level.name, flow)
        self.dispatched[key] = self.dispatched.get(key, 0) + 1

    def classify(self, verb: str, path: str, agent: str = "") -> PriorityLevel:
        for fs in self.schemas:
            if fs.verbs and verb.lower() not in fs.verbs:
                continue
            if fs.agent_substr and fs.agent_substr not in agent:
                continue
            if fs.paths and not any(path.startswith(p) for p in fs.paths):
                continue
            if fs.level in self.levels:
                return self.levels[fs.level]
        return self.levels["global-default"]

    def acquire(self, level: PriorityLevel, timeout: float = 15.0,
                flow: str = "") -> None:
        """Take a seat at the level, queueing fairly by flow. Raises
        RejectedError on queue overflow or wait timeout."""
        with self._cv:
            if level.exempt:
                self._count(level, flow)
                return
            qs = level.queueset()
            try:
                ticket = qs.try_admit(flow)
            except RejectedError:
                self.rejected_total += 1
                raise
            if ticket is not None:
                # seats may be free with waiters present (e.g. after a
                # timeout withdrawal): keep the set drained
                qs.dispatch()
            else:
                self._count(level, flow)
        if ticket is None:
            return
        if ticket.event.wait(timeout):
            with self._cv:
                self._count(level, flow)
            return
        # timed out waiting: withdraw; a dispatch may have raced the
        # timeout, in which case the seat is ours after all
        with self._cv:
            if ticket.event.is_set():
                self._count(level, flow)
                return
            qs.cancel(ticket)
            self.rejected_total += 1
        raise RejectedError()

    def release(self, level: PriorityLevel) -> None:
        if level.exempt:
            return
        with self._cv:
            qs = level.queueset()
            qs.active -= 1
            qs.dispatch()

    def stats(self) -> dict:
        with self._cv:
            out = {}
            for pl in self.levels.values():
                qs = pl.qs
                out[pl.name] = {
                    "active": 0 if qs is None else qs.active,
                    "waiting": 0 if qs is None else qs._waiting()}
            return out

    def dispatched_by_flow(self) -> dict:
        """{level: {flow: requests given a seat}} since construction."""
        with self._cv:
            out: dict = {}
            for (level, flow), n in self.dispatched.items():
                out.setdefault(level, {})[flow] = n
            return out


def default_levels() -> list[PriorityLevel]:
    """The upstream suggested configuration's shape (bootstrap policy)."""
    return [
        PriorityLevel("exempt", concurrency=0, exempt=True),
        PriorityLevel("system", concurrency=30),
        PriorityLevel("leader-election", concurrency=10),
        PriorityLevel("workload-high", concurrency=40),
        PriorityLevel("global-default", concurrency=20),
        PriorityLevel("catch-all", concurrency=5),
    ]


def default_schemas() -> list[FlowSchema]:
    return [
        FlowSchema("health", "exempt", paths=("/healthz", "/readyz", "/livez",
                                              "/metrics")),
        FlowSchema("system-leader-election", "leader-election",
                   paths=("/apis/coordination.k8s.io",)),
        FlowSchema("system-nodes", "system", agent_substr="kubelet"),
        FlowSchema("kube-scheduler", "system", agent_substr="scheduler"),
        FlowSchema("kube-controller-manager", "workload-high",
                   agent_substr="controller"),
        FlowSchema("service-accounts", "global-default"),
    ]
