"""Rate-limited dedup work queues — the controller backbone.

Reference: ``client-go/util/workqueue/`` (``TypedRateLimitingInterface``:
Add/Get/Done dedup + per-item exponential backoff + AddAfter).

The PyTorch port's copy of ``kubernetes_tpu/client/workqueue.py`` (host
code only): the backbone of controllers/. The backoff's base and cap are
module constants and delays run on the wall clock, where the reference
takes both delays and a clock as arguments that no caller sets.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Hashable, Optional


class WorkQueue:
    """Dedup queue: an item re-added while processing is re-queued on Done."""

    def __init__(self):
        self._lock = threading.Condition()
        self._queue: list = []
        self._dirty: set = set()
        self._processing: set = set()
        self._closed = False

    def add(self, item: Hashable):
        with self._lock:
            if self._closed or item in self._dirty:
                return
            self._dirty.add(item)
            if item not in self._processing:
                self._queue.append(item)
                self._lock.notify()

    def get(self, timeout: Optional[float] = None) -> Optional[Hashable]:
        with self._lock:
            deadline = None if timeout is None else time.time() + timeout
            while not self._queue and not self._closed:
                remaining = None if deadline is None else deadline - time.time()
                if remaining is not None and remaining <= 0:
                    return None
                self._lock.wait(remaining if remaining is not None else 0.2)
            if self._closed and not self._queue:
                return None
            item = self._queue.pop(0)
            self._processing.add(item)
            self._dirty.discard(item)
            return item

    def done(self, item: Hashable):
        with self._lock:
            self._processing.discard(item)
            if item in self._dirty:
                self._queue.append(item)
                self._lock.notify()

    def close(self):
        with self._lock:
            self._closed = True
            self._lock.notify_all()

    def __len__(self):
        with self._lock:
            return len(self._queue)


BASE_DELAY = 0.005  # seconds before the first retry of a failed item
MAX_DELAY = 10.0    # the backoff's cap


class RateLimitingQueue(WorkQueue):
    """WorkQueue + per-item exponential failure backoff (AddRateLimited)."""

    def __init__(self):
        super().__init__()
        self._failures: dict = {}
        self._delayed: list[tuple[float, int, Hashable]] = []
        self._seq = 0
        self._timer = threading.Thread(target=self._pump, daemon=True)
        self._timer.start()

    def add_rate_limited(self, item: Hashable):
        with self._lock:
            n = self._failures.get(item, 0)
            self._failures[item] = n + 1
            delay = min(BASE_DELAY * (2 ** n), MAX_DELAY)
        self.add_after(item, delay)

    def forget(self, item: Hashable):
        with self._lock:
            self._failures.pop(item, None)

    def num_requeues(self, item: Hashable) -> int:
        with self._lock:
            return self._failures.get(item, 0)

    def add_after(self, item: Hashable, delay: float):
        with self._lock:
            self._seq += 1
            heapq.heappush(self._delayed,
                           (time.time() + delay, self._seq, item))

    def _pump(self):
        while True:
            with self._lock:
                if self._closed:
                    return
                now = time.time()
                due = []
                while self._delayed and self._delayed[0][0] <= now:
                    due.append(heapq.heappop(self._delayed)[2])
            for item in due:
                self.add(item)
            time.sleep(0.002 if due else 0.01)
