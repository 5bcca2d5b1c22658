"""Deduplicating, rate-limited work queues for controllers: the port's copy
of the JAX package's ``utils/workqueue.py``, on plain ``threading`` locks.

Ref: client-go util/workqueue/{queue,delaying_queue,default_rate_limiters}.go.
Semantics preserved from the reference:
- an item added while queued is coalesced (dedup on dirty set);
- an item added while being processed is re-queued when done() is called;
- RateLimitingQueue.add_rate_limited applies per-item exponential backoff,
  forget() resets it — this is what gives controllers retry-with-backoff.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Hashable, Optional


class WorkQueue:
    def __init__(self):
        self._cond = threading.Condition()
        self._queue: list = []
        self._dirty: set = set()
        self._processing: set = set()
        self._shutdown = False

    def add(self, item: Hashable):
        with self._cond:
            if self._shutdown or item in self._dirty:
                return
            self._dirty.add(item)
            if item in self._processing:
                return
            self._queue.append(item)
            self._cond.notify()

    def get(self, timeout: Optional[float] = None):
        """Blocks; returns None on shutdown or timeout."""
        with self._cond:
            deadline = time.monotonic() + timeout if timeout is not None else None
            while not self._queue and not self._shutdown:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                self._cond.wait(remaining)
            if self._shutdown and not self._queue:
                return None
            item = self._queue.pop(0)
            self._processing.add(item)
            self._dirty.discard(item)
            return item

    def done(self, item: Hashable):
        with self._cond:
            self._processing.discard(item)
            if item in self._dirty:
                self._queue.append(item)
                self._cond.notify()

    def len(self) -> int:
        with self._cond:
            return len(self._queue)

    def shut_down(self):
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()

    @property
    def shutting_down(self) -> bool:
        with self._cond:
            return self._shutdown


class DelayingQueue(WorkQueue):
    """WorkQueue plus add_after(item, delay)."""

    def __init__(self):
        super().__init__()
        self._heap: list = []  # (ready_at, seq, item)
        self._seq = 0
        self._timer_cond = threading.Condition()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def add_after(self, item: Hashable, delay: float):
        if delay <= 0:
            self.add(item)
            return
        with self._timer_cond:
            heapq.heappush(self._heap, (time.monotonic() + delay, self._seq, item))
            self._seq += 1
            self._timer_cond.notify()

    def _loop(self):
        while True:
            with self._timer_cond:
                if self.shutting_down:
                    return
                now = time.monotonic()
                ready = []
                while self._heap and self._heap[0][0] <= now:
                    ready.append(heapq.heappop(self._heap)[2])
                wait = (self._heap[0][0] - now) if self._heap else 0.5
            for item in ready:
                self.add(item)
            with self._timer_cond:
                self._timer_cond.wait(min(wait, 0.5))

    def shut_down(self):
        super().shut_down()
        with self._timer_cond:
            self._timer_cond.notify_all()


class RateLimitingQueue(DelayingQueue):
    """Per-item exponential backoff (5ms base doubling to 1000s by default —
    the reference's DefaultControllerRateLimiter)."""

    def __init__(self, base_delay: float = 0.005, max_delay: float = 1000.0):
        super().__init__()
        self._base = base_delay
        self._max = max_delay
        self._failures: dict = {}
        self._fail_lock = threading.Lock()

    def add_rate_limited(self, item: Hashable):
        with self._fail_lock:
            n = self._failures.get(item, 0)
            self._failures[item] = n + 1
        delay = min(self._base * (2 ** n), self._max)
        self.add_after(item, delay)

    def forget(self, item: Hashable):
        with self._fail_lock:
            self._failures.pop(item, None)

    def num_requeues(self, item: Hashable) -> int:
        with self._fail_lock:
            return self._failures.get(item, 0)
