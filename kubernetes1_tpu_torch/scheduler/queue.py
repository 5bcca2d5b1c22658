"""Scheduling queue: priority-ordered with backoff for unschedulable pods.

The port's copy of the JAX package's ``scheduler/queue.py`` (ref:
plugin/pkg/scheduler/core/scheduling_queue.go): a higher spec.priority
pops first, FIFO within a priority band; a pod that failed to schedule
re-enters after exponential backoff, so a queue full of unschedulable
pods does not spin the scheduler.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Dict, Optional



class SchedulingQueue:
    BASE_BACKOFF = 0.1  # s, doubled a failed attempt
    MAX_BACKOFF = 10.0  # s

    def __init__(self):
        self._cond = threading.Condition()
        self._heap: list = []  # (-priority, seq, key)
        self._entries: set = set()
        self._seq = 0
        self._shutdown = False
        self._attempts: Dict[str, int] = {}
        self._timers: Dict[str, threading.Timer] = {}

    def add(self, key: str, priority: int = 0):
        with self._cond:
            if self._shutdown or key in self._entries:
                return
            self._entries.add(key)
            heapq.heappush(self._heap, (-priority, self._seq, key))
            self._seq += 1
            self._cond.notify()

    def add_backoff(self, key: str, priority: int = 0,
                    attempts: Optional[int] = None):
        """Re-add after exponential backoff (unschedulable path).
        `attempts` overrides the internal schedule-failure counter with a
        caller-tracked one — the bind-failure path uses it because a
        successful SCHEDULE forgets the internal counter before its async
        bind resolves, and a failing bind must still back off
        exponentially, not restart at the base delay every cycle."""
        with self._cond:
            if self._shutdown:
                return
            n = self._attempts.get(key, 0)
            self._attempts[key] = n + 1
            if attempts is not None:
                n = attempts
            delay = min(self.BASE_BACKOFF * (2**n), self.MAX_BACKOFF)
            if key in self._timers:
                return
            timer = threading.Timer(delay, self._timer_fire, args=(key, priority))
            timer.daemon = True
            self._timers[key] = timer
            timer.start()

    def _timer_fire(self, key: str, priority: int):
        with self._cond:
            self._timers.pop(key, None)
        self.add(key, priority)

    def flush_backoffs(self):
        """Move every backing-off pod to the active queue now — called on
        cluster-state changes that may make pods schedulable (node add,
        device health change, pod deletion), the reference's
        moveAllToActiveOrBackoffQueue."""
        with self._cond:
            fired = []
            for key, timer in list(self._timers.items()):
                timer.cancel()
                self._timers.pop(key, None)
                fired.append(key)
        for key in fired:
            self.add(key)

    def forget(self, key: str):
        """Successful schedule resets the backoff counter."""
        with self._cond:
            self._attempts.pop(key, None)

    def purge(self, key: str) -> bool:
        """Remove every trace of a pod from the queue NOW — the churn
        fix: a pod deleted while Pending must not cost a schedule
        attempt, a bind, or a live backoff timer.  Clears the active
        entry (its heap slot is skipped lazily at pop — `_entries` is
        the liveness set), cancels any backoff timer, and drops the
        attempt counter.  Returns True when something was actually
        purged (the scheduler's churn-purge counter reads this).

        Best-effort against a concurrently FIRING timer: its re-add can
        land after the purge, and the scheduler's pop-side informer
        re-check absorbs the dead key (level-triggered)."""
        with self._cond:
            purged = key in self._entries
            self._entries.discard(key)
            timer = self._timers.pop(key, None)
            if timer is not None:
                timer.cancel()
                purged = True
            self._attempts.pop(key, None)
            return purged

    def pop(self, timeout: Optional[float] = None) -> Optional[str]:
        with self._cond:
            deadline = time.monotonic() + timeout if timeout is not None else None
            while True:
                # skip heap slots whose entry was purged (deleted while
                # Pending): _entries is the liveness set
                while self._heap:
                    _, _, key = heapq.heappop(self._heap)
                    if key in self._entries:
                        self._entries.discard(key)
                        return key
                if self._shutdown:
                    return None
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                self._cond.wait(remaining)

    def depth(self) -> int:
        """Pending entries — active set PLUS pods in backoff (the gauge
        must not read ~0 exactly when everything is unschedulable and
        backing off; the reference counts active+backoff+unschedulable).
        Counts `_entries`, not the heap: purged pods leave dead heap
        slots behind until a pop sweeps them."""
        with self._cond:
            return len(self._entries) + len(self._timers)

    def shut_down(self):
        with self._cond:
            self._shutdown = True
            for timer in self._timers.values():
                timer.cancel()
            self._timers.clear()
            self._cond.notify_all()
