"""The process's event loop: one dispatcher thread for every long-lived
connection and every scrape timer, and a small pool for blocking work.

The port's copy of the JAX package's ``utils/eventloop.py``:

- ``EventLoop``: one daemon thread multiplexing I/O readiness
  (``selectors.DefaultSelector``), cross-thread callbacks (``call_soon``,
  through a self-pipe) and a timer heap (``call_later``).  Timer fire
  lag lands in the ``ktpu_eventloop_lag_seconds`` histogram;
- ``shared_loop()``: the process-wide dispatcher the balancer
  (``proxy/balancer.py``) and the obs collector (``obs/collector.py``)
  register with;
- ``shared_pool()``: a bounded worker pool for the blocking work the
  dispatcher must never run inline (the collector's scrape fetches);

Threading contract: ``register``/``modify``/``unregister`` and timer
callbacks run ON the loop thread; other threads use ``call_soon``, which
never blocks.  A callback that blocks stalls every connection on the
loop: the JAX package's dispatcher sanitizer (``loopsan``), which flags
such calls, is not part of the port.
"""

from __future__ import annotations

import heapq
import itertools
import os
import queue
import selectors
import threading
import time
from collections import deque
from typing import Callable, List, Optional

from .logutil import RateLimitedReporter
from .metrics import Histogram

# Timer-lag buckets: a healthy dispatcher fires timers within single-digit
# milliseconds; 100ms+ of lag means some callback blocked the loop.
_LAG_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                2.5, 5.0)

# One histogram for the process (there is one shared dispatcher).
loop_lag_seconds = Histogram(
    "ktpu_eventloop_lag_seconds",
    "dispatcher timer fire lag (scheduled -> ran)",
    buckets=_LAG_BUCKETS)

# Blocking-I/O slots for the collector's scrapes.  Sized for concurrency of
# SLOW scrapes (each bounded by the caller's fetch timeout + retries);
# healthy scrapes are millisecond-scale and never queue.
DEFAULT_POOL_SIZE = 8


class Timer:
    """A scheduled callback handle.  ``cancel()`` is safe from any
    thread: the loop skips cancelled entries at pop time, so cancel
    never needs to find the entry inside the heap."""

    __slots__ = ("when", "seq", "fn", "cancelled")

    def __init__(self, when: float, seq: int, fn: Callable[[], None]):
        self.when = when
        self.seq = seq
        self.fn = fn
        self.cancelled = False

    def cancel(self):
        self.cancelled = True

    def __lt__(self, other: "Timer") -> bool:
        return (self.when, self.seq) < (other.when, other.seq)


class EventLoop:
    """See module docstring.  start() spawns the dispatcher thread."""

    def __init__(self, name: str = "ktpu-dispatcher"):
        self.name = name
        self._sel = selectors.DefaultSelector()
        # lock-free cross-thread queue: deque.append is atomic, and the
        # self-pipe write is non-blocking — call_soon never blocks a
        # producer, even one holding its owner's commit lock
        self._soon: "deque[Callable[[], None]]" = deque()
        self._timers: List[Timer] = []  # heap; loop thread only
        self._seq = itertools.count()   # count().__next__ is atomic
        self._stopping = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._err = RateLimitedReporter(f"eventloop/{name}", window=30.0)
        # registered long-lived connections (the ktpu_eventloop_connections
        # gauge source); adjusted on the loop thread, read anywhere (int
        # reads are atomic)
        self.connections = 0
        r, w = os.pipe()
        os.set_blocking(r, False)
        os.set_blocking(w, False)
        self._wake_r, self._wake_w = r, w
        self._sel.register(r, selectors.EVENT_READ, self._drain_wakeup)

    # ---------------------------------------------------------- lifecycle

    def start(self) -> "EventLoop":
        if self._thread is None:
            # the dispatcher thread IS the rule: every long-lived
            # connection multiplexes onto this one stack
            self._thread = threading.Thread(
                target=self._run, daemon=True, name=self.name)
            self._thread.start()
        return self

    def is_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def stop(self, join_timeout: float = 3.0):
        self._stopping.set()
        self._wakeup()
        if self._thread is not None:
            self._thread.join(timeout=join_timeout)

    def in_loop(self) -> bool:
        return threading.current_thread() is self._thread

    # --------------------------------------------------------- scheduling

    def call_soon(self, fn: Callable[[], None]):
        """Run ``fn`` on the loop thread ASAP.  Thread-safe and
        non-blocking, so a caller may hold its own lock."""
        self._soon.append(fn)
        self._wakeup()

    def call_later(self, delay: float, fn: Callable[[], None]) -> Timer:
        """Run ``fn`` on the loop thread after ``delay`` seconds.
        Thread-safe: off-loop callers route the heap push through
        call_soon; the returned handle's cancel() works either way."""
        tm = Timer(time.monotonic() + max(0.0, delay), next(self._seq), fn)
        if self.in_loop():
            heapq.heappush(self._timers, tm)
        else:
            self.call_soon(lambda: heapq.heappush(self._timers, tm))
        return tm

    # ------------------------------------------------- I/O registration
    # Loop-thread only (route through call_soon from elsewhere): the
    # selector's internal state is not shared-access safe.

    def register(self, fileobj, events: int, callback):
        self._sel.register(fileobj, events, callback)

    def modify(self, fileobj, events: int, callback):
        self._sel.modify(fileobj, events, callback)

    def unregister(self, fileobj):
        try:
            self._sel.unregister(fileobj)
        except KeyError:
            pass  # already unregistered (teardown paths can race close)

    def add_connection(self):
        self.connections += 1

    def remove_connection(self):
        self.connections -= 1

    # -------------------------------------------------------------- loop

    def _wakeup(self):
        try:
            os.write(self._wake_w, b"x")
        except BlockingIOError:
            pass  # pipe already holds a pending wakeup — that's enough
        except OSError:
            pass  # loop shut down under us — nothing left to wake

    def _drain_wakeup(self, mask: int):
        try:
            while os.read(self._wake_r, 4096):
                pass
        except BlockingIOError:
            pass  # drained

    def _guard(self, fn: Callable[[], None]):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — one bad callback must not kill every connection on the dispatcher
            self._err.report(f"callback {getattr(fn, '__name__', fn)!r}: {e}")

    def _run(self):
        while not self._stopping.is_set():
            timeout = None
            if self._timers:
                timeout = max(0.0, self._timers[0].when - time.monotonic())
            if self._soon:
                timeout = 0.0
            try:
                events = self._sel.select(timeout)
            except OSError:
                continue  # fd closed mid-select (a conn torn down racily)
            for key, mask in events:
                self._guard(lambda cb=key.data, m=mask: cb(m))
            while self._soon:
                try:
                    fn = self._soon.popleft()
                except IndexError:
                    break
                self._guard(fn)
            now = time.monotonic()
            while self._timers and self._timers[0].when <= now:
                tm = heapq.heappop(self._timers)
                if tm.cancelled:
                    continue
                lag = now - tm.when
                loop_lag_seconds.observe(lag)
                self._guard(tm.fn)
        try:
            self._sel.close()
            os.close(self._wake_r)
            os.close(self._wake_w)
        except OSError:
            pass  # already closed


class WorkerPool:
    """Bounded daemon workers for blocking I/O submitted off the
    dispatcher (scrape fetches).  Deliberately simple: an unbounded
    submit queue whose depth is naturally bounded by the callers (each
    scrape target re-arms only after its previous fetch completes, so at
    most one job per target is ever queued)."""

    def __init__(self, size: int = DEFAULT_POOL_SIZE,
                 name: str = "ktpu-pool"):
        self._q: "queue.Queue[Optional[Callable[[], None]]]" = queue.Queue()
        self._err = RateLimitedReporter(f"workerpool/{name}", window=30.0)
        self._threads = [
            threading.Thread(
                target=self._work, daemon=True, name=f"{name}-{i}")
            for i in range(size)
        ]
        for th in self._threads:
            th.start()

    def submit(self, fn: Callable[[], None]):
        self._q.put(fn)

    def _work(self):
        while True:
            fn = self._q.get()
            if fn is None:
                return
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — a failing scrape job must not kill a shared pool slot
                self._err.report(f"job {getattr(fn, '__name__', fn)!r}: {e}")


_shared_lock = threading.Lock()
_shared_loop: Optional[EventLoop] = None
_shared_pool: Optional[WorkerPool] = None


def shared_loop() -> EventLoop:
    """The process-wide dispatcher (started on first use).  Daemon
    thread: it lives for the process — components register/unregister
    their connections and timers, they do not own the loop."""
    global _shared_loop
    with _shared_lock:
        if _shared_loop is None or not _shared_loop.is_alive():
            _shared_loop = EventLoop().start()
        return _shared_loop


def shared_pool() -> WorkerPool:
    """The process-wide blocking-I/O pool (started on first use)."""
    global _shared_pool
    with _shared_lock:
        if _shared_pool is None:
            _shared_pool = WorkerPool()
        return _shared_pool
