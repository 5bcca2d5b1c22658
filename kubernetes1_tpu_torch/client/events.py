"""Event recorder (ref: client-go tools/record): best-effort events with
count aggregation for repeats.  The port's copy of the JAX package's
``client/events.py``.

Recording is asynchronous: ``event()`` puts the event on a bounded buffer
that one background thread drains into the apiserver, so an event adds
no API round trip to the caller's hot path (the scheduler records one a
placement).  When the buffer is full the newest event is dropped."""

from __future__ import annotations

import queue
import threading
from typing import Dict, Tuple

from ..api import types as t
from ..machinery import now_iso
from ..utils.logutil import RateLimitedReporter
from .clientset import Clientset


class EventRecorder:
    MAX_CACHED = 4096  # aggregation keys remembered before the cache clears
    BUFFER = 2048  # events queued for the sink thread

    def __init__(self, clientset: Clientset, component: str):
        self.cs = clientset
        self.component = component
        self._lock = threading.Lock()
        # aggregation key -> (event name, its count as last written)
        self._seen: Dict[tuple, Tuple[str, int]] = {}
        self._q: "queue.Queue" = queue.Queue(maxsize=self.BUFFER)
        self._worker: threading.Thread = None  # started on first event
        self._drop_reporter = RateLimitedReporter(f"events({component})")

    def event(self, obj, event_type: str, reason: str, message: str):
        """Record an event about obj; repeats bump count instead of piling
        up.  Returns immediately — the API write happens on the sink
        thread."""
        ref = t.ObjectReference(
            kind=obj.KIND,
            namespace=obj.metadata.namespace,
            name=obj.metadata.name,
            uid=obj.metadata.uid,
        )
        try:
            self._q.put_nowait((ref, event_type, reason, message, now_iso()))
        except queue.Full:
            return  # overloaded: drop (best-effort, as upstream)
        self._ensure_worker()

    def flush(self, timeout: float = 5.0):
        """Block until every event put so far has been sent (tests, and an
        orderly stop)."""
        done = threading.Event()
        try:
            self._q.put(done, timeout=timeout)
        except queue.Full:
            return
        self._ensure_worker()
        done.wait(timeout)

    def _ensure_worker(self):
        if self._worker is None:
            with self._lock:
                if self._worker is None:
                    self._worker = threading.Thread(
                        target=self._drain, daemon=True,
                        name=f"event-sink/{self.component}")
                    self._worker.start()

    def _drain(self):
        while True:
            item = self._q.get()
            if isinstance(item, threading.Event):  # a flush's fence
                item.set()
                continue
            # Coalesce identical items queued behind this one: a burst of N
            # identical events enqueued before the first create completes
            # would each miss _seen (populated only here, after the create)
            # and become N duplicate Event objects.  Collapsing the burst
            # in-queue keeps aggregation semantics identical to the old
            # synchronous path.  Coalescing stops at a flush's fence (which
            # still means "everything put before me was sent") and after at
            # most one buffer's worth of items (so hot producers refilling
            # the queue can't starve sends forever).
            # slot = [first_item, n, latest_ts]: the create keeps the FIRST
            # occurrence's timestamp (when the condition started) while
            # last_timestamp reports the latest repeat, as the synchronous
            # path did.
            batch: Dict[tuple, list] = {}
            batch[self._agg_key(item[0], item[2], item[3])] = \
                [item, 1, item[4]]
            fence = None
            drained = 1
            while fence is None and drained < self._q.maxsize:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if isinstance(nxt, threading.Event):
                    fence = nxt
                    break
                drained += 1
                k = self._agg_key(nxt[0], nxt[2], nxt[3])
                slot = batch.get(k)
                if slot is not None:
                    slot[1] += 1
                    slot[2] = nxt[4]
                else:
                    batch[k] = [nxt, 1, nxt[4]]
            for it, n, last in batch.values():  # dicts keep insertion order
                try:
                    self._send(*it, repeat=n, last_now=last)
                except Exception as e:  # noqa: BLE001 — events are best-effort
                    # rate-limited: during an apiserver outage EVERY batch
                    # entry fails — one summary line per window, not one
                    # line per event, or the flood buries real diagnostics
                    self._drop_reporter.report(f"last {it[2]}: {e}", n=n)
            if fence is not None:
                fence.set()

    @staticmethod
    def _agg_key(ref, reason: str, message: str) -> tuple:
        return (ref.kind, ref.namespace, ref.name, reason, message[:64])

    def _send(self, ref, event_type: str, reason: str, message: str,
              now: str, repeat: int = 1, last_now: str = ""):
        key = self._agg_key(ref, reason, message)
        with self._lock:
            existing = self._seen.get(key)
        ns = ref.namespace or "default"
        if existing:
            self._bump(key, existing, ns, last_now or now, repeat)
            return
        ev = t.Event()
        ev.metadata.generate_name = f"{ref.name}."
        ev.metadata.namespace = ns
        ev.involved_object = ref
        ev.type = event_type
        ev.reason = reason
        ev.message = message
        ev.source_component = self.component
        ev.first_timestamp = now
        ev.last_timestamp = last_now or now
        if repeat > 1:
            ev.count = repeat
        created = self.cs.events.create(ev, ns)
        with self._lock:
            if len(self._seen) > self.MAX_CACHED:
                self._seen.clear()
            self._seen[key] = (created.metadata.name, created.count)

    def _bump(self, key: tuple, seen: Tuple[str, int], ns: str, now: str, repeat: int = 1):
        """Count a repeat by a merge patch from the count this recorder
        wrote: the JAX recorder GETs the event first, which the Node
        authorizer refuses a kubelet (a node may write events, not read
        them)."""
        name, count = seen
        self.cs.events.patch(name, {"count": count + repeat, "lastTimestamp": now}, ns)
        with self._lock:
            self._seen[key] = (name, count + repeat)
