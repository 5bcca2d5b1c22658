"""Cross-component request tracing: span contexts, propagation, collection.

The port's copy of the JAX package's ``utils/spans.py``, so that the
port's components join the traces the JAX control plane keeps:

- an ``X-Ktpu-Trace: <trace-id>/<span-id>`` header rides every request of
  the port's client (``client/rest.py`` injects it from the thread's
  active span, or mints a fresh root context);
- the apiserver stamps the creating request's trace id on a pod
  (``trace.ktpu.io/trace-id``), and the scheduler opens its spans under it;
- finished spans land in a bounded per-component SpanCollector, served as
  JSON at ``/debug/traces`` beside a component's ``/metrics``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional

# Header carrying "<trace-id>/<span-id>" on every client request.  The
# annotation the apiserver stamps the trace id under lives with the other
# wire constants: api/types.py TRACE_ID_ANNOTATION.
HEADER = "X-Ktpu-Trace"


class SpanContext(NamedTuple):
    trace_id: str
    span_id: str


def new_id() -> str:
    return os.urandom(8).hex()


def format_context(ctx: SpanContext) -> str:
    return f"{ctx.trace_id}/{ctx.span_id}"


# ------------------------------------------------------------ active span

_tls = threading.local()


def current_span() -> Optional["Span"]:
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def inject_header() -> str:
    """Header value for an outgoing request: the active span's context, or
    a fresh root context so even un-instrumented callers get a trace id."""
    sp = current_span()
    if sp is not None:
        return format_context(sp.context())
    return format_context(SpanContext(new_id(), new_id()))


class Span:
    """One timed operation within a trace.  Context-manager use activates
    it on the thread (so Trace objects and outgoing requests attach);
    exit finishes it into its collector, recording an in-flight exception
    as `error=<ExcType>`."""

    __slots__ = ("name", "component", "trace_id", "span_id", "parent_id",
                 "fields", "logs", "error", "start_wall", "_t0",
                 "_collector", "_finished")

    def __init__(self, name: str, component: str = "",
                 trace_id: str = "", parent_id: str = "",
                 collector: Optional["SpanCollector"] = None, **fields):
        self.name = name
        self.component = component
        self.trace_id = trace_id or new_id()
        self.span_id = new_id()
        self.parent_id = parent_id
        self.fields: Dict[str, object] = dict(fields)
        self.logs: List[tuple] = []  # (elapsed_s, msg)
        self.error = ""
        self.start_wall = time.time()  # the span's start as users read it
        self._t0 = time.perf_counter()
        self._collector = collector
        self._finished = False

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def annotate(self, **fields):
        self.fields.update(fields)

    def log(self, msg: str):
        self.logs.append((time.perf_counter() - self._t0, msg))

    def finish(self, error: str = ""):
        if self._finished:
            return
        self._finished = True
        if error:
            self.error = error
        if self._collector is not None:
            self._collector.add(self)

    def to_dict(self) -> dict:
        return {
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentId": self.parent_id,
            "name": self.name,
            "component": self.component,
            "start": round(self.start_wall, 6),
            "durationMs": round((time.perf_counter() - self._t0) * 1000, 3),
            "fields": {k: str(v) for k, v in self.fields.items()},
            "logs": [f"[{at * 1000:.1f}ms] {msg}" for at, msg in self.logs],
            "error": self.error,
        }

    # -- context manager / thread activation --------------------------------

    def __enter__(self) -> "Span":
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        stack = getattr(_tls, "stack", None)
        if stack and stack[-1] is self:
            stack.pop()
        elif stack and self in stack:  # defensive: out-of-order exit
            stack.remove(self)
        self.finish(error=exc_type.__name__ if exc_type is not None else "")
        return False


class SpanCollector:
    """Bounded in-process store of finished spans, served at
    /debug/traces.  One per component; the deque keeps the newest
    CAPACITY spans (forensics wants the recent tail, not history)."""

    CAPACITY = 1024

    def __init__(self, component: str = ""):
        self.component = component
        self._spans: deque = deque(maxlen=self.CAPACITY)
        self._lock = threading.Lock()

    def start_span(self, name: str, parent=None, trace_id: str = "",
                   **fields) -> Span:
        """New span under this collector.  `parent` may be a SpanContext,
        a Span, or None; an explicit trace_id (e.g. from a pod annotation)
        wins when no parent context is available."""
        parent_id = ""
        if isinstance(parent, Span):
            trace_id, parent_id = parent.trace_id, parent.span_id
        elif isinstance(parent, SpanContext):
            trace_id, parent_id = parent.trace_id, parent.span_id
        elif parent is None and not trace_id:
            active = current_span()
            if active is not None:
                trace_id, parent_id = active.trace_id, active.span_id
        return Span(name, component=self.component, trace_id=trace_id,
                    parent_id=parent_id, collector=self, **fields)

    def add(self, span: Span):
        with self._lock:
            self._spans.append(span.to_dict())

    def spans(self, trace_id: str = "") -> List[dict]:
        with self._lock:
            out = list(self._spans)
        if trace_id:
            out = [s for s in out if s["traceId"] == trace_id]
        return out

    def to_json(self, trace_id: str = "") -> bytes:
        return json.dumps({
            "component": self.component,
            "spans": self.spans(trace_id),
        }, separators=(",", ":")).encode()
