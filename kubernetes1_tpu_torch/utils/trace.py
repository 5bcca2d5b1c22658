"""Operation tracing: named steps, logged only when the whole op is slow.

The port's copy of the JAX package's ``utils/trace.py`` (ref:
apiserver's util/trace/trace.go): a hot operation (the scheduler's
attempt) makes a Trace, calls ``step(...)`` at milestones and
``log_if_long()`` at its end; nothing is printed on the fast path, and a
slow op prints every step with its latency.  Steps also land on the
thread's active span (``utils/spans``).
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional, Tuple

from . import spans


class Trace:
    """utiltrace.Trace analog:

        tr = Trace("scheduling", threshold=0.1, pod="ns/name")
        tr.step("computed predicates")
        tr.step("prioritized")
        tr.log_if_long()  # prints every step iff the op took >= threshold
    """

    def __init__(self, name: str, threshold: Optional[float] = None, **fields):
        self.name = name
        self.threshold = threshold
        self.fields = fields
        self._t0 = time.perf_counter()
        self._steps: List[Tuple[float, str]] = []
        # attach to the thread's active span (utils/spans): the slow-op log
        # line carries the trace id, and steps land on the span too, so
        # /debug/traces and the step log cross-reference each other
        self._span = spans.current_span()
        if self._span is not None:
            self.fields.setdefault("trace", self._span.trace_id)

    def step(self, msg: str):
        self._steps.append((time.perf_counter() - self._t0, msg))
        if self._span is not None:
            self._span.log(f"{self.name}: {msg}")

    def log_if_long(self):
        total = time.perf_counter() - self._t0
        if self.threshold is None or total < self.threshold:
            return
        tag = " ".join(f"{k}={v}" for k, v in self.fields.items())
        lines = [f'Trace "{self.name}"{(" " + tag) if tag else ""} '
                 f"(total {total * 1000:.1f}ms, threshold {self.threshold * 1000:.0f}ms):"]
        prev = 0.0
        for at, msg in self._steps:
            lines.append(f"  [{at * 1000:8.1f}ms] (+{(at - prev) * 1000:.1f}ms) {msg}")
            prev = at
        lines.append(f"  [{total * 1000:8.1f}ms] end")
        print("\n".join(lines), file=sys.stderr)
