"""Rate-limited reporting for best-effort paths: count every drop, print
at most one summary line a window (the port's copy of the JAX package's
``utils/logutil.py``)."""

from __future__ import annotations

import sys
import time


class RateLimitedReporter:
    """Count occurrences; print one ``<prefix>: dropped N (<detail>)``
    line per ``window`` seconds.  The first occurrence after a quiet
    period reports at once, so a single failure is never silent.  Meant
    for one thread at a time: a lost increment under concurrent use only
    undercounts a log line."""

    def __init__(self, prefix: str, window: float = 5.0):
        self.prefix = prefix
        self.window = window
        self._count = 0
        self._last = 0.0

    def report(self, detail: str, n: int = 1):
        self._count += n
        now = time.monotonic()
        if now - self._last >= self.window:
            print(f"{self.prefix}: dropped {self._count} ({detail})",
                  file=sys.stderr)
            self._count = 0
            self._last = now
