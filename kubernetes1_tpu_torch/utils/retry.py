"""Retry policy for the port's clients: capped exponential backoff with
full jitter, and a loop that retries transient failures.

The port's copy of the JAX package's ``client/retry.Backoff`` and
``call_with_retries``, and its retry counter (``retries_total``,
``note_retry``: the scheduler's bind re-queues and the controller
manager's retried deletes count there), without what
no caller of the port uses: the seeded jitter stream of the JAX package's
chaos runner and the Retry-After floor of its REST client.  Used by the
plugin client's dial (``deviceplugin/api.py``), ``LoadGen``
(``workloads/loadgen.py``), which classifies its own failures, the
apiserver client and its informer (``client/``, which keeps the
apiserver's ``retry_on_conflict``), ``servefleet`` and the scheduler.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, TypeVar

from .metrics import Counter

T = TypeVar("T")

# Every retry a control-plane client of the port takes, by reason (the
# JAX package's family of the same name): its scheduler's bind re-queues
# count here, and the scheduler process serves it on its /metrics.
retries_total = Counter("ktpu_client_retries_total", "client retries by reason")


def note_retry(reason: str) -> None:
    retries_total.labels(reason=reason).inc()


class Backoff:
    """Capped exponential backoff with FULL jitter: attempt n sleeps
    ~ U(0, min(cap, base * factor**n)).  Full jitter de-synchronizes a
    herd of identical clients after a shared failure."""

    def __init__(self, base: float = 0.02, factor: float = 2.0, cap: float = 1.0):
        self.base = base
        self.factor = factor
        self.cap = cap
        self._n = 0

    def next(self) -> float:
        d = random.uniform(0.0, min(self.cap, self.base * self.factor ** self._n))
        self._n += 1
        return d

    def reset(self) -> None:
        self._n = 0

    def sleep(self) -> None:
        time.sleep(self.next())


def call_with_retries(
    fn: Callable[[], T],
    classify: Callable[[BaseException], bool],
    steps: int = 4,
    backoff: Optional[Backoff] = None,
    reason: str = "",
) -> T:
    """Run fn, retrying the failures that ``classify`` calls transient
    with jittered backoff, each retry counted under ``reason`` when one is
    given.  Terminal errors, and the last attempt's, surface as-is."""
    bo = backoff or Backoff()
    for i in range(steps):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - classified right below; terminal re-raises
            if i == steps - 1 or not classify(e):
                raise
            if reason:
                note_retry(reason)
            bo.sleep()
    raise AssertionError("unreachable")  # pragma: no cover

