"""Polling helpers (ref: apimachinery util/wait/wait.go): the port's copy of
the JAX package's ``utils/waitutil.py``."""

from __future__ import annotations

import time
from typing import Callable


def poll_until(
    condition: Callable[[], bool],
    interval: float = 0.05,
    timeout: float = 10.0,
    desc: str = "condition",
) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if condition():
            return True
        time.sleep(interval)
    return False


def must_poll_until(condition, interval=0.05, timeout=10.0, desc="condition"):
    if not poll_until(condition, interval, timeout, desc):
        raise TimeoutError(f"timed out waiting for {desc}")
