"""Helpers of the port's component processes (the JAX package's
``utils/procutil.py``)."""

from __future__ import annotations

import os
import threading


def bounded_exit(delay: float = 5.0, code: int = 1) -> threading.Timer:
    """Hard-exit, nonzero, if a graceful stop hangs (a dead apiserver must
    not leave the process in informer retries forever)."""
    timer = threading.Timer(delay, lambda: os._exit(code))
    timer.daemon = True
    timer.start()
    return timer
