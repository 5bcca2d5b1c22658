"""The scheduler process (ref: plugin/cmd/kube-scheduler):

    python -m kubernetes1_tpu_torch scheduler --server http://127.0.0.1:8001

It serves /metrics, /healthz, /readyz and /debug/traces on
``--metrics-port`` (-1: none), prints a line for each pod it binds, and
stops on SIGTERM or SIGINT.
"""

from __future__ import annotations

import argparse
import gc
import os
import signal
import threading

from ..client.clientset import Clientset
from ..utils import retry as _retry
from .scheduler import Scheduler


def _tune_gc():
    """A long-lived control-plane process keeps every API object it decodes
    (the informers' caches): move the heap built at start out of the
    collector's sight and collect the young generation less often (the
    JAX package's ``utils/gctune``)."""
    gc.freeze()
    gc.set_threshold(200000, 50, 50)


def _bounded_exit(delay: float = 5.0, code: int = 1) -> threading.Timer:
    """Hard-exit, nonzero, if a graceful stop hangs (a dead apiserver must
    not leave the process in informer retries forever)."""
    timer = threading.Timer(delay, lambda: os._exit(code))
    timer.daemon = True
    timer.start()
    return timer


def main():
    ap = argparse.ArgumentParser(description="the port's scheduler")
    ap.add_argument("--server", default="http://127.0.0.1:8001")
    ap.add_argument("--metrics-port", type=int, default=10251,
                    help="/metrics + /healthz port (0 = ephemeral, -1 = off)")
    args = ap.parse_args()
    _tune_gc()
    cs = Clientset(args.server)
    sched = Scheduler(
        cs, metrics_port=None if args.metrics_port < 0 else args.metrics_port)
    # the process serves its client's retries on its own /metrics
    sched.metrics.register(_retry.retries_total)
    stop = threading.Event()
    sched.start()
    print("scheduler running", flush=True)
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()
    _bounded_exit(5.0)
    sched.stop()


if __name__ == "__main__":
    main()
