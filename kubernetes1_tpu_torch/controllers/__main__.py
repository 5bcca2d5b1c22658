"""The controller manager process (ref: cmd/kube-controller-manager):

    python -m kubernetes1_tpu_torch controller-manager --server http://127.0.0.1:8001

It runs the port's control loops (``manager.ControllerManager``), serves
/metrics and /healthz on ``--metrics-port`` (-1: none; 0: a free port,
printed), prints ``controller manager running`` once the loops run, and
stops on SIGTERM or SIGINT with exit code 0.
"""

from __future__ import annotations

import argparse
import signal
import threading

from ..client.clientset import Clientset
from ..utils import retry as _retry
from ..utils.metrics import MetricsServer, Registry
from ..utils.procutil import bounded_exit
from . import endpoints as _eps
from . import job as _job
from .manager import ControllerManager


def read_key(path: str, default: str) -> str:
    """A key file's content when a path is given, else the default."""
    if not path:
        return default
    with open(path) as f:
        return f.read().strip()


def registry(cm: ControllerManager) -> Registry:
    """The metric families of the process's control loops."""
    reg = Registry()
    for metric in (_job.gang_recovery_seconds, _job.gang_attempts_total,
                   _eps.endpoints_writes_total, _eps.endpoints_coalesced_total,
                   _eps.endpoints_propagation_seconds, cm.node_lifecycle.evictions_total,
                   cm.node_lifecycle.errors_total, cm.node_lifecycle.not_ready_total,
                   _retry.retries_total):
        reg.register(metric)
    return reg


def main():
    ap = argparse.ArgumentParser(description="the port's controller manager")
    ap.add_argument("--server", default="http://127.0.0.1:8001")
    ap.add_argument("--metrics-port", type=int, default=-1,
                    help="/metrics + /healthz port (0 = ephemeral, -1 = off): the gang "
                         "failure-domain surface (ktpu_gang_recovery_seconds, attempts), the "
                         "Endpoints writes and the node eviction counters")
    ap.add_argument("--node-monitor-grace", type=float, default=40.0)
    ap.add_argument("--pod-eviction-timeout", type=float, default=300.0)
    ap.add_argument("--endpoints-coalesce-ms", type=float, default=0.0,
                    help="endpoints fan-out coalesce window in ms (0 = one Endpoints write "
                         "per pod event); >0 batches a service's churn into one write per "
                         "window")
    ap.add_argument("--sa-key-file", default="", help="SA token signing key")
    args = ap.parse_args()

    cs = Clientset(args.server)
    cm = ControllerManager(
        cs,
        monitor_grace=args.node_monitor_grace,
        eviction_timeout=args.pod_eviction_timeout,
        sa_signing_key=read_key(args.sa_key_file, "ktpu-sa-key"),
        endpoints_coalesce_window=args.endpoints_coalesce_ms / 1000.0,
    )
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    cm.start()
    metrics_server = None
    if args.metrics_port >= 0:
        try:
            metrics_server = MetricsServer(registry(cm), port=args.metrics_port).start()
            print(f"controller manager metrics on {metrics_server.url}", flush=True)
        except OSError as e:
            # a busy port must not take down the control loops
            print(f"controller manager: metrics endpoint unavailable "
                  f"(port {args.metrics_port}): {e}", flush=True)
    print("controller manager running", flush=True)
    stop.wait()
    bounded_exit(5.0)
    if metrics_server is not None:
        metrics_server.stop()
    cm.stop()


if __name__ == "__main__":
    main()
