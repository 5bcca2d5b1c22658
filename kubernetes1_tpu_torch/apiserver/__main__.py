"""The apiserver process (ref: cmd/kube-apiserver):

    python -m kubernetes1_tpu_torch apiserver --port 8001 [--host 127.0.0.1]

It serves the cluster's REST and watch surface from its in-memory store,
prints the line "ktpu-apiserver listening on <url>" once it serves, and
stops on SIGTERM or SIGINT.
"""

from __future__ import annotations

import argparse
import signal
import threading

from ..utils.procutil import bounded_exit
from .server import Master


def main():
    ap = argparse.ArgumentParser(description="the port's apiserver")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8001)
    args = ap.parse_args()
    master = Master(host=args.host, port=args.port).start()
    print(f"ktpu-apiserver listening on {master.url}", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()
    bounded_exit(5.0)
    master.stop()


if __name__ == "__main__":
    main()
