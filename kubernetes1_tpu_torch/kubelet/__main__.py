"""The kubelet process (ref: cmd/kubelet):

    python -m kubernetes1_tpu_torch kubelet --server http://127.0.0.1:8001 \
        --node-name $(hostname) --runtime process --plugin-dir D --root-dir R
    python -m kubernetes1_tpu_torch kubelet --kubeconfig kubelet.conf --node-name N \
        --root-dir R --tls-cert-file pki/kubelet.crt --tls-key-file pki/kubelet.key

It registers the node with the cards its device plugins advertise, runs
the pods bound to it in the process runtime (``--runtime fake``: the
hollow runtime, only when asked), and stops on SIGTERM or SIGINT with
exit code 0.  ``--tls-cert-file`` makes its server HTTPS only (``ktpu
init`` gives it the node's dual-EKU certificate, which is also its client
credential through ``--kubeconfig``).  It prints whether its cluster DNS
runs, its server's URL, then ``kubelet <node> running (<runtime> runtime)``.
"""

from __future__ import annotations

import argparse
import signal
import threading

from ..deviceplugin.api import DEFAULT_PLUGIN_DIR
from ..utils.procutil import add_client_args, bounded_exit, clientset_from_args
from .kubelet import Kubelet
from .runtime import FakeRuntime, ProcessRuntime


def main():
    ap = argparse.ArgumentParser(description="the port's kubelet")
    ap.add_argument("--server", default="http://127.0.0.1:8001")
    ap.add_argument("--node-name", default="node-0")
    ap.add_argument("--runtime", choices=["process", "fake"], default="process")
    ap.add_argument("--plugin-dir", default=DEFAULT_PLUGIN_DIR)
    ap.add_argument("--root-dir", default="/tmp/ktpu")
    ap.add_argument("--tls-cert-file", default="",
                    help="serving cert for the kubelet server (:10250 TLS)")
    ap.add_argument("--tls-key-file", default="")
    add_client_args(ap)
    args = ap.parse_args()

    runtime = ProcessRuntime(root_dir=args.root_dir) if args.runtime == "process" \
        else FakeRuntime()
    cs = clientset_from_args(args)
    kubelet = Kubelet(cs, node_name=args.node_name, runtime=runtime,
                      plugin_dir=args.plugin_dir, server_tls_cert_file=args.tls_cert_file,
                      server_tls_key_file=args.tls_key_file)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    kubelet.start()
    name = args.node_name
    dns = kubelet.cluster_dns
    if dns is not None:
        print(f"kubelet {name}: cluster DNS on {dns.ip}:{dns.port}", flush=True)
    else:
        print(f"kubelet {name}: no cluster DNS ({kubelet.cluster_dns_error or 'hollow runtime'})",
              flush=True)
    print(f"kubelet {name} server on {kubelet.server.url}", flush=True)
    print(f"kubelet {name} running ({args.runtime} runtime)", flush=True)
    stop.wait()
    bounded_exit(5.0)
    kubelet.stop()


if __name__ == "__main__":
    main()
