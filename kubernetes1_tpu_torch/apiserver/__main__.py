"""The apiserver process (ref: cmd/kube-apiserver):

    python -m kubernetes1_tpu_torch apiserver --port 8001 [--host 127.0.0.1]
    python -m kubernetes1_tpu_torch apiserver --port 6443 --authorization-mode Node,RBAC \
        --tls-cert-file pki/apiserver.crt --tls-key-file pki/apiserver.key \
        --client-ca-file pki/ca.crt --sa-key-file pki/sa.key \
        --token <admin token> --wal store.wal

It serves the cluster's REST and watch surface from its store, prints the
line "ktpu-apiserver listening on <url>" once it serves, and stops on
SIGTERM or SIGINT.  With ``--wal`` the store replays the log on start
and appends every commit to it, fsynced once a commit.
With no security flag it serves plain HTTP and every request as the
admin; ``--tls-cert-file`` makes it HTTPS only.
"""

from __future__ import annotations

import argparse
import signal
import threading

from ..utils.procutil import bounded_exit, read_key
from .server import Master


def main():
    ap = argparse.ArgumentParser(description="the port's apiserver")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8001)
    ap.add_argument("--wal", default="", help="write-ahead log path for durability")
    ap.add_argument("--token", default="", help="the admin's bearer token")
    ap.add_argument("--authorization-mode", default="AlwaysAllow",
                    help='AlwaysAllow | "Node,RBAC"')
    ap.add_argument("--sa-key-file", default="", help="service-account token signing key")
    ap.add_argument("--tls-cert-file", default="",
                    help="serve HTTPS with this cert (no plaintext fallback)")
    ap.add_argument("--tls-key-file", default="")
    ap.add_argument("--client-ca-file", default="",
                    help="CA bundle for x509 client-cert authn")
    args = ap.parse_args()
    master = Master(
        host=args.host, port=args.port, wal_path=args.wal or None,
        token=args.token, authorization_mode=args.authorization_mode,
        sa_signing_key=read_key(args.sa_key_file, "ktpu-sa-key"),
        tls_cert_file=args.tls_cert_file, tls_key_file=args.tls_key_file,
        client_ca_file=args.client_ca_file,
    ).start()
    print(f"ktpu-apiserver listening on {master.url}", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()
    bounded_exit(5.0)
    master.stop()


if __name__ == "__main__":
    main()
