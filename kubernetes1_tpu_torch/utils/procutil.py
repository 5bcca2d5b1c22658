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


def read_key(path: str, default: str) -> str:
    """A key file's content when a path is given, else the default."""
    if not path:
        return default
    with open(path) as f:
        return f.read().strip()


def add_client_args(ap) -> None:
    """The client flags of every component that dials the apiserver (ref:
    each cmd/* --kubeconfig): ``--kubeconfig`` overrides ``--server``,
    ``--token``, ``--ca-file`` and ``--client-{cert,key}-file``."""
    ap.add_argument("--token", default="", help="bearer token")
    ap.add_argument("--kubeconfig", default="",
                    help='JSON {"server","token"?,"ca"?,"cert"?,"key"?}')
    ap.add_argument("--ca-file", default="",
                    help="CA bundle to verify the apiserver's TLS cert")
    ap.add_argument("--client-cert-file", default="",
                    help="x509 client cert (CN=user, O=groups)")
    ap.add_argument("--client-key-file", default="")


def clientset_from_args(args):
    """The component's Clientset from the ``add_client_args`` flags."""
    from ..client.clientset import Clientset

    if args.kubeconfig:
        return Clientset.from_config(args.kubeconfig)
    return Clientset(args.server, token=args.token, ca_file=args.ca_file,
                     cert_file=args.client_cert_file, key_file=args.client_key_file)
