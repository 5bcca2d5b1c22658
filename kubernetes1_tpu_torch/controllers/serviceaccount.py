"""ServiceAccount + token controllers (ref: pkg/controller/serviceaccount/
serviceaccounts_controller.go + tokens_controller.go): every namespace gets a
'default' ServiceAccount; every ServiceAccount gets a signed token Secret
referenced from .secrets. Tokens are HMAC-signed with the cluster's service
account key (the reference signs JWTs with the --service-account-key-file
RSA key; the construction here is the same shape without an x509 stack).
The port's copy of the JAX package's ``controllers/serviceaccount.py``: the
same token, byte for byte, for the same key."""

from __future__ import annotations

import base64
import hashlib
import hmac
import json

from ..api import types as t
from ..machinery import AlreadyExists, ApiError, NotFound
from .base import Controller

TOKEN_SECRET_TYPE = "kubernetes.io/service-account-token"


def sign_token(key: str, namespace: str, name: str, uid: str) -> str:
    """Compact HMAC token: base64(payload).base64(hmac)."""
    payload = json.dumps(
        {"sub": f"system:serviceaccount:{namespace}:{name}", "uid": uid},
        sort_keys=True, separators=(",", ":"),
    ).encode()
    mac = hmac.new(key.encode(), payload, hashlib.sha256).digest()
    return (
        base64.urlsafe_b64encode(payload).rstrip(b"=").decode()
        + "."
        + base64.urlsafe_b64encode(mac).rstrip(b"=").decode()
    )


class ServiceAccountController(Controller):
    name = "serviceaccount-controller"
    WORKERS = 1

    def __init__(self, clientset, factory, signing_key: str = "ktpu-sa-key"):
        super().__init__(clientset, factory)
        self.signing_key = signing_key

    def setup(self):
        self.namespaces = self.factory.informer("namespaces")
        self.serviceaccounts = self.factory.informer("serviceaccounts")
        self.namespaces.add_handler(
            on_add=self.enqueue, on_update=lambda _o, n: self.enqueue(n)
        )
        self.serviceaccounts.add_handler(
            on_add=self._sa_event,
            on_update=lambda _o, n: self._sa_event(n),
            on_delete=self._sa_event,
        )

    def _sa_event(self, sa: t.ServiceAccount):
        ns = self.namespaces.get(sa.metadata.namespace)
        if ns is not None:
            self.enqueue(ns)

    def sync(self, key: str):
        ns = self.namespaces.get(key)
        if ns is None or ns.status.phase == "Terminating":
            return
        nsname = ns.metadata.name
        try:
            sa = self.cs.serviceaccounts.get("default", nsname)
        except NotFound:
            sa = t.ServiceAccount()
            sa.metadata.name = "default"
            sa.metadata.namespace = nsname
            try:
                sa = self.cs.serviceaccounts.create(sa, nsname)
            except AlreadyExists:
                sa = self.cs.serviceaccounts.get("default", nsname)
        self._ensure_token(sa)
        # tokens for any other ServiceAccounts in this namespace
        for other in self.serviceaccounts.list():
            if other.metadata.namespace == nsname and other.metadata.name != "default":
                self._ensure_token(other)

    def _ensure_token(self, sa: t.ServiceAccount):
        """Token controller half: mint the token Secret and link it."""
        if sa.secrets:
            return
        secret = t.Secret(type=TOKEN_SECRET_TYPE)
        secret.metadata.name = f"{sa.metadata.name}-token"
        secret.metadata.namespace = sa.metadata.namespace
        secret.data = {
            "token": sign_token(
                self.signing_key, sa.metadata.namespace, sa.metadata.name,
                sa.metadata.uid,
            ),
            "namespace": sa.metadata.namespace,
        }
        try:
            self.cs.secrets.create(secret, sa.metadata.namespace)
        except AlreadyExists:
            pass
        try:
            fresh = self.cs.serviceaccounts.get(sa.metadata.name, sa.metadata.namespace)
            if not fresh.secrets:
                fresh.secrets = [
                    t.ObjectReference(
                        kind="Secret", namespace=sa.metadata.namespace,
                        name=secret.metadata.name,
                    )
                ]
                self.cs.serviceaccounts.update(fresh)
        except ApiError:
            pass  # requeue via event
