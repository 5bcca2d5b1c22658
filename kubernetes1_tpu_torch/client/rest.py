"""The port's REST client of the apiserver, in the wire form.

``Client(url)`` speaks the apiserver's HTTP surface: objects go in and
come out as the JSON dicts the apiserver stores (the JAX package's
``to_dict`` form, camelCase keys, defaults left out), errors come back as
``errors.ApiError`` built from the Status body, and a failure of the
transport as an ``OSError`` (a broken HTTP exchange as ``ConnectionError``).
Each thread keeps one keep-alive connection; a watch gets a connection of
its own, whose line-delimited ``{"type", "object"}`` frames it yields,
skipping the blank heartbeat lines.

An ``https://`` URL dials TLS: the server is verified against
``ca_file`` (the system's CAs without one), ``cert_file``/``key_file``
present an x509 client certificate (CN the user, O the groups), and
``insecure`` skips the server's verification, for the join-time discovery
of the cluster CA only.  A ``token`` rides every request and watch as a
bearer header.

Only the verbs and resources the port calls are here: ``create``,
``get``, ``list``, ``update``, ``update_status`` (the status
subresource), ``patch``, ``delete`` and ``watch`` on the resources of
``RESOURCES`` (those the port's components and its controller manager
read or write, and the rest the CLI reaches), plus the pods' ``delete:batch`` and ``log``.  Every request carries
the thread's trace context (``utils/spans``), so the apiserver's handling
joins the caller's trace.
"""

from __future__ import annotations

import http.client
import json
import select
import socket
import ssl
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple
from urllib.parse import urlencode, urlparse

from ..utils import spans
from ..utils.retry import Backoff
from .errors import ApiError

# Each resource's API group path, kind and apiVersion (the JAX package's
# clientset computes the same paths).
RESOURCES = {
    "pods": ("/api/v1", "Pod", "v1"),
    "events": ("/api/v1", "Event", "v1"),
    "services": ("/api/v1", "Service", "v1"),
    "endpoints": ("/api/v1", "Endpoints", "v1"),
    "nodes": ("/api/v1", "Node", "v1"),
    "jobs": ("/apis/batch/v1", "Job", "batch/v1"),
    "deployments": ("/apis/apps/v1", "Deployment", "apps/v1"),
    "poddisruptionbudgets": ("/apis/policy/v1", "PodDisruptionBudget", "policy/v1"),
    "replicasets": ("/apis/apps/v1", "ReplicaSet", "apps/v1"),
    "daemonsets": ("/apis/apps/v1", "DaemonSet", "apps/v1"),
    "statefulsets": ("/apis/apps/v1", "StatefulSet", "apps/v1"),
    "cronjobs": ("/apis/batch/v1", "CronJob", "batch/v1"),
    "namespaces": ("/api/v1", "Namespace", "v1"),
    "serviceaccounts": ("/api/v1", "ServiceAccount", "v1"),
    "secrets": ("/api/v1", "Secret", "v1"),
    "configmaps": ("/api/v1", "ConfigMap", "v1"),
    "persistentvolumeclaims": ("/api/v1", "PersistentVolumeClaim", "v1"),
    "resourcequotas": ("/api/v1", "ResourceQuota", "v1"),
    "limitranges": ("/api/v1", "LimitRange", "v1"),
    "horizontalpodautoscalers": ("/apis/autoscaling/v1", "HorizontalPodAutoscaler",
                                 "autoscaling/v1"),
    "persistentvolumes": ("/api/v1", "PersistentVolume", "v1"),
    "podmetrics": ("/apis/metrics.k8s.io/v1", "PodMetrics", "metrics.k8s.io/v1"),
    "nodemetrics": ("/apis/metrics.k8s.io/v1", "NodeMetrics", "metrics.k8s.io/v1"),
    "podcustommetrics": ("/apis/custom.metrics.k8s.io/v1", "PodCustomMetrics",
                         "custom.metrics.k8s.io/v1"),
    # the rest of what the port's scheme registers, for the CLI
    "priorityclasses": ("/apis/scheduling/v1", "PriorityClass", "scheduling/v1"),
    "storageclasses": ("/api/v1", "StorageClass", "storage.k8s.io/v1"),
    "certificatesigningrequests": ("/apis/certificates/v1", "CertificateSigningRequest",
                                   "certificates/v1"),
    "roles": ("/apis/rbac/v1", "Role", "rbac/v1"),
    "clusterroles": ("/apis/rbac/v1", "ClusterRole", "rbac/v1"),
    "rolebindings": ("/apis/rbac/v1", "RoleBinding", "rbac/v1"),
    "clusterrolebindings": ("/apis/rbac/v1", "ClusterRoleBinding", "rbac/v1"),
}
CLUSTER_SCOPED = frozenset({"nodes", "namespaces", "persistentvolumes", "nodemetrics",
                            "priorityclasses", "storageclasses", "certificatesigningrequests",
                            "clusterroles", "clusterrolebindings"})
# A GET is retried over this many connection failures; a write only when it
# failed before it was sent (the connect refused or reset), since a write
# whose answer was lost may have been applied.  An idle keep-alive socket
# that the server has closed is dropped before a request goes out on it.
GET_ATTEMPTS = 4
WRITE_ATTEMPTS = 2


def client_ssl_context(ca_file: str = "", cert_file: str = "", key_file: str = "",
                       insecure: bool = False) -> ssl.SSLContext:
    """The TLS context of a client of the cluster: the cluster CA verifies
    the server, and a client certificate, when given, is the x509
    credential (CN=user, O=groups).  No ``ca_file`` is not an opt-out:
    ``insecure`` is (join-time discovery dials unverified once, pins the
    CA's hash, then reconnects verified)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    if insecure:
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    elif ca_file:
        ctx.load_verify_locations(cafile=ca_file)
    else:
        ctx.load_default_certs(ssl.Purpose.SERVER_AUTH)
    if cert_file:
        ctx.load_cert_chain(certfile=cert_file, keyfile=key_file or None)
    return ctx


def _raise_transport(method: str, path: str, exc: BaseException):
    """Raise ``exc`` as an OSError: a broken HTTP exchange (a truncated
    body, an overlong line) as a ConnectionError, so that every caller's
    ``except OSError`` sees it."""
    if isinstance(exc, OSError):
        raise exc
    raise ConnectionError(f"{method} {path}: {exc!r}") from exc


def _raise_for(method: str, path: str, code: int, raw: bytes):
    try:
        data = json.loads(raw) if raw else {}
    except ValueError:
        data = {}
    if isinstance(data, dict) and data.get("kind") == "Status":
        raise ApiError.from_status(data)
    raise ApiError(f"{method} {path}: HTTP {code}", code=code)


class WatchStream:
    """The (type, object) frames of one watch; ``close()`` ends it from
    another thread."""

    def __init__(self, conn: http.client.HTTPConnection, resp: http.client.HTTPResponse):
        self._conn = conn
        self._resp = resp
        self._closed = False

    def __iter__(self) -> Iterator[Tuple[str, dict]]:
        try:
            while not self._closed:
                line = self._resp.readline()
                if not line:
                    return
                line = line.strip()
                if line:
                    frame = json.loads(line)
                    yield frame["type"], frame["object"]
        except (http.client.HTTPException, OSError, ValueError, AttributeError):
            return  # a cut stream ends like a closed one; AttributeError: close() raced

    def close(self):
        self._closed = True
        sock = self._conn.sock
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)  # wakes a reader blocked in recv()
            except OSError:
                pass
        self._conn.close()


class ResourceClient:
    """One resource's verbs, under its API group path."""

    def __init__(self, client: "Client", plural: str):
        self.client = client
        self.resource = plural
        self._base, self.kind, self.api_version = RESOURCES[plural]
        self.namespaced = plural not in CLUSTER_SCOPED

    def path(self, namespace: str = "", name: str = "", sub: str = "") -> str:
        parts = [self._base]
        if self.namespaced and namespace:
            parts.append(f"namespaces/{namespace}")
        parts += [p for p in (self.resource, name, sub) if p]
        return "/".join(parts)

    def _body(self, obj: dict) -> dict:
        return {"kind": self.kind, "apiVersion": self.api_version, **obj}

    def create(self, obj: dict, namespace: str = "") -> dict:
        ns = namespace or (obj.get("metadata") or {}).get("namespace") or "default"
        return self.client.request("POST", self.path(ns), self._body(obj))

    def get(self, name: str, namespace: str = "default") -> dict:
        return self.client.request("GET", self.path(namespace, name))

    def list(self, namespace: str = "", label_selector: str = "",
             field_selector: str = "") -> Tuple[List[dict], str]:
        """(items, the list's resourceVersion)."""
        data = self.client.request("GET", self.path(namespace),
                                   params={"labelSelector": label_selector,
                                           "fieldSelector": field_selector})
        return data.get("items") or [], (data.get("metadata") or {}).get("resourceVersion", "0")

    def update(self, obj: dict) -> dict:
        meta = obj["metadata"]
        return self.client.request("PUT", self.path(meta.get("namespace", ""), meta["name"]),
                                   self._body(obj))

    def update_status(self, obj: dict) -> dict:
        """PUT the status subresource: only the object's status is written."""
        meta = obj["metadata"]
        return self.client.request(
            "PUT", self.path(meta.get("namespace", ""), meta["name"], "status"), self._body(obj))

    def patch(self, name: str, patch: dict, namespace: str = "default") -> dict:
        """A merge patch of the object."""
        return self.client.request("PATCH", self.path(namespace, name), patch)

    def delete(self, name: str, namespace: str = "default",
               grace_seconds: Optional[int] = None) -> dict:
        params = {} if grace_seconds is None else {"gracePeriodSeconds": str(grace_seconds)}
        return self.client.request("DELETE", self.path(namespace, name), params=params)

    def watch(self, namespace: str = "", label_selector: str = "",
              resource_version: str = "0", field_selector: str = "") -> WatchStream:
        return self.client.watch(self.path(namespace), {
            "resourceVersion": resource_version, "labelSelector": label_selector,
            "fieldSelector": field_selector})


class Client:
    """The apiserver at ``url`` (``http://host:port`` or ``https://...``)."""

    def __init__(self, url: str, timeout: float = 30.0, token: str = "",
                 ca_file: str = "", cert_file: str = "", key_file: str = "",
                 insecure: bool = False):
        self.url = url.rstrip("/")
        p = urlparse(self.url)
        self.tls = p.scheme == "https"
        self.host, self.port = p.hostname or "127.0.0.1", p.port or (443 if self.tls else 80)
        self.timeout = timeout
        self.token = token
        self.ssl_context: Optional[ssl.SSLContext] = (
            client_ssl_context(ca_file, cert_file, key_file, insecure) if self.tls else None)
        self._local = threading.local()
        self._resources = {plural: ResourceClient(self, plural) for plural in RESOURCES}
        self.pods = self._resources["pods"]
        self.events = self._resources["events"]
        self.services = self._resources["services"]
        self.endpoints = self._resources["endpoints"]
        self.nodes = self._resources["nodes"]
        self.jobs = self._resources["jobs"]
        self.deployments = self._resources["deployments"]
        self.poddisruptionbudgets = self._resources["poddisruptionbudgets"]

    def resource(self, plural: str) -> ResourceClient:
        return self._resources[plural]

    # ------------------------------------------------------------ plumbing

    def _connect(self, timeout: Optional[float]) -> http.client.HTTPConnection:
        if self.tls:
            conn = http.client.HTTPSConnection(self.host, self.port, timeout=timeout,
                                               context=self.ssl_context)
        else:
            conn = http.client.HTTPConnection(self.host, self.port, timeout=timeout)
        conn.connect()
        # the body goes out in a second send: without NODELAY, Nagle holds it
        # behind the server's delayed ACK
        conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return conn

    def _drop_conn(self):
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None

    def _conn(self) -> http.client.HTTPConnection:
        """This thread's connection.  An idle keep-alive socket that reads
        as ready holds the server's close (EOF or a reset), not an answer:
        it is dropped before a request is written to it."""
        conn = getattr(self._local, "conn", None)
        if conn is not None and conn.sock is not None \
                and select.select([conn.sock], [], [], 0)[0]:
            self._drop_conn()
            conn = None
        if conn is None:
            conn = self._local.conn = self._connect(self.timeout)
        return conn

    def auth_headers(self) -> Dict[str, str]:
        """Accept JSON, and the bearer token when the client holds one."""
        h = {"Accept": "application/json"}
        if self.token:
            h["Authorization"] = f"Bearer {self.token}"
        return h

    @staticmethod
    def _full(path: str, params: Optional[Dict[str, str]]) -> str:
        params = {k: v for k, v in (params or {}).items() if v != ""}
        return path + ("?" + urlencode(params) if params else "")

    def _roundtrip(self, method: str, path: str, payload: Optional[bytes]) -> Tuple[int, bytes]:
        attempts = GET_ATTEMPTS if method == "GET" else WRITE_ATTEMPTS
        backoff = Backoff(base=0.02, cap=0.5)
        for attempt in range(attempts):
            sent = False
            try:
                conn = self._conn()
                conn.request(method, path, body=payload,
                             headers={"Content-Type": "application/json",
                                      **self.auth_headers(),
                                      spans.HEADER: spans.inject_header()})
                sent = True
                resp = conn.getresponse()
                return resp.status, resp.read()
            except (http.client.HTTPException, OSError) as e:
                self._drop_conn()
                if attempt == attempts - 1 or (sent and method != "GET"):
                    _raise_transport(method, path, e)
                backoff.sleep()
        raise AssertionError("unreachable")  # pragma: no cover

    def request(self, method: str, path: str, body: Any = None,
                params: Optional[Dict[str, str]] = None, raw: bool = False) -> Any:
        """One call: the decoded JSON answer (the bytes with ``raw``);
        raises ``ApiError`` on a status of 400 or more."""
        full = self._full(path, params)
        payload = None if body is None else json.dumps(body).encode()
        code, data = self._roundtrip(method, full, payload)
        if code >= 400:
            _raise_for(method, full, code, data)
        if raw:
            return data
        return json.loads(data) if data else {}

    def watch(self, path: str, params: Optional[Dict[str, str]] = None) -> WatchStream:
        full = self._full(path, {**(params or {}), "watch": "true"})
        conn = self._connect(None)
        try:
            conn.request("GET", full, headers=self.auth_headers())
            resp = conn.getresponse()
        except (http.client.HTTPException, OSError) as e:
            conn.close()
            _raise_transport("WATCH", full, e)
        if resp.status >= 400:
            data = resp.read()
            conn.close()
            _raise_for("WATCH", full, resp.status, data)
        return WatchStream(conn, resp)

    # ----------------------------------------------------------- the rest

    def healthz(self) -> bool:
        """True when the apiserver answers /healthz with ok."""
        try:
            return self.request("GET", "/healthz") == {"status": "ok"}
        except (ApiError, OSError, ValueError):
            return False

    def delete_batch(self, namespace: str, items, grace_seconds: Optional[int] = None) -> list:
        """Delete pods in one ``pods/delete:batch`` call, which the apiserver
        commits together.  ``items`` are names or dicts (``{"name",
        "resourceVersion"?, "gracePeriodSeconds"?}``); ``grace_seconds``
        applies to every item without its own.  One outcome an item, in
        order: None, or the ApiError that sank that item."""
        body = []
        for it in items:
            d = {"name": it} if isinstance(it, str) else dict(it)
            if grace_seconds is not None:
                d.setdefault("gracePeriodSeconds", grace_seconds)
            body.append(d)
        data = self.request("POST", f"/api/v1/namespaces/{namespace}/pods/delete:batch",
                            {"kind": "DeleteBatch", "apiVersion": "v1", "items": body})
        return [None if r.get("status") == "Success" else ApiError.from_status(r)
                for r in data.get("results", [])]

    def pod_log(self, name: str, namespace: str = "default") -> str:
        return self.request("GET", self.pods.path(namespace, name, "log"),
                            raw=True).decode(errors="replace")

    def close(self):
        """Close this thread's connection."""
        self._drop_conn()
