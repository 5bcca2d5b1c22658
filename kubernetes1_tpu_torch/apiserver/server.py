"""HTTP API server: REST and streaming watch over the registry, the port's
copy of the JAX package's ``apiserver/server.py`` for the routes its
control plane uses (ref: cmd/kube-apiserver, staging/src/k8s.io/
apiserver/pkg/server).

The wire is the JAX apiserver's, frame for frame, so that the JAX
controller manager and kubelet run against this one unchanged: JSON
objects, List kinds with a resourceVersion to resume a watch from, and
watches as line-delimited ``{"type", "object"}`` frames over chunked
HTTP, with blank-line heartbeats, opt-in progress and lag-stamp BOOKMARK
frames, and a 410 ERROR frame when the stream cannot go on gap-free.

Routes: GET (one object, LIST with label and field selectors and
``limit``/``continue``, WATCH), POST (create, ``pods/NAME/binding``,
``pods/bindings:batch``, ``pods/delete:batch``, ``pods/NAME/eviction``,
``selfsubjectaccessreviews``), PUT (update, ``status``), merge PATCH,
DELETE, the pod log proxy to the kubelet, the stream proxy of
``pods/NAME/exec``, ``attach`` and ``portforward`` (GET or POST with
``Upgrade: ktpu-stream``: the client's upgraded connection spliced onto
the kubelet's, ``utils/streams``), ``/healthz`` (``/readyz``,
``/livez``), ``/metrics`` and ``/debug/traces``.  Mutating requests past
``_InflightLimiter.MAX_MUTATING`` in flight are shed with 429 and Retry-After;
reads never are.  Each watch is served on its handler thread.

Security, as the JAX apiserver's (``auth.py``): each request's user is
the verified TLS client certificate's subject (CN the name, O the
groups), else its bearer token's (static, service account, bootstrap),
else anonymous; a presented bad token is 401.  The
authorizer chain of ``authorization_mode`` ("AlwaysAllow", or a list of
"Node", "RBAC", "AlwaysAllow") gates every request but /healthz and
/metrics, and answers SelfSubjectAccessReviews; system:masters is always
allowed.  With no security option every request is the admin, as before.
A ``token`` under AlwaysAllow is the legacy shared-secret mode: the token
(or a verified client certificate) is required, and is the admin.  With
``tls_cert_file`` the port speaks HTTPS only, asks for an optional client
certificate against ``client_ca_file`` (bearer-token clients handshake
without one), and handshakes in the request's thread; the dial to an
https kubelet verifies it against the same CA.

Left out, with the JAX flags that reach them (ROADMAP): the OIDC and
webhook authenticators, audit, CRDs and APIService proxying, the custom
metrics reads, the bind stream and its binary
codec, the event-loop watch dispatcher, write coalescing and
multi-version serving.
"""

from __future__ import annotations

import base64
import binascii
import bisect
import http.client
import json
import socket
import ssl
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ..api import types as t
from ..machinery.errors import (ApiError, BadRequest, Forbidden, NotFound, TooManyRequests,
                                TooOldResourceVersion, Unauthorized)
from ..machinery.scheme import global_scheme
from ..machinery.watch import ERROR
from ..storage import Cacher, Store
from ..utils import spans as spanlib
from ..utils import streams
from .admission import (CREATE, UPDATE, AdmissionChain, DefaultTolerationSeconds,
                        EventRateLimit, ExtendedResourceToleration, GangDefaulter,
                        IdentityStamp, LimitRanger, NamespaceAutoProvision, NodeRestriction,
                        PodNodeSelector, PriorityResolver, ResourceQuotaAdmission, ResourceV2,
                        ServiceAccountAdmission, compute_namespace_usage)
from .auth import (ANONYMOUS, GROUP_AUTHENTICATED, GROUP_MASTERS, AlwaysAllowAuthorizer,
                   AuthenticatorChain, AuthorizerChain, BootstrapTokenAuthenticator,
                   NodeAuthorizer, RBACAuthorizer,
                   ServiceAccountAuthenticator, StaticTokenAuthenticator, UserInfo, verb_for)
from .registry import Registry

WATCH_HEARTBEAT_SECONDS = 5.0
# the pods' streaming subresources, by their kubelet path
STREAM_SUBRESOURCES = {"exec": "exec", "attach": "attach", "portforward": "portForward"}


# The user of a request without a credential when the apiserver has no
# security option (AlwaysAllow, no token), as the JAX apiserver serves it.
ADMIN = UserInfo(name="system:admin", groups=[GROUP_MASTERS])

# the classes of credential /metrics counts refusals by: no user's name
# reaches that unauthenticated endpoint
DENIED_CLASSES = ("anonymous", "bootstrap", "node", "serviceaccount", "other")
_DENIED_PREFIXES = (("system:anonymous", "anonymous"), ("system:bootstrap:", "bootstrap"),
                    ("system:node:", "node"), ("system:serviceaccount:", "serviceaccount"))


def credential_class(user: UserInfo) -> str:
    """The DENIED_CLASSES entry of a user, by the prefix of its name."""
    return next((cls for prefix, cls in _DENIED_PREFIXES if user.name.startswith(prefix)),
                "other")


def _encode_chunks(frames) -> bytes:
    """N watch payloads as chunked-transfer bytes, one buffer."""
    buf = bytearray()
    for data in frames:
        if not data:
            data = b"\n"  # a zero-length chunk would end the stream
        buf += b"%x\r\n" % len(data) + data + b"\r\n"
    return bytes(buf)


def _json_bytes(d: Any) -> bytes:
    return json.dumps(d, separators=(",", ":")).encode()


def parse_rv(value):
    """A wire resourceVersion -> int, or a tuple for a composite ("r0.r1",
    which only a sharded store mints).  ValueError on garbage."""
    if value is None:
        return 0
    s = str(value).strip()
    if not s:
        return 0
    if "." in s:
        return tuple(int(p) for p in s.split("."))
    return int(s)


def encode_continue(rv: str, last_key: str) -> str:
    """Opaque LIST continue token: the first chunk's resourceVersion (the
    client's watch-resume anchor) and the last storage key served."""
    return base64.urlsafe_b64encode(_json_bytes({"rv": str(rv), "k": last_key})).decode()


def decode_continue(token: str):
    """-> (rv, last_key); BadRequest on garbage."""
    try:
        d = json.loads(base64.urlsafe_b64decode(token.encode()))
        return str(d["rv"]), str(d["k"])
    except (ValueError, KeyError, TypeError, binascii.Error) as e:
        raise BadRequest(f"invalid continue token: {e}") from None


class _WatchStream:
    """One watch stream's frames: events, the opt-in progress and
    lag-stamp BOOKMARK frames, and the 410 frame of an evicted stream."""

    def __init__(self, master: "Master", w, q: Dict[str, str]):
        self.master = master
        self.w = w
        # ?lagStamps=1 (informers set it): after every delivered batch a
        # BOOKMARK carries the monotonic commit stamp of its newest
        # revision, so the client can export delivered-at minus committed-at
        self.lag_stamps = q.get("lagStamps") in ("1", "true")
        # ?progressBookmarks=1: an idle heartbeat carries a safe resume
        # revision, so an idle informer resumes above the compaction floor
        self.progress = q.get("progressBookmarks") in ("1", "true")

    @staticmethod
    def _bookmark(meta: Dict[str, Any]) -> bytes:
        return _json_bytes({"type": "BOOKMARK", "object": {
            "kind": "Bookmark", "apiVersion": "v1", "metadata": meta}}) + b"\n"

    def heartbeat_frame(self) -> bytes:
        """The idle tick: a progress bookmark when asked for and safe, else
        the empty payload (a keep-alive newline)."""
        if self.progress:
            rv = self.w.progress_rv()
            if rv:
                return self._bookmark({"resourceVersion": str(rv)})
        return b""

    def lag_frame(self, evs) -> Optional[bytes]:
        newest = 0
        for ev in evs:
            try:
                newest = max(newest, int((ev.object.get("metadata") or {})
                                         .get("resourceVersion") or 0))
            except (TypeError, ValueError, AttributeError):
                continue
        ts = self.master.store.commit_ts_of(newest) if newest else None
        if ts is None:
            return None
        # "<shard>:<stamp>" tokens: one store, shard 0
        return self._bookmark({"resourceVersion": str(newest),
                               "annotations": {t.COMMITTED_AT_ANNOTATION: f"0:{ts:.6f}"}})

    def batch_frames(self, evs) -> List[bytes]:
        frames = [b'{"type":"' + ev.type.encode() + b'","object":'
                  + _json_bytes(ev.object) + b"}\n"
                  for ev in evs if self.w.event_matches(ev.object)]
        if self.lag_stamps:
            fr = self.lag_frame(evs)
            if fr is not None:
                frames.append(fr)
        return frames

    @staticmethod
    def eviction_frame() -> bytes:
        status = TooOldResourceVersion("watch evicted; relist required").to_status()
        return _json_bytes({"type": ERROR, "object": status}) + b"\n"


class _InflightLimiter:
    """Max-inflight overload shedding (ref: apiserver/pkg/server/filters/
    maxinflight.go): mutating requests past the bound are refused with
    429 and Retry-After before they cost admission or a commit; reads
    never are."""

    MUTATING = frozenset({"POST", "PUT", "PATCH", "DELETE"})
    # mutating requests past this many in flight get 429 and Retry-After
    # (the JAX apiserver's default)
    MAX_MUTATING = 256

    def __init__(self):
        self._lock = threading.Lock()
        self._inflight = {"mutating": 0, "readonly": 0}
        self.shed_total = 0
        self._shed_burst = 0  # refusals since the last mutating admit

    def _class_of(self, method: str) -> str:
        return "mutating" if method in self.MUTATING else "readonly"

    def acquire(self, method: str) -> bool:
        cls = self._class_of(method)
        with self._lock:
            if cls == "mutating" and self._inflight["mutating"] >= self.MAX_MUTATING:
                self.shed_total += 1
                self._shed_burst += 1
                return False
            self._inflight[cls] += 1
            if cls == "mutating":
                self._shed_burst = 0
        return True

    def release(self, method: str):
        with self._lock:
            self._inflight[self._class_of(method)] -= 1

    def inflight(self, cls: str) -> int:
        with self._lock:
            return self._inflight[cls]

    def retry_after(self) -> float:
        """Seconds a shed client should wait: 0.5 s, scaled up with the
        depth of the shed burst, capped at 2 s."""
        with self._lock:
            burst = self._shed_burst
        return max(0.1, min(2.0, 0.5 * (1.0 + burst / 64.0)))


class Metrics:
    """Request counters and duration sums by verb and resource."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._sums: Dict[str, float] = {}

    def observe(self, method: str, resource: str, seconds: float):
        key = f'method="{method}",resource="{resource}"'
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + 1
            self._sums[key] = self._sums.get(key, 0.0) + seconds

    def render(self) -> str:
        lines = ["# TYPE apiserver_request_total counter"]
        with self._lock:
            for key, n in sorted(self._counts.items()):
                lines.append(f"apiserver_request_total{{{key}}} {n}")
            lines.append("# TYPE apiserver_request_duration_seconds_sum counter")
            for key, s in sorted(self._sums.items()):
                lines.append(f"apiserver_request_duration_seconds_sum{{{key}}} {s:.6f}")
        return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "ktpu-apiserver/0.1"
    # headers and body are separate small writes: no Nagle stall behind
    # the client's delayed ACK
    disable_nagle_algorithm = True
    wbufsize = -1  # one syscall per response; watches flush per batch
    # past this, closing the connection is cheaper than draining a
    # refused request's body
    MAX_DRAIN_BYTES = 1 << 20

    def log_message(self, fmt, *args):  # noqa: D102
        pass

    @property
    def master(self) -> "Master":
        return self.server.master  # type: ignore[attr-defined]

    # -------------------------------------------------------------- plumbing

    def _send_raw(self, code: int, raw: bytes, ctype: str = "application/json",
                  extra_headers: Optional[Dict[str, str]] = None):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def _send_json(self, code: int, payload: Dict[str, Any]):
        self._send_raw(code, _json_bytes(payload))

    def _send_obj(self, code: int, obj):
        self._send_raw(code, _json_bytes(self.master.scheme.encode(obj)))

    def _send_error(self, err: ApiError):
        # a request refused before its body was read leaves the body in the
        # keep-alive stream, where it would parse as the next request line
        self._drain_unread_body()
        retry_after = getattr(err, "retry_after", None)
        self._send_raw(err.code, _json_bytes(err.to_status()),
                       extra_headers=({"Retry-After": f"{retry_after:.3f}"}
                                      if retry_after is not None else None))

    def _drain_unread_body(self):
        if getattr(self, "_body_consumed", True):
            return
        self._body_consumed = True
        try:
            length = int(self.headers.get("Content-Length") or 0)
            if length > self.MAX_DRAIN_BYTES:
                self.close_connection = True
                return
            if not length:
                return
            old_timeout = self.connection.gettimeout()
            self.connection.settimeout(5.0)
            try:
                while length > 0:
                    chunk = self.rfile.read(min(length, 65536))
                    if not chunk:
                        self.close_connection = True
                        break
                    length -= len(chunk)
            except socket.timeout:
                self.close_connection = True
            finally:
                self.connection.settimeout(old_timeout)
        except (OSError, ValueError):
            pass

    def _read_body(self) -> Dict[str, Any]:
        length = int(self.headers.get("Content-Length") or 0)
        self._body_consumed = True
        if length == 0:
            raise BadRequest("request body required")
        raw = self.rfile.read(length)
        try:
            return json.loads(raw)
        except json.JSONDecodeError as e:
            raise BadRequest(f"invalid JSON body: {e}") from e

    def _decode_typed(self, resource: str, body: Dict[str, Any]):
        """The body as the resource's registered kind; BadRequest, in the
        JAX apiserver's words, when it names another kind."""
        obj = self.master.scheme.decode(body)
        want_kind = self.master.scheme.by_resource[resource].KIND
        have_kind = type(obj).KIND if obj is not None else body.get("kind", "")
        if want_kind and have_kind != want_kind:
            raise BadRequest(f"body kind {have_kind!r} does not match resource {resource!r} "
                             f"(want {want_kind!r})")
        return obj

    # ------------------------------------------------------------------ auth

    def _authn(self) -> UserInfo:
        """The request's user (ref: the authn filter, config.go:530): the
        verified client certificate first, then the bearer token, else
        anonymous (the admin when the server has no security option).
        Raises Unauthorized for a presented but invalid token."""
        x509_user = self._peer_cert_user()
        if x509_user is not None:
            return x509_user
        header = self.headers.get("Authorization", "")
        if not header.startswith("Bearer "):
            if self.master.token or self.master.authorization_mode != "AlwaysAllow":
                return ANONYMOUS
            return ADMIN
        user = self.master.authenticators.authenticate(header[len("Bearer "):])
        if user is None:
            raise Unauthorized("invalid bearer token")
        return user

    def _peer_cert_user(self) -> Optional[UserInfo]:
        """The user of the verified TLS client certificate, if any."""
        getpeercert = getattr(self.connection, "getpeercert", None)
        if getpeercert is None:
            return None
        try:
            cert = getpeercert()
        except (ValueError, OSError):
            return None
        if not cert:
            return None  # no certificate presented: the token path
        name, orgs = "", []
        for rdn in cert.get("subject", ()):
            for key, value in rdn:
                if key == "commonName":
                    name = value
                elif key == "organizationName":
                    orgs.append(value)
        if not name:
            return None
        return UserInfo(name=name, groups=orgs + [GROUP_AUTHENTICATED])

    def _authz(self, user: UserInfo, verb: str, resource: str, ns: str, name: str,
               sub: str = ""):
        if not self.master.authorizer.authorize(user, verb, resource, ns, name, sub=sub):
            self.master.note_denied(user)
            raise Forbidden(f'user "{user.name}" cannot {verb} {resource}'
                            + (f' "{name}"' if name else "")
                            + (f' in namespace "{ns}"' if ns else ""))

    # -------------------------------------------------------------- dispatch

    def _route(self):
        parsed = urlparse(self.path)
        q = {k: v[0] for k, v in parse_qs(parsed.query).items()}
        return [p for p in parsed.path.split("/") if p], q

    def _parse_resource_path(self, parts):
        """(resource, namespace, name, subresource) of /api/v1/... or
        /apis/<group>/<version>/...:
          <prefix>/<resource>[/<name>[/<sub>]]
          <prefix>/namespaces/<ns>/<resource>[/<name>[/<sub>]]"""
        if not parts or parts[0] not in ("api", "apis"):
            raise NotFound(f"unknown path {self.path}")
        if parts[0] == "api":
            self._req_version = parts[1] if len(parts) > 1 else "v1"
        else:
            self._req_version = "/".join(parts[1:3]) if len(parts) > 2 else ""
        rest = parts[2:] if parts[0] == "api" else parts[3:]
        if not rest:
            raise NotFound("missing resource")
        # /namespaces/<ns>/<resource> only when <resource> is registered;
        # otherwise it is the namespace object's own subresource
        if rest[0] == "namespaces" and len(rest) >= 3 \
                and rest[2] in self.master.scheme.by_resource:
            return (rest[2], rest[1], rest[3] if len(rest) > 3 else "",
                    rest[4] if len(rest) > 4 else "")
        return rest[0], "", rest[1] if len(rest) > 1 else "", rest[2] if len(rest) > 2 else ""

    def _handle(self, method: str):
        self._body_consumed = False
        # a mutation that carries the client's X-Ktpu-Trace context runs in
        # a server span of that trace (watches and plain GETs do not)
        ctx = spanlib.parse_header(self.headers.get(spanlib.HEADER, ""))
        if ctx is None or method == "GET":
            return self._handle_inner(method)
        with self.master.spans.start_span(f"apiserver.{method}", parent=ctx, path=self.path):
            return self._handle_inner(method)

    def _handle_inner(self, method: str):
        limiter = self.master.inflight
        if not limiter.acquire(method):
            err = TooManyRequests("apiserver overloaded: too many in-flight mutating "
                                  "requests; retry after the indicated backoff")
            err.retry_after = limiter.retry_after()
            try:
                self._send_error(err)
            except OSError:
                pass  # the shed client is gone
            return
        try:
            self._handle_limited(method)
        finally:
            limiter.release(method)

    def _handle_limited(self, method: str):
        start = time.monotonic()
        try:
            parts, q = self._route()
            if parts and parts[0] in ("healthz", "readyz", "livez"):
                self._send_json(200, {"status": "ok"})
                return
            user = self._authn()
            # the legacy shared-token mode: the token (or a verified client
            # certificate, an equally strong credential) is the cluster
            if self.master.token and self.master.authorization_mode == "AlwaysAllow":
                if self._peer_cert_user() is None:
                    if self.headers.get("Authorization", "") != f"Bearer {self.master.token}":
                        raise Unauthorized("invalid bearer token")
                    user = ADMIN
            self._user = user
            if method == "POST" and parts == ["apis", "authorization.k8s.io", "v1",
                                              "selfsubjectaccessreviews"]:
                # SelfSubjectAccessReview (`ktpu auth can-i`): what the
                # caller may do, by the server's own authorizer chain
                attrs = (self._read_body().get("spec") or {}).get("resourceAttributes") or {}
                allowed = self.master.authorizer.authorize(
                    user, attrs.get("verb", "get"), attrs.get("resource", ""),
                    attrs.get("namespace", ""), attrs.get("name", ""),
                    sub=attrs.get("subresource", ""))
                self._send_json(201, {"kind": "SelfSubjectAccessReview",
                                      "apiVersion": "authorization.k8s.io/v1",
                                      "status": {"allowed": bool(allowed)}})
                return
            if parts == ["metrics"]:
                self._send_raw(200, self.master.render_metrics().encode(),
                               ctype="text/plain; version=0.0.4")
                return
            if parts == ["debug", "traces"]:
                # authorized as a cluster-scoped read, as every resource is
                self._authz(user, "get", "debug", "", "", "")
                self._send_raw(200, self.master.spans.to_json(q.get("trace", "")))
                return
            resource, ns, name, sub = self._parse_resource_path(parts)
            if resource not in self.master.scheme.by_resource:
                raise NotFound(f"resource {resource!r} not registered")
            if method == "POST" and resource == "pods" and name == "bindings:batch" \
                    and not sub:
                # N binding creates: the pods/binding permission, as one
                self._authz(user, "create", resource, ns, "", "binding")
            elif method == "POST" and resource == "pods" and name == "delete:batch" \
                    and not sub:
                # N deletes: the delete permission, whatever the transport
                self._authz(user, "delete", resource, ns, "", "")
            else:
                self._authz(user, verb_for(method, name, q.get("watch") in ("1", "true")),
                            resource, ns, name, sub)
            getattr(self, f"_do_{method.lower()}")(resource, ns, name, sub, q)
            self.master.metrics.observe(method, resource, time.monotonic() - start)
        except ApiError as e:
            try:
                self._send_error(e)
            except (BrokenPipeError, ConnectionResetError):
                pass
        except (BrokenPipeError, ConnectionResetError):
            pass  # the client hung up
        except Exception as e:  # noqa: BLE001 — answered as a 500 Status
            traceback.print_exc()
            try:
                self._send_error(ApiError(str(e)))
            except OSError:
                pass

    def do_GET(self):
        self._handle("GET")

    def do_POST(self):
        self._handle("POST")

    def do_PUT(self):
        self._handle("PUT")

    def do_PATCH(self):
        self._handle("PATCH")

    def do_DELETE(self):
        self._handle("DELETE")

    def _with_quota_serialization(self, resource: str, ns: str, write_fn):
        """A quota-counted write admits and commits under one lock, so two
        writes cannot both pass a nearly spent quota."""
        if resource in ResourceQuotaAdmission.COUNTED and \
                self.master._list_quotas(ns or "default"):
            with self.master.quota_lock:
                return write_fn()
        return write_fn()

    # ------------------------------------------------------------------- GET

    def _do_get(self, resource, ns, name, sub, q):
        if name and not sub:
            self._get_object(resource, ns, name)
        elif resource == "pods" and sub == "log":
            self._proxy_pod_log(ns, name, q)
        elif resource == "pods" and sub.lower() in STREAM_SUBRESOURCES:
            self._proxy_pod_stream(ns, name, sub)
        elif name and sub:
            raise NotFound(f"subresource {sub!r} not readable")
        elif q.get("watch") in ("1", "true"):
            self._serve_watch(resource, ns, q)
        else:
            self._list_objects(resource, ns, q)

    def _get_object(self, resource, ns, name):
        reg = self.master.registry
        raw = self.master.cacher.get_raw(reg.key(resource, ns, name))
        if raw is None:
            raise NotFound(f'{resource} "{name}" not found')
        self._send_raw(200, _json_bytes(raw))

    def _list_objects(self, resource, ns, q):
        """LIST from the watch cache, selectors on the raw wire dicts.
        ``limit``/``continue`` page over the sorted storage keys; the token
        carries the first chunk's resourceVersion and the last key served,
        and one whose revision fell below the cache's floor answers 410."""
        master = self.master
        reg = master.registry
        try:
            limit = int(q.get("limit") or 0)
        except ValueError:
            raise BadRequest(f"invalid limit {q.get('limit')!r}") from None
        if limit < 0:
            raise BadRequest(f"limit must be >= 0, got {limit}")
        token = q.get("continue", "")
        anchor_rv, start_key = "", ""
        if token:
            anchor_rv, start_key = decode_continue(token)
            self._check_continue_fresh(anchor_rv)
        selectors = dict(label_selector=q.get("labelSelector", ""),
                         field_selector=q.get("fieldSelector", ""))
        entries, rev, match = reg.select_entries(master.cacher, resource, ns, **selectors)
        next_token = ""
        if start_key:
            entries = entries[bisect.bisect_right([e[0] for e in entries], start_key):]
        if limit:
            page, more = [], False
            for e in entries:
                if match is not None and not match(e[2]):
                    continue
                if len(page) == limit:
                    more = True
                    break
                page.append(e)
            entries = page
            if more:
                next_token = encode_continue(anchor_rv or str(rev), entries[-1][0])
        elif match is not None:
            entries = [e for e in entries if match(e[2])]
        dicts = [d for _k, _r, d in entries]
        ver = getattr(self, "_req_version", "")
        list_version = dicts[0].get("apiVersion", "") if dicts else ver or "v1"
        meta = '"resourceVersion":"%s"' % rev
        if next_token:
            meta += ',"continue":"%s"' % next_token
        kind = master.scheme.by_resource[resource].KIND + "List"
        head = ('{"kind":"%s","apiVersion":"%s","metadata":{%s},"items":['
                % (kind, list_version, meta)).encode()
        self._send_raw(200, head + b",".join(_json_bytes(d) for d in dicts) + b"]}")

    def _check_continue_fresh(self, anchor_rv: str):
        try:
            parsed = parse_rv(anchor_rv)
        except ValueError:
            raise BadRequest(f"invalid continue token revision {anchor_rv!r}") from None
        parts = parsed if isinstance(parsed, tuple) else (parsed,)
        if len(parts) != 1:
            raise TooOldResourceVersion(f"continue token arity {len(parts)} does not match "
                                        f"shard count 1; restart the list")
        floor = self.master.cacher.compacted_revision()
        if 1 <= parts[0] < floor:
            raise TooOldResourceVersion(f"continue token revision {parts[0]} compacted "
                                        f"(floor {floor}); restart the list")

    def _kubelet_endpoint(self, pod_name: str, ns: str):
        """(pod, the parsed URL of its node's kubelet server, the node's
        kubelet token) for a scheduled pod; the token comes from the node's
        kube-system Secret: the apiserver is the trusted hop (ref: the
        apiserver->kubelet connection for exec/logs/proxy)."""
        reg = self.master.registry
        pod = reg.get("pods", ns, pod_name)
        node_name = pod.spec.node_name
        if not node_name:
            raise BadRequest(f"pod {ns}/{pod_name} is not scheduled to a node")
        node = reg.get("nodes", "", node_name)
        url = (node.metadata.annotations or {}).get("kubelet.ktpu.io/server")
        if not url:
            raise NotFound(f"node {node_name} advertises no kubelet endpoint")
        try:
            token = reg.get("secrets", "kube-system",
                            f"kubelet-token-{node_name}").data.get("token", "")
        except NotFound:
            token = ""
        return pod, urlparse(url), token

    def _proxy_pod_log(self, ns: str, name: str, q):
        """GET pods/<name>/log: the apiserver -> kubelet log fetch (ref:
        registry/core/pod/rest/log.go), with the node's kubelet token."""
        pod, kubelet, token = self._kubelet_endpoint(name, ns)
        container = q.get("container") or pod.spec.containers[0].name
        path = f"/containerLogs/{ns}/{name}/{container}"
        if q.get("tailLines"):
            path += f"?tail={int(q['tailLines'])}"
        if kubelet.scheme == "https":
            conn = http.client.HTTPSConnection(kubelet.hostname, kubelet.port, timeout=30,
                                               context=self.master.kubelet_ssl_context())
        else:
            conn = http.client.HTTPConnection(kubelet.hostname, kubelet.port, timeout=30)
        try:
            conn.request("GET", path, headers={"Authorization": f"Bearer {token}"})
            resp = conn.getresponse()
            body = resp.read()
        finally:
            conn.close()
        self._send_raw(resp.status, body, ctype="text/plain")

    def _proxy_pod_stream(self, ns: str, name: str, sub: str):
        """pods/<name>/exec, attach, portforward: open the kubelet's stream,
        then splice the upgraded client connection onto it.  The token for
        the kubelet hop never reaches the client.  The handshake is checked
        before the kubelet is dialled: that dial is what spawns an exec."""
        if not streams.wants_upgrade(self):
            raise BadRequest(f"expected Connection: Upgrade, Upgrade: {streams.UPGRADE_PROTO}")
        kind = STREAM_SUBRESOURCES[sub.lower()]
        pod, kubelet, token = self._kubelet_endpoint(name, ns)
        parsed = urlparse(self.path)
        if kind == "portForward":
            kpath = f"/portForward/{ns}/{name}"
        else:
            container = (parse_qs(parsed.query).get("container") or [""])[0] \
                or pod.spec.containers[0].name
            kpath = f"/{kind}/{ns}/{name}/{container}"
        if parsed.query:
            kpath += f"?{parsed.query}"
        try:
            upstream = streams.upgrade_request(
                kubelet.hostname, kubelet.port, kpath, {"Authorization": f"Bearer {token}"},
                ssl_context=(self.master.kubelet_ssl_context()
                             if kubelet.scheme == "https" else None))
        except OSError as e:  # UpgradeRefused is a ConnectionError
            raise BadRequest(f"kubelet connection failed: {e}") from None
        client_sock = streams.accept_upgrade(self)  # the header was checked
        try:
            streams.splice(client_sock, upstream)
        finally:
            upstream.close()

    def _serve_watch(self, resource, ns, q):
        try:
            since = parse_rv(q.get("resourceVersion"))
        except ValueError as e:
            raise BadRequest(f"invalid resourceVersion: {e}") from None
        if isinstance(since, tuple):
            raise BadRequest("composite resourceVersion presented to an unsharded "
                             "apiserver; relist")
        timeout = float(q.get("timeoutSeconds") or 0)
        reg = self.master.registry
        selectors = dict(label_selector=q.get("labelSelector", ""),
                         field_selector=q.get("fieldSelector", ""))
        try:
            w = reg.watch(resource, ns, since_rev=since, via=self.master.cacher, **selectors)
        except TooOldResourceVersion:
            # the revision predates the cache's window: watch the store,
            # which answers 410 itself if the revision is compacted there too
            w = reg.watch(resource, ns, since_rev=since, **selectors)
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        self.wfile.flush()  # the client waits in getresponse() for these
        deadline = time.monotonic() + timeout if timeout else None
        stream = _WatchStream(self.master, w, q)
        try:
            while True:
                if deadline and time.monotonic() >= deadline:
                    break
                evs = w.next_batch_timeout(WATCH_HEARTBEAT_SECONDS)
                if self.master.stopping.is_set():
                    break
                if evs is None:
                    if w.evicted:
                        # a slow consumer: the stream cannot go on gap-free,
                        # 410 makes the reflector relist
                        self._write_chunks([stream.eviction_frame()])
                        break
                    if w._stopped.is_set():
                        break
                    self._write_chunks([stream.heartbeat_frame()])
                    continue
                self._write_chunks(stream.batch_frames(evs))
        except (OSError, socket.timeout):
            pass  # the watcher hung up
        finally:
            w.stop()
            try:
                self.wfile.write(b"0\r\n\r\n")
            except OSError:
                pass
            self.close_connection = True

    def _write_chunks(self, frames):
        buf = _encode_chunks(frames)
        if buf:
            self.wfile.write(buf)
            self.wfile.flush()

    # ------------------------------------------------------------------ POST

    def _batch_results(self, kind: str, outcomes) -> Dict[str, Any]:
        return {"kind": kind, "apiVersion": "v1", "results": [
            {"kind": "Status", "apiVersion": "v1", "status": "Success"}
            if e is None else e.to_status() for e in outcomes]}

    def _do_post(self, resource, ns, name, sub, q):
        if resource == "pods" and sub.lower() in STREAM_SUBRESOURCES:
            self._proxy_pod_stream(ns, name, sub)  # kubectl's verb for exec
            return
        master = self.master
        reg = master.registry
        body = self._read_body()
        if resource == "pods" and name == "bindings:batch" and not sub:
            bindings = []
            for d in body.get("items") or []:
                obj = master.scheme.decode(d)
                if getattr(obj, "KIND", "") != "Binding":
                    raise BadRequest(f"bindings:batch items must be Binding, got "
                                     f"{d.get('kind')!r}")
                item_ns = obj.metadata.namespace
                if ns and item_ns and item_ns != ns:
                    raise Forbidden(f"binding {obj.metadata.name!r} names namespace "
                                     f"{item_ns!r}; the request authorized {ns!r}")
                bindings.append(obj)
            if not bindings:
                raise BadRequest("bindings:batch requires items")
            self._send_json(200, self._batch_results("BindingBatchResult",
                                                     reg.bind_batch(ns, bindings)))
            return
        if resource == "pods" and name == "delete:batch" and not sub:
            items = []
            for d in body.get("items") or []:
                item_ns = d.get("namespace") or ""
                if ns and item_ns and item_ns != ns:
                    raise Forbidden(f"delete item {d.get('name')!r} names namespace "
                                     f"{item_ns!r}; the request authorized {ns!r}")
                grace = d.get("gracePeriodSeconds")
                items.append({"name": d.get("name") or "", "namespace": item_ns or ns,
                              "grace_seconds": None if grace is None else int(grace),
                              "resource_version": d.get("resourceVersion") or ""})
            if not items:
                raise BadRequest("delete:batch requires items")
            self._send_json(200, self._batch_results("DeleteBatchResult",
                                                     reg.delete_batch("pods", ns, items)))
            return
        if resource == "pods" and sub == "binding":
            reg.bind(ns, name, master.scheme.decode(body))
            # upstream answers a binding with a Status, not the pod
            self._send_json(201, {"kind": "Status", "apiVersion": "v1", "status": "Success"})
            return
        if resource == "pods" and sub == "eviction":
            if body.get("kind") not in (None, "", "Eviction"):
                raise BadRequest(f"eviction body must be kind Eviction, got {body.get('kind')!r}")
            decoded = master.scheme.decode(body)
            eviction = decoded if isinstance(decoded, t.Eviction) else None
            self._send_obj(201, reg.evict(ns, name, eviction))
            return
        if sub:
            raise NotFound(f"subresource {sub!r} not writable")
        obj = self._decode_typed(resource, body)
        # the URL's namespace before admission, so that plugins see it
        if ns and not obj.metadata.namespace:
            obj.metadata.namespace = ns
        if resource == "pods":
            # the creating request's trace id rides the pod, and its create
            # time anchors the pod-startup SLI
            tid = spanlib.current_trace_id()
            if tid:
                obj.metadata.annotations.setdefault(t.TRACE_ID_ANNOTATION, tid)
            obj.metadata.annotations.setdefault(t.CREATED_AT_ANNOTATION, f"{time.time():.6f}")

        def admit_and_create():
            return reg.create(resource, ns, master.admission.admit(CREATE, resource, obj,
                                                                   user=self._user))

        self._send_obj(201, self._with_quota_serialization(
            resource, ns or obj.metadata.namespace, admit_and_create))

    # ------------------------------------------------------------------- PUT

    def _do_put(self, resource, ns, name, sub, q):
        master = self.master
        reg = master.registry
        obj = self._decode_typed(resource, self._read_body())
        if sub == "status":
            updated = reg.update_status(resource, ns, name, obj)
        elif sub:
            raise NotFound(f"subresource {sub!r} not writable")
        else:
            old = reg.get(resource, ns, name)

            def admit_and_update():
                admitted = master.admission.admit(UPDATE, resource, obj, old, user=self._user)
                return reg.update(resource, ns, name, admitted)

            updated = self._with_quota_serialization(
                resource, ns or old.metadata.namespace, admit_and_update)
        self._send_obj(200, updated)

    # ----------------------------------------------------------------- PATCH

    def _do_patch(self, resource, ns, name, sub, q):
        master = self.master
        patch = self._read_body()
        if sub == "status":
            patch = {"status": patch.get("status", patch)}

        def admit(merged, cur):
            # the merged object goes through the chain as an update does
            return master.admission.admit(UPDATE, resource, merged, cur, user=self._user)

        self._send_obj(200, self._with_quota_serialization(
            resource, ns, lambda: master.registry.patch(resource, ns, name, patch, admit=admit)))

    # ---------------------------------------------------------------- DELETE

    def _do_delete(self, resource, ns, name, sub, q):
        if not name:
            raise BadRequest("collection delete not supported; delete by name")
        grace = q.get("gracePeriodSeconds")
        self._send_obj(200, self.master.registry.delete(
            resource, ns, name, None if grace is None else int(grace)))


class _ApiHTTPServer(ThreadingHTTPServer):
    daemon_threads = True

    def handle_error(self, request, client_address):
        # a peer gone mid-request, or one that failed the TLS handshake (a
        # plain-HTTP client at the HTTPS port), is routine: no stack trace
        if isinstance(sys.exc_info()[1], (ConnectionError, TimeoutError, ssl.SSLError)):
            return
        super().handle_error(request, client_address)


class Master:
    """The apiserver: the store, its watch cache, the registry, the
    admission chain and the HTTP front end, in this process."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 wal_path: Optional[str] = None, token: str = "",
                 authorization_mode: str = "AlwaysAllow",
                 static_tokens: Optional[Dict[str, Tuple[str, List[str]]]] = None,
                 sa_signing_key: str = "ktpu-sa-key",
                 tls_cert_file: str = "", tls_key_file: str = "", client_ca_file: str = ""):
        self.scheme = global_scheme
        self.store = Store(self.scheme, wal_path=wal_path)
        self.registry = Registry(self.store, self.scheme)
        self.cacher = Cacher(self.store).start()
        self.inflight = _InflightLimiter()
        self.metrics = Metrics()
        self.spans = spanlib.SpanCollector("apiserver")
        self.quota_lock = threading.Lock()
        self.stopping = threading.Event()
        self._denied_lock = threading.Lock()
        # credential class (DENIED_CLASSES) -> requests the authorizers refused
        self._denied: Dict[str, int] = dict.fromkeys(DENIED_CLASSES, 0)
        self.token = token
        self.authorization_mode = authorization_mode
        tokens = dict(static_tokens or {})
        if token:
            tokens[token] = ("system:admin", [GROUP_MASTERS])
        self.authenticators = AuthenticatorChain([
            StaticTokenAuthenticator(tokens),
            ServiceAccountAuthenticator(sa_signing_key,
                                        get_serviceaccount=self._get_serviceaccount),
            BootstrapTokenAuthenticator(self._get_secret_or_none),
        ])
        authorizers = []
        for mode in authorization_mode.split(","):
            mode = mode.strip()
            if mode == "Node":
                authorizers.append(NodeAuthorizer(self._get_pod_or_none, self._list_all_pods,
                                                  get_serviceaccount=self._get_serviceaccount))
            elif mode == "RBAC":
                authorizers.append(RBACAuthorizer(self._list_for_auth))
            elif mode == "AlwaysAllow":
                authorizers.append(AlwaysAllowAuthorizer())
        self.authorizer = AuthorizerChain(authorizers)
        self.admission = AdmissionChain([
            NamespaceAutoProvision(self.registry.ensure_namespace),
            NodeRestriction(),  # before ServiceAccount defaulting: the raw spec
            PodNodeSelector(self._get_namespace_or_none),
            PriorityResolver(self._get_priority_class),
            ExtendedResourceToleration(),  # before ResourceV2: sees the raw limits too
            DefaultTolerationSeconds(),
            ResourceV2(),
            GangDefaulter(),
            ServiceAccountAdmission(),
            IdentityStamp(),
            LimitRanger(self._list_limit_ranges),
            ResourceQuotaAdmission(self._list_quotas, self._quota_usage),
            EventRateLimit(),
        ])
        self._httpd = _ApiHTTPServer((host, port), _Handler)
        self._httpd.master = self  # type: ignore[attr-defined]
        self.host, self.port = self._httpd.server_address[:2]
        self.client_ca_file = client_ca_file
        self._kubelet_ctx: Optional[ssl.SSLContext] = None
        if tls_cert_file:
            # HTTPS only: no plaintext listener beside it (ref apiserver/pkg/
            # server/serve.go); the handshake runs on the request's thread
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(certfile=tls_cert_file, keyfile=tls_key_file or None)
            if client_ca_file:
                ctx.load_verify_locations(cafile=client_ca_file)
                ctx.verify_mode = ssl.CERT_OPTIONAL
            self._httpd.socket = ctx.wrap_socket(self._httpd.socket, server_side=True,
                                                 do_handshake_on_connect=False)
            self.url = f"https://{self.host}:{self.port}"
        else:
            self.url = f"http://{self.host}:{self.port}"
        self._thread: Optional[threading.Thread] = None

    def kubelet_ssl_context(self) -> ssl.SSLContext:
        """The dial to an https kubelet: its serving certificate verified
        against the cluster CA (the CSR signer issued it), unverified only
        when this apiserver has no CA.  Built once, shared."""
        if self._kubelet_ctx is None:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
            if self.client_ca_file:
                ctx.load_verify_locations(cafile=self.client_ca_file)
            else:
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            self._kubelet_ctx = ctx
        return self._kubelet_ctx

    def _get_serviceaccount(self, namespace: str, name: str):
        if not namespace or not name:
            return None
        return self.store.get_or_none(self.registry.key("serviceaccounts", namespace, name))

    def _get_secret_or_none(self, namespace: str, name: str):
        if not namespace or not name:
            return None
        return self.store.get_or_none(self.registry.key("secrets", namespace, name))

    def _get_pod_or_none(self, namespace: str, name: str):
        if not namespace or not name:
            return None
        return self.store.get_or_none(self.registry.key("pods", namespace, name))

    def _list_all_pods(self):
        return self.store.list(self.registry.prefix("pods"))[0]

    def _list_for_auth(self, resource: str, namespace: str):
        return self.store.list(self.registry.prefix(resource, namespace))[0]

    def _get_priority_class(self, name: str):
        return self.store.get_or_none(self.registry.key("priorityclasses", "", name))

    def _get_namespace_or_none(self, name: str):
        if not name:
            return None
        return self.store.get_or_none(self.registry.key("namespaces", "", name))

    def _list_limit_ranges(self, namespace: str):
        return self.store.list(self.registry.prefix("limitranges", namespace))[0]

    def _list_quotas(self, namespace: str):
        return self.store.list(self.registry.prefix("resourcequotas", namespace))[0]

    def _quota_usage(self, namespace: str):
        return compute_namespace_usage(
            lambda resource, ns: self.store.list(self.registry.prefix(resource, ns))[0],
            namespace)

    def note_denied(self, user: UserInfo):
        with self._denied_lock:
            self._denied[credential_class(user)] += 1

    def render_metrics(self) -> str:
        """The /metrics text: request counts and duration sums by verb and
        resource, the in-flight gauges, the shed and the watch-eviction
        counters, and the requests the authorizers refused by credential
        class (the JAX apiserver counts none)."""
        inflight = self.inflight
        with self._denied_lock:
            denied = [(cls, self._denied[cls]) for cls in DENIED_CLASSES]
        return self.metrics.render() + "\n".join([
            "# TYPE ktpu_apiserver_inflight gauge",
            *(f'ktpu_apiserver_inflight{{verb="{cls}"}} {inflight.inflight(cls)}'
              for cls in ("mutating", "readonly")),
            "# TYPE ktpu_apiserver_shed_total counter",
            f"ktpu_apiserver_shed_total {inflight.shed_total}",
            "# TYPE ktpu_watch_slow_consumer_evictions_total counter",
            "ktpu_watch_slow_consumer_evictions_total "
            f"{self.cacher.watch_evictions + self.store.watch_evictions}",
            "# TYPE ktpu_apiserver_authz_denied_total counter",
            *(f'ktpu_apiserver_authz_denied_total{{credential="{cls}"}} {n}'
              for cls, n in denied),
        ]) + "\n"

    def start(self) -> "Master":
        self.registry.ensure_namespace("default")
        self.registry.ensure_namespace("kube-system")
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        kwargs={"poll_interval": 0.1}, daemon=True,
                                        name="apiserver-http")
        self._thread.start()
        return self

    def stop(self):
        self.stopping.set()
        # the cache first: open watches see their streams end
        self.cacher.stop()
        self._httpd.shutdown()
        self._httpd.server_close()
        self.store.close()
