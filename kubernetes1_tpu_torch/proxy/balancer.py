"""Request-level (L7) Service load balancing: the least-inflight balancer
in front of a serving Deployment's replicas.

The port's copy of the JAX package's ``proxy/balancer.py``.  The
userspace proxier (``proxier.py``) splices CONNECTIONS; this balancer
routes each HTTP REQUEST on its own:

- the backend with the fewest in-flight requests wins; ties break by
  power of two choices (two seeded samples from the tied set, fewest
  total attempts wins);
- an endpoints update SWAPS the backend set without dropping in-flight
  requests: a removed backend is no longer picked and drains, its open
  responses finishing on their sockets (the rollout contract: a
  terminating pod leaves the Endpoints' ready addresses first);
- a request that fails BEFORE its first response byte reaches the client
  (dial refused, backend reset) is retried on a surviving backend, a
  bounded number of times, counted by ``utils/retry.note_retry``; a
  request whose response began is never retried;
- a request that finds no backend at all is answered 503 at once;
- chunked and length-framed responses are relayed as their bytes arrive;
- everything runs on ``utils/eventloop.shared_loop()``: non-blocking
  sockets and state machines on the dispatcher, no thread per connection.

The JAX package's faultline sites ``proxy.upstream`` and
``proxy.upstream_send`` are not here: no caller of the port sets them.
"""

from __future__ import annotations

import random
import socket
import threading
from typing import Callable, Dict, List, Optional, Tuple

from ..client.informer import object_key
from ..utils import eventloop
from ..utils import retry as _retry

Addr = Tuple[str, int]

_MAX_HEADER = 65536
_MAX_BODY = 4 * 1024 * 1024
_CONNECT_TIMEOUT = 5.0
_REQUEST_TIMEOUT = 60.0
# A request that failed before its first response byte is tried again on
# another backend this many times.
MAX_RETRIES = 2


class _Backend:
    """Per-backend routing state.  Mutated on the loop thread only."""

    __slots__ = ("addr", "inflight", "requests", "errors", "draining")

    def __init__(self, addr: Addr):
        self.addr = addr
        self.inflight = 0
        self.requests = 0
        self.errors = 0
        self.draining = False


def _parse_headers(raw: bytes):
    """(request|status) line, header dict (lower-cased keys), raw header
    block length.  Returns None while incomplete."""
    end = raw.find(b"\r\n\r\n")
    if end < 0:
        return None
    lines = raw[:end].split(b"\r\n")
    first = lines[0].decode("latin-1")
    headers: Dict[str, str] = {}
    for ln in lines[1:]:
        k, _, v = ln.decode("latin-1").partition(":")
        headers[k.strip().lower()] = v.strip()
    return first, headers, end + 4


class _Upstream:
    """One in-flight request's backend leg: non-blocking connect, send
    the buffered request, relay the response to the client as bytes
    arrive, detect response completion from the framing."""

    def __init__(self, bal: "LeastInflightBalancer", client: "_Client",
                 backend: _Backend, request: bytes):
        self.bal = bal
        self.client = client
        self.backend = backend
        self.request = request
        self.sock: Optional[socket.socket] = None
        self.buf = bytearray()          # response bytes before headers parse
        self.headers_done = False
        self.remaining = -1             # body bytes left (-1: until close)
        self.chunk_state = None         # chunked framing scanner state
        self.closed = False
        self._timer = None

    # ------------------------------------------------------------- dial

    def start(self):
        self._dial()

    def _dial(self):
        import errno

        loop = self.bal._loop
        try:
            self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self.sock.setblocking(False)
            # non-blocking connect: 0 or EINPROGRESS here, completion
            # lands as writability
            rc = self.sock.connect_ex(self.backend.addr)
            if rc not in (0, errno.EINPROGRESS, errno.EWOULDBLOCK):
                raise OSError(rc, "connect failed")
        except OSError:
            self.fail("upstream connect error")
            return
        loop.register(self.sock, eventloop.selectors.EVENT_WRITE,
                      self._on_connected)
        loop.add_connection()
        self._timer = loop.call_later(_CONNECT_TIMEOUT, self._on_timeout)

    def _on_timeout(self):
        if not self.closed and not self.headers_done:
            self.fail("upstream connect timeout")

    def _on_connected(self, mask: int):
        if self.closed:
            return
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        err = self.sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
        if err:
            self.fail("upstream connect refused")
            return
        self._out = memoryview(self.request)
        self.bal._loop.modify(self.sock, eventloop.selectors.EVENT_WRITE,
                              self._on_writable)

    def _on_writable(self, mask: int):
        if self.closed:
            return
        while len(self._out):
            try:
                n = self.sock.send(self._out)
            except (BlockingIOError, InterruptedError):
                return  # still registered for EVENT_WRITE: resume there
            except OSError:
                self.fail("upstream send error")
                return
            self._out = self._out[n:]
        self.bal._loop.modify(self.sock, eventloop.selectors.EVENT_READ,
                              self._on_readable)

    # ---------------------------------------------------------- response

    def _on_readable(self, mask: int):
        if self.closed:
            return
        try:
            data = self.sock.recv(65536)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            data = b""
        if not data:
            if self.headers_done and self.remaining <= 0 \
                    and self.chunk_state is None:
                self.finish()
            else:
                self.fail("upstream closed early")
            return
        if not self.headers_done:
            self.buf += data
            if len(self.buf) > _MAX_HEADER:
                self.fail("upstream header overflow")
                return
            parsed = _parse_headers(bytes(self.buf))
            if parsed is None:
                return
            status, headers, hlen = parsed
            body = bytes(self.buf[hlen:])
            self.headers_done = True
            te = headers.get("transfer-encoding", "")
            if "chunked" in te:
                self.chunk_state = {"remaining": 0, "buf": b"", "done": False}
                self.remaining = 0
            elif "content-length" in headers:
                try:
                    self.remaining = int(headers["content-length"])
                except ValueError:
                    self.fail("bad content-length")
                    return
            else:
                self.remaining = -1  # until-close framing
            # rewrite Connection for the client leg: until-close framing
            # forces close; otherwise honor what the client asked for
            conn = ("close" if self.remaining == -1 or self.client.want_close
                    else "keep-alive")
            self.client.response_close = (conn == "close")
            out = [status.encode("latin-1")]
            for k, v in headers.items():
                if k == "connection":
                    continue
                out.append(f"{k}: {v}".encode("latin-1"))
            out.append(b"connection: " + conn.encode())
            self.client.send(b"\r\n".join(out) + b"\r\n\r\n")
            self.client.acked = True
            if body:
                self._relay_body(body)
        else:
            self._relay_body(data)

    def _relay_body(self, data: bytes):
        self.client.send(data)
        if self.chunk_state is not None:
            self._scan_chunks(data)
            if self.chunk_state["done"]:
                self.finish()
        elif self.remaining >= 0:
            self.remaining -= len(data)
            if self.remaining <= 0:
                self.finish()

    def _scan_chunks(self, data: bytes):
        """Minimal chunked-framing scanner: finds the terminal 0-size
        chunk so response completion is detected without re-framing."""
        st = self.chunk_state
        st["buf"] += data
        while True:
            if st["remaining"] > 0:
                take = min(st["remaining"], len(st["buf"]))
                st["buf"] = st["buf"][take:]
                st["remaining"] -= take
                if st["remaining"] > 0:
                    return
            nl = st["buf"].find(b"\r\n")
            if nl < 0:
                return
            line = st["buf"][:nl].strip()
            st["buf"] = st["buf"][nl + 2:]
            if not line:
                continue  # chunk-data trailing CRLF
            try:
                size = int(line.split(b";")[0], 16)
            except ValueError:
                continue
            if size == 0:
                st["done"] = True
                return
            st["remaining"] = size + 2  # chunk data + its CRLF

    # ---------------------------------------------------------- teardown

    def _close_sock(self):
        if self._timer is not None:
            self._timer.cancel()
        if self.sock is not None:
            self.bal._loop.unregister(self.sock)
            self.bal._loop.remove_connection()
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None

    def finish(self):
        if self.closed:
            return
        self.closed = True
        self._close_sock()
        self.backend.requests += 1
        self.bal._release(self.backend)
        self.client.request_done()

    def fail(self, why: str):
        if self.closed:
            return
        self.closed = True
        self._close_sock()
        self.backend.errors += 1
        self.bal._release(self.backend)
        self.client.upstream_failed(why)


class _Client:
    """One accepted client connection: parse HTTP/1.1 requests off a
    non-blocking socket, dispatch each through the balancer's pick, and
    write the relayed response (write-ready-driven outbuf)."""

    def __init__(self, bal: "LeastInflightBalancer", sock: socket.socket):
        self.bal = bal
        self.sock = sock
        self.buf = bytearray()
        self.outbuf = bytearray()
        self.closed = False
        self.busy = False            # one request in flight per connection
        self.close_after_flush = False
        self.want_close = False      # client asked Connection: close
        self.response_close = False  # response leg decided to close
        self.acked = False           # response bytes reached the client
        self.attempts = 0
        self.tried: set = set()
        self.request: bytes = b""
        self._timer = None
        sock.setblocking(False)
        bal._loop.register(sock, eventloop.selectors.EVENT_READ,
                           self._on_readable)
        bal._loop.add_connection()

    # ------------------------------------------------------------- parse

    def _on_readable(self, mask: int):
        if self.closed:
            return
        try:
            data = self.sock.recv(65536)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            data = b""
        if not data:
            self.close()
            return
        self.buf += data
        if not self.busy:
            self._try_dispatch()

    def _try_dispatch(self):
        parsed = _parse_headers(bytes(self.buf))
        if parsed is None:
            if len(self.buf) > _MAX_HEADER:
                self._respond_error(431, "headers too large")
            return
        first, headers, hlen = parsed
        try:
            clen = int(headers.get("content-length") or 0)
        except ValueError:
            self._respond_error(400, "bad content-length")
            return
        if clen > _MAX_BODY:
            self._respond_error(413, "body too large")
            return
        if len(self.buf) < hlen + clen:
            return  # body still arriving
        body = bytes(self.buf[hlen:hlen + clen])
        del self.buf[:hlen + clen]
        self.want_close = (headers.get("connection", "").lower() == "close")
        # rebuild the upstream request: per-request routing means the
        # backend must not hold the connection open on its side
        out = [first.encode("latin-1")]
        for k, v in headers.items():
            if k in ("connection", "proxy-connection"):
                continue
            out.append(f"{k}: {v}".encode("latin-1"))
        out.append(b"connection: close")
        self.request = b"\r\n".join(out) + b"\r\n\r\n" + body
        self.busy = True
        self.acked = False
        self.attempts = 0
        self.tried = set()
        self.bal.requests_total += 1
        self._timer = self.bal._loop.call_later(_REQUEST_TIMEOUT,
                                                self._on_request_timeout)
        self._dispatch()

    def _on_request_timeout(self):
        if self.busy and not self.closed:
            self.close()

    # ---------------------------------------------------------- dispatch

    def _dispatch(self):
        backend = self.bal._pick(exclude=self.tried)
        if backend is None and self.tried:
            backend = self.bal._pick()  # all tried: allow re-pick
        if backend is None:
            self._respond_error(503, "no backends")
            return
        self.tried.add(backend.addr)
        backend.inflight += 1
        self.bal.picks[backend.addr] = self.bal.picks.get(backend.addr, 0) + 1
        _Upstream(self.bal, self, backend, self.request).start()

    def upstream_failed(self, why: str):
        if self.closed:
            return
        if self.acked:
            # response bytes already reached the client: the truncation
            # is visible there — never splice a second backend's bytes
            # onto a half-delivered response
            self.bal.errors_total += 1
            self.close()
            return
        self.attempts += 1
        if self.attempts <= MAX_RETRIES:
            _retry.note_retry("proxy.upstream")
            self.bal.retries_total += 1
            self._dispatch()
            return
        self._respond_error(502, why)

    def request_done(self):
        if self.closed:
            return
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        self.busy = False
        if self.response_close or self.want_close:
            self.close_after_flush = True
            self._flush()
            return
        if self.buf:
            self._try_dispatch()  # pipelined next request already buffered

    # ------------------------------------------------------------- write

    def send(self, data: bytes):
        if self.closed:
            return
        self.outbuf += data
        self._flush()

    def _flush(self):
        if self.closed:
            return
        if self.outbuf:
            try:
                n = self.sock.send(bytes(self.outbuf))
                del self.outbuf[:n]
            except (BlockingIOError, InterruptedError):
                pass
            except OSError:
                self.close()
                return
        if self.outbuf:
            self.bal._loop.modify(
                self.sock,
                eventloop.selectors.EVENT_READ
                | eventloop.selectors.EVENT_WRITE,
                self._on_event)
        else:
            if self.close_after_flush:
                self.close()
                return
            self.bal._loop.modify(self.sock, eventloop.selectors.EVENT_READ,
                                  self._on_readable)

    def _on_event(self, mask: int):
        if mask & eventloop.selectors.EVENT_WRITE:
            self._flush()
        if not self.closed and mask & eventloop.selectors.EVENT_READ:
            self._on_readable(mask)

    def _respond_error(self, code: int, why: str):
        self.bal.errors_total += 1
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        self.busy = False
        body = ('{"error":"%s"}' % why).encode()
        self.send(b"HTTP/1.1 %d x\r\ncontent-type: application/json\r\n"
                  b"content-length: %d\r\nconnection: close\r\n\r\n%s"
                  % (code, len(body), body))
        self.close_after_flush = True
        self._flush()

    def close(self):
        if self.closed:
            return
        self.closed = True
        if self._timer is not None:
            self._timer.cancel()
        self.bal._loop.unregister(self.sock)
        self.bal._loop.remove_connection()
        try:
            self.sock.close()
        except OSError:
            pass
        self.bal._clients.discard(self)


class LeastInflightBalancer:
    """See module docstring: fewest in flight wins, ties by two seeded
    choices over the tied set.  The JAX balancer's ``round_robin`` and
    ``random`` policies (its bench's baselines) and its ``max_retries``
    option are not here: no caller of the port sets them.

    ``set_backends`` is thread-safe (hops to the loop); draining
    backends keep serving their in-flight requests and leave the table
    when the last one finishes."""

    def __init__(self, listen_host: str = "127.0.0.1", port: int = 0, seed: int = 0):
        self._rng = random.Random(seed)
        self._loop = eventloop.shared_loop()
        self._table: Dict[Addr, _Backend] = {}  # loop-thread only
        self._clients: set = set()
        self.requests_total = 0
        self.retries_total = 0
        self.errors_total = 0
        self.picks: Dict[Addr, int] = {}
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((listen_host, port))
        self._sock.listen(128)
        self._sock.setblocking(False)
        self.host, self.port = self._sock.getsockname()[:2]
        self._closed = False
        self._loop.call_soon(lambda: self._loop.register(
            self._sock, eventloop.selectors.EVENT_READ, self._on_accept))

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # ---------------------------------------------------------- backends

    def set_backends(self, addrs: List[Addr]):
        """Swap the pick set (thread-safe).  Removed backends drain:
        in-flight requests finish, new requests never land on them."""
        addrs = list(addrs)
        self._loop.call_soon(lambda: self._set_backends_on_loop(addrs))

    def _set_backends_on_loop(self, addrs: List[Addr]):
        want = set(addrs)
        for addr in want:
            b = self._table.get(addr)
            if b is None:
                self._table[addr] = _Backend(addr)
            else:
                b.draining = False
        for addr, b in list(self._table.items()):
            if addr not in want:
                if b.inflight > 0:
                    b.draining = True
                else:
                    del self._table[addr]

    def _release(self, backend: _Backend):
        backend.inflight -= 1
        if backend.draining and backend.inflight <= 0:
            if backend.addr in self._table:
                del self._table[backend.addr]

    def _pick(self, exclude: Optional[set] = None) -> Optional[_Backend]:
        avail = [b for b in self._table.values() if not b.draining
                 and not (exclude and b.addr in exclude)]
        if not avail:
            return None
        low = min(b.inflight for b in avail)
        tied = [b for b in avail if b.inflight == low]
        if len(tied) == 1:
            return tied[0]
        # power-of-two-choices over the tie: two seeded samples, fewest
        # cumulative attempts wins — spreads without a global counter
        # (errors count as attempts, else a dead backend's empty ledger
        # would win every tie and each request would pay a retry)
        a, c = self._rng.sample(tied, 2)
        return a if a.requests + a.errors <= c.requests + c.errors else c

    # ------------------------------------------------------------ accept

    def _on_accept(self, mask: int):
        for _ in range(64):
            try:
                sock, _addr = self._sock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            self._clients.add(_Client(self, sock))

    # ------------------------------------------------------------- stats

    def stats(self) -> dict:
        """Counters + per-backend table (snapshot; reader-friendly)."""
        table = {
            f"{a[0]}:{a[1]}": {"inflight": b.inflight,
                               "requests": b.requests,
                               "errors": b.errors,
                               "draining": b.draining}
            for a, b in list(self._table.items())
        }
        return {
            "policy": "least_inflight",
            "requests": self.requests_total,
            "retries": self.retries_total,
            "errors": self.errors_total,
            "backends": table,
            "picks": {f"{a[0]}:{a[1]}": n
                      for a, n in list(self.picks.items())},
        }

    def stop(self):
        if self._closed:
            return
        self._closed = True

        def _teardown():
            self._loop.unregister(self._sock)
            try:
                self._sock.close()
            except OSError:
                pass
            for c in list(self._clients):
                c.close()

        self._loop.call_soon(_teardown)


class EndpointsBalancerSync:
    """Feeds a balancer from a Service's Endpoints object: informer
    updates swap the backend set; only ready ``addresses`` are picked —
    ``notReadyAddresses`` (draining pods) fall out of the set, which IS
    the drain signal.  Pod IPs are synthetic in an in-process cluster,
    so the RESOLVER maps an address's pod identity (targetRef, ip as
    fallback) + port to the real (host, port) a backend listens on
    (``workloads/servefleet`` keeps that registry); a real deployment's
    resolver is the identity function on (ip, port).  ``factory`` is the
    port's ``client.InformerFactory``, whose caches hold wire-form dicts.

    A resolver's answer changes without an Endpoints event when a backend
    starts after its pod joined the Endpoints (or stops before it left):
    its owner calls ``refresh()`` then, which resolves the cached Endpoints
    again.  One lock orders the resolutions with their ``set_backends``,
    so a stale resolution never lands after a fresh one."""

    def __init__(self, balancer: LeastInflightBalancer, factory,
                 namespace: str, service: str,
                 resolver: Optional[Callable[[str, int],
                                             Optional[Addr]]] = None):
        self.balancer = balancer
        self.namespace = namespace
        self.service = service
        self.resolver = resolver or (lambda ip, port: (ip, port))
        self._lock = threading.Lock()
        self._informer = factory.informer("endpoints")
        self._informer.add_handler(
            on_add=self._on_change,
            on_update=lambda _o, n: self._on_change(n),
            on_delete=lambda o: self._on_change(None, deleted=o),
        )

    def refresh(self):
        """Resolve the Service's cached Endpoints again (thread-safe)."""
        with self._lock:
            obj = self._informer.get(f"{self.namespace}/{self.service}")
            if obj is not None:
                self._set_backends(obj)

    def _on_change(self, obj, deleted=None):
        target = f"{self.namespace}/{self.service}"
        if deleted is not None and object_key(deleted) == target:
            with self._lock:
                self.balancer.set_backends([])
            return
        if obj is None or object_key(obj) != target:
            return
        with self._lock:
            self._set_backends(obj)

    def _set_backends(self, obj):
        addrs: List[Addr] = []
        for subset in obj.get("subsets") or []:
            ports = subset.get("ports") or []
            port = int(ports[0].get("port") or 0) if ports else 0
            for a in subset.get("addresses") or []:
                resolved = self.resolver(a.get("targetRef") or a.get("ip", ""), port)
                if resolved is not None:
                    addrs.append(resolved)
        self.balancer.set_backends(addrs)
