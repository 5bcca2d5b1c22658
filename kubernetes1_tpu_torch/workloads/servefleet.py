"""Serving backend fleet: one live backend for each Running pod of a
Deployment, and a rolling update measured through.

The port's copy of the JAX package's ``workloads/servefleet``, over the
port's apiserver client (``client/``): pods are wire-form dicts.  A pod of
an in-process cluster has a synthetic IP, and a pod of a one-card machine
may stand for a server that this process holds on the card, so
``ServeFleet`` keeps exactly one live HTTP backend per Running pod of the
app, and the pod-NAME -> (host, port) registry that a balancer's endpoints
sync resolves through (an Endpoints address carries the pod's name as its
``targetRef``).

Lifecycle, the drain contract end to end:
- pod reaches Running -> its backend starts, and the pod is annotated
  with the obs.ktpu.io scrape contract at that backend's own port;
- pod starts terminating -> nothing here: the endpoints controller moves
  it to notReadyAddresses and the balancer stops picking it, while its
  open responses keep streaming;
- pod object deleted -> the backend lingers ``LINGER_S`` (the tail of an
  in-flight response), then stops.

``SyntheticBackend`` is the stand-in of tests: the decode server's HTTP,
streaming, slot and metrics contract, with a per-token delay in place of
a forward pass.  A port ``llama.DecodeServer`` is a backend as it is
(``start()`` returns it, ``port``, ``stop()``): pass
``backend_factory=lambda pod: DecodeServer(...).start()``.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple

from ..client.errors import is_transient, retry_on_conflict
from ..obs.appmetrics import AppMetrics, scrape_annotations
from ..utils import retry
from .specs import pod_ready

Addr = Tuple[str, int]
# How long a deleted pod's backend keeps serving its in-flight responses.
LINGER_S = 0.5


class SyntheticBackend:
    """The decode server's serving contract without the model: POST
    /generate (buffered, or ndjson streamed), GET /metrics with the same
    ktpu_llama_* names (slot gauges included), GET /healthz.
    ``token_delay_s`` paces each token.  ``slots`` is real capacity, as in
    the batch engine's pool: at most ``slots`` requests decode at once and
    the rest queue, so an overloaded replica shows as latency."""

    def __init__(self, token_delay_s: float = 0.002, slots: int = 8):
        self.token_delay_s = token_delay_s
        self.slots = slots
        self._stopping = False
        self.metrics = AppMetrics()
        self.requests_total = self.metrics.counter(
            "ktpu_llama_requests_total", "requests served")
        self.errors_total = self.metrics.counter(
            "ktpu_llama_request_errors_total", "malformed requests")
        self.inflight = self.metrics.gauge("ktpu_llama_inflight", "requests in flight")
        self.latency = self.metrics.histogram(
            "ktpu_llama_request_latency_seconds", "request latency")
        self.slots_total = self.metrics.gauge("ktpu_llama_slots_total", "slot pool size")
        self.slots_used = self.metrics.gauge("ktpu_llama_slots_used", "slots leased")
        self.slots_total.set(float(slots))
        self._active = 0
        self._cond = threading.Condition()
        self._srv: Optional[ThreadingHTTPServer] = None

    def _admit(self) -> bool:
        """Wait for a slot (the handler's thread is the queue entry); False
        when the backend stops first."""
        with self._cond:
            while self._active >= self.slots and not self._stopping:
                self._cond.wait(timeout=0.5)
            if self._stopping:
                return False
            self._active += 1
            self.slots_used.set(float(self._active))
            return True

    def _release(self):
        with self._cond:
            self._active -= 1
            self.slots_used.set(float(self._active))
            self._cond.notify()

    def start(self) -> "SyntheticBackend":
        backend = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _send(self, code, body: bytes, ctype: str = "application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/metrics"):
                    self._send(200, backend.metrics.render().encode(),
                               "text/plain; version=0.0.4")
                elif self.path.startswith("/healthz"):
                    self._send(200, b'{"status":"ok"}')
                else:
                    self._send(404, b'{"error":"unknown path"}')

            def do_POST(self):
                if not self.path.startswith("/generate"):
                    self._send(404, b'{"error":"unknown path"}')
                    return
                n = int(self.headers.get("Content-Length") or 0)
                try:
                    req = json.loads(self.rfile.read(n) or b"{}")
                    toks = [int(x) for x in (req.get("tokens") or [1])]
                    max_new = min(64, int(req.get("max_new") or 8))
                    stream = bool(req.get("stream"))
                except (ValueError, TypeError, AttributeError):
                    backend.errors_total.inc()
                    self._send(400, b'{"error":"bad request"}')
                    return
                t0 = time.monotonic()
                backend.inflight.inc()
                if not backend._admit():
                    backend.inflight.inc(-1)
                    backend.errors_total.inc()
                    self._send(503, b'{"error":"shutting down"}')
                    return
                try:
                    out = [(sum(toks) + i) % 256 for i in range(max_new)]
                    if stream:
                        self.send_response(200)
                        self.send_header("Content-Type", "application/x-ndjson")
                        self.send_header("Transfer-Encoding", "chunked")
                        self.end_headers()

                        def chunk(payload: bytes):
                            self.wfile.write(b"%x\r\n%s\r\n" % (len(payload), payload))

                        for tok in out:
                            time.sleep(backend.token_delay_s)
                            chunk(b'{"token":%d}\n' % tok)
                        chunk(b'{"done":true}\n')
                        self.wfile.write(b"0\r\n\r\n")
                    else:
                        time.sleep(backend.token_delay_s * max_new)
                        self._send(200, json.dumps({"tokens": out}).encode())
                finally:
                    backend.inflight.inc(-1)
                    backend._release()
                    backend.requests_total.inc()
                    backend.metrics.mark("ktpu_llama_qps")
                    backend.metrics.mark("ktpu_llama_tokens_per_s", max_new)
                    backend.latency.observe(time.monotonic() - t0)

        self._srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._srv.daemon_threads = True
        threading.Thread(target=self._srv.serve_forever, daemon=True,
                         name="synthetic-backend").start()
        return self

    @property
    def port(self) -> int:
        return self._srv.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._srv.server_address[:2]
        return f"http://{host}:{port}"

    def stop(self):
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
        self.metrics.stop()


def synthetic_factory(token_delay_s: float = 0.002, slots: int = 8):
    """A ServeFleet backend factory of SyntheticBackends."""

    def make(pod: dict):
        return SyntheticBackend(token_delay_s=token_delay_s, slots=slots).start()

    return make


def _meta(pod: dict) -> dict:
    return pod.get("metadata") or {}


class ServeFleet:
    """One live backend per Running pod of ``app`` in ``namespace`` (see
    the module docstring).  ``backend_factory(pod)`` returns a started
    object with ``.port`` and ``.stop()``; the default makes
    SyntheticBackends.  ``factory`` is the ``client.InformerFactory`` whose
    pods informer drives it: start it after making the fleet."""

    def __init__(self, client, factory, app: str, backend_factory: Optional[Callable] = None,
                 namespace: str = "default"):
        self.client = client
        self.app = app
        self.namespace = namespace
        self.backend_factory = backend_factory or synthetic_factory()
        self._lock = threading.Lock()
        self._by_uid: Dict[str, object] = {}   # pod uid -> backend (None while it starts)
        # pod NAME -> (host, port): every in-process pod shares one IP, so the
        # name (the address's targetRef) is the identity a balancer resolves
        self._by_name: Dict[str, Addr] = {}
        self._uid_name: Dict[str, str] = {}
        self._closed = False
        self.started = 0
        self.stopped = 0
        # the best-effort paths count their failures instead of hiding them
        self.annotate_errors = 0
        self.teardown_errors = 0
        factory.informer("pods").add_handler(
            on_add=self._pod_event, on_update=lambda _old, new: self._pod_event(new),
            on_delete=self._pod_deleted)

    # ------------------------------------------------------------- events

    def _mine(self, pod: dict) -> bool:
        meta = _meta(pod)
        return (meta.get("namespace") == self.namespace
                and (meta.get("labels") or {}).get("app") == self.app)

    def _pod_event(self, pod: dict):
        if not self._mine(pod) or (pod.get("status") or {}).get("phase") != "Running":
            return
        uid, name = _meta(pod)["uid"], _meta(pod)["name"]
        with self._lock:
            if uid in self._by_uid or self._closed:
                return
            self._by_uid[uid] = None  # reserve under the lock, build outside it
        backend = self.backend_factory(pod)
        with self._lock:
            self.started += 1
            # the pod went (or the fleet stopped) while its backend started:
            # nothing routes to it, so it stops now rather than serve no pod
            gone = self._closed or uid not in self._by_uid
            if not gone:
                self._by_uid[uid] = backend
                self._by_name[name] = ("127.0.0.1", backend.port)
                self._uid_name[uid] = name
        if gone:
            self._stop_backend(backend)
        else:
            self._annotate_pod(name, backend.port)

    def _annotate_pod(self, name: str, port: int):
        """Point the kubelet's pod scrape at this pod's own backend."""

        def patch():
            cur = self.client.pods.get(name, self.namespace)
            meta = cur.setdefault("metadata", {})
            meta["annotations"] = {**(meta.get("annotations") or {}),
                                   **scrape_annotations(port, host="127.0.0.1")}
            self.client.pods.update(cur)

        try:
            retry_on_conflict(patch)
        except Exception:  # noqa: BLE001 - the scrape annotation is best-effort; serving works without it
            with self._lock:
                self.annotate_errors += 1

    def _stop_backend(self, backend):
        try:
            backend.stop()
        except Exception:  # noqa: BLE001 - teardown is best-effort, counted
            with self._lock:
                self.teardown_errors += 1
        with self._lock:
            self.stopped += 1

    def _pod_deleted(self, pod: dict):
        if not self._mine(pod):
            return
        uid = _meta(pod).get("uid")
        with self._lock:
            backend = self._by_uid.pop(uid, None)
            name = self._uid_name.pop(uid, None)
            if name is not None:
                self._by_name.pop(name, None)
        if backend is None:
            return  # none, or still starting: _pod_event stops it

        def stop_later():
            # the drain tail: the balancer stopped picking this backend when
            # it left the Endpoints; let the last response finish
            time.sleep(LINGER_S)
            self._stop_backend(backend)

        threading.Thread(target=stop_later, name="servefleet-drain", daemon=True).start()

    # ------------------------------------------------------------- lookup

    def resolver(self, key: str, port: int) -> Optional[Addr]:
        """An endpoints sync's resolver: the address's identity (its
        targetRef, the pod's name) -> the live backend's loopback address
        (None while the backend is still starting)."""
        with self._lock:
            return self._by_name.get(key)

    def backends(self) -> List[Addr]:
        with self._lock:
            return list(self._by_name.values())

    def wait_backends(self, want: int, timeout: float = 30.0) -> int:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                n = len(self._by_name)
            if n >= want:
                return n
            time.sleep(0.05)
        with self._lock:
            return len(self._by_name)

    def settled(self, replicas: int, old: set) -> Optional[set]:
        """The backends of the app's Ready pods once there are ``replicas``
        of them, each has its own, none is in ``old`` and every other
        backend has stopped (an old pod's, or that of a surge pod the
        controllers ran beside a rollout's); else None."""
        pods = [p for p in self.client.pods.list(self.namespace, f"app={self.app}")[0]
                if pod_ready(p)]
        addrs = {self.resolver(_meta(p)["name"], 0) for p in pods}
        if len(pods) == replicas and None not in addrs and len(addrs) == replicas \
                and not addrs & old and self.stopped == self.started - replicas:
            return addrs
        return None

    def stop(self):
        """Stop every backend; one still starting stops when it has."""
        with self._lock:
            self._closed = True
            backends = [b for b in self._by_uid.values() if b is not None]
            self._by_uid.clear()
            self._by_name.clear()
            self._uid_name.clear()
        for b in backends:
            self._stop_backend(b)


# ------------------------------------------------------------------ rollout


def rolling_update(client, name: str, namespace: str = "default", timeout: float = 60.0,
                   poll_s: float = 0.05) -> dict:
    """Start a RollingUpdate of Deployment ``name`` (a template bump) and
    watch it through, its pods picked by ``app=<name>``: the duration, the
    fewest Ready pods seen at once (the floor the PDB and the rolling logic
    must hold) and the final replica count."""

    def bump():
        dep = client.deployments.get(name, namespace)
        tmeta = dep["spec"]["template"].setdefault("metadata", {})
        # the value only has to differ per rollout: wall time, as kubectl does
        tmeta["annotations"] = {**(tmeta.get("annotations") or {}),
                                "ktpu.io/restartedAt": str(time.time())}
        client.deployments.update(dep)
        return dep

    selector = f"app={name}"
    old_pods, _ = client.pods.list(namespace, selector)
    old_names = {_meta(p)["name"] for p in old_pods}
    # a Conflict re-reads; a transient fault retries the whole bump
    dep = retry.call_with_retries(lambda: retry_on_conflict(bump), is_transient,
                                  steps=5, backoff=retry.Backoff(base=0.05, cap=0.5))
    want = dep["spec"].get("replicas", 1)
    t0 = time.monotonic()
    min_ready = want
    done = False
    poll_errors = 0
    while time.monotonic() - t0 < timeout:
        try:
            pods, _ = client.pods.list(namespace, selector)
        except Exception:  # noqa: BLE001 - a transient client fault: counted, the next poll retries
            poll_errors += 1
            time.sleep(poll_s)
            continue
        ready = [p for p in pods if pod_ready(p)]
        min_ready = min(min_ready, len(ready))
        # done = every Ready pod is new and the set is full: by pod identity,
        # since right after the bump the Deployment's status still counts
        # the old pods as updated and ready
        new_ready = [p for p in ready if _meta(p)["name"] not in old_names]
        if len(new_ready) >= want and len(ready) == len(new_ready):
            try:
                st = client.deployments.get(name, namespace).get("status") or {}
            except Exception:  # noqa: BLE001 - a transient client fault: counted, the next poll retries
                poll_errors += 1
                time.sleep(poll_s)
                continue
            if (st.get("updatedReplicas", 0) >= want and st.get("readyReplicas", 0) >= want
                    and st.get("replicas", 0) == want):
                done = True
                break
        time.sleep(poll_s)
    return {"completed": done, "duration_s": round(time.monotonic() - t0, 3),
            "min_ready_observed": min_ready, "replicas": want, "poll_errors": poll_errors}
