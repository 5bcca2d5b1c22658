"""AppMetrics: the registry a workload embeds to export pod-level SLIs.

The port's copy of the JAX package's ``obs/appmetrics.AppMetrics``: a
metric registry plus sliding-window event rates, rendered in Prometheus
text on a pod-local ``/metrics`` endpoint.  The kubelet's pod scrape
agent lifts those series (``ktpu_llama_qps``, in-flight requests, latency
histograms, slot saturation) into PodCustomMetrics, the numbers an HPA's
Pods-type metric spec scales a serving Deployment on, so the metric
names and the text format are kept exactly.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from ..utils.metrics import Counter, Gauge, Histogram, Registry

# The scrape contract, carried on the pod as annotations: the port serving
# /metrics, its path, and a host in place of the pod IP (in-process
# clusters, whose pod IPs are synthetic, point the kubelet at loopback).
SCRAPE_PORT_ANNOTATION = "obs.ktpu.io/scrape-port"
SCRAPE_PATH_ANNOTATION = "obs.ktpu.io/scrape-path"
SCRAPE_HOST_ANNOTATION = "obs.ktpu.io/scrape-host"
DEFAULT_SCRAPE_PATH = "/metrics"


def scrape_annotations(port: int, path: str = DEFAULT_SCRAPE_PATH,
                       host: str = "") -> Dict[str, str]:
    """The annotations a pod spec carries to have the kubelet scrape it."""
    out = {SCRAPE_PORT_ANNOTATION: str(int(port))}
    if path and path != DEFAULT_SCRAPE_PATH:
        out[SCRAPE_PATH_ANNOTATION] = path
    if host:
        out[SCRAPE_HOST_ANNOTATION] = host
    return out


def scrape_target(pod) -> Optional[str]:
    """A typed pod's scrape annotations as its /metrics URL, or None when
    the pod is not annotated or the annotation is malformed (the JAX
    package's ``obs/appmetrics.scrape_target``)."""
    ann = pod.metadata.annotations or {}
    port = ann.get(SCRAPE_PORT_ANNOTATION)
    if not port:
        return None
    try:
        port_n = int(port)
    except ValueError:
        return None
    if not 0 < port_n < 65536:
        return None
    host = ann.get(SCRAPE_HOST_ANNOTATION) or pod.status.pod_ip \
        or pod.status.host_ip
    if not host:
        return None
    path = ann.get(SCRAPE_PATH_ANNOTATION) or DEFAULT_SCRAPE_PATH
    if not path.startswith("/"):
        path = "/" + path
    return f"http://{host}:{port_n}{path}"


def sample_value(pcm, metric_name: str) -> Optional[float]:
    """A PodCustomMetrics object's scalar for ``metric_name``: the
    unlabeled sample wins; labeled children SUM.  None when the metric is
    not there (the JAX package's ``obs/appmetrics.sample_value``)."""
    labeled_sum = None
    for s in pcm.samples:
        if s.name != metric_name:
            continue
        if not s.labels:
            return s.value
        labeled_sum = (labeled_sum or 0.0) + s.value
    return labeled_sum


class AppMetrics:
    """One workload process's metric registry and /metrics endpoint.

    ``counter/gauge/histogram`` mint (or return) named metrics like a
    Registry; ``serve()`` exposes them over HTTP on an ephemeral (or
    fixed) port.  ``mark``/``window_rate`` give the observed event rate
    over a sliding window, published as a gauge at every render so
    scrape consumers don't each have to differentiate counters.
    """

    def __init__(self, rate_window_s: float = 5.0):
        self.registry = Registry()
        self.rate_window_s = rate_window_s
        self._events: Dict[str, deque] = {}
        self._lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None

    def counter(self, name: str, help_: str = "") -> Counter:
        return self.registry.counter(name, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self.registry.gauge(name, help_)

    def histogram(self, name: str, help_: str = "") -> Histogram:
        return self.registry.histogram(name, help_)

    # ------------------------------------------------------------- QPS

    def mark(self, name: str, n: int = 1):
        """Record `n` events toward `name`'s sliding-window rate."""
        now = time.monotonic()
        floor = now - self.rate_window_s
        with self._lock:
            dq = self._events.get(name)
            if dq is None:
                dq = self._events[name] = deque()
            dq.append((now, n))
            # prune here too, not only in window_rate(): a pod nothing
            # ever scrapes must not grow the deque without bound
            while dq and dq[0][0] < floor:
                dq.popleft()

    def window_rate(self, name: str) -> float:
        """Events/second over the trailing window (0.0 before any mark)."""
        now = time.monotonic()
        floor = now - self.rate_window_s
        with self._lock:
            dq = self._events.get(name)
            if not dq:
                return 0.0
            while dq and dq[0][0] < floor:
                dq.popleft()
            total = sum(n for _t, n in dq)
        return total / self.rate_window_s

    def set_rate_gauges(self):
        """Publish every marked rate as its gauge (called before each
        render so the scraped value is current, not last-marked)."""
        with self._lock:
            names = list(self._events)
        for name in names:
            self.registry.gauge(name).set(self.window_rate(name))

    # ----------------------------------------------------------- serving

    def render(self) -> str:
        self.set_rate_gauges()
        return self.registry.render()

    def serve(self, host: str = "127.0.0.1", port: int = 0) -> "AppMetrics":
        """Start the /metrics (and /healthz) endpoint (idempotent)."""
        if self._httpd is not None:
            return self
        app = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path.startswith("/metrics"):
                    code, ctype = 200, "text/plain; version=0.0.4"
                    body = app.render().encode()
                elif self.path == "/healthz":
                    code, ctype, body = 200, "application/json", b'{"status":"ok"}'
                else:
                    code, ctype, body = 404, "application/json", b'{"error":"unknown path"}'
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        threading.Thread(target=self._httpd.serve_forever,
                         kwargs={"poll_interval": 0.2}, daemon=True,
                         name="appmetrics-server").start()
        return self

    @property
    def port(self) -> int:
        if self._httpd is None:
            raise RuntimeError("AppMetrics.serve() not called")
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        if self._httpd is None:
            raise RuntimeError("AppMetrics.serve() not called")
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
