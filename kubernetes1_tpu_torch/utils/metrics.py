"""Workload metrics: counters, gauges and histograms with Prometheus text output.

The port's own copy of the metric types the decode server exports (the
same classes and the same text format as the JAX package's
``utils/metrics``), so that a scrape of the port's ``/metrics`` reads
exactly like the original's.  Histograms keep a bounded sample reservoir
for in-process quantiles and cumulative ``_bucket`` counters for
scrapers; every metric doubles as a family whose ``labels(...)``
children render under one TYPE header.  ``MetricsServer`` serves a
component process's registry (the port's scheduler's) over HTTP.
"""

from __future__ import annotations

import bisect
import random
import threading
from typing import Dict, List, Optional, Tuple

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_str(labels: Optional[_LabelKey], extra: str = "") -> str:
    """'{a="b",c="d"}' (optionally merged with an extra 'k="v"' pair)."""
    parts = [f'{k}="{v}"' for k, v in (labels or ())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class Counter:
    def __init__(self, name: str, help_: str = "",
                 labels: Optional[_LabelKey] = None):
        self.name = name
        self.help = help_
        self._v = 0.0
        self._labels = labels
        self._children: Dict[_LabelKey, "Counter"] = {}
        # hot leaf lock, taken on every inc/observe
        self._lock = threading.Lock()

    def _make_child(self, key: _LabelKey) -> "Counter":
        return type(self)(self.name, self.help, labels=key)

    def labels(self, **kv: object) -> "Counter":
        """Child metric for this label set (created on first use)."""
        key = tuple(sorted((k, str(v)) for k, v in kv.items()))
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child(key)
        return child

    def _children_snapshot(self) -> List["Counter"]:
        with self._lock:
            return [self._children[k] for k in sorted(self._children)]

    def remove_labels(self, **kv: object):
        """Drop every labeled child whose label set contains all the given
        pairs — a deleted owner's series must not render forever."""
        match = {(k, str(v)) for k, v in kv.items()}
        with self._lock:
            for key in [k for k in self._children
                        if match.issubset(set(k))]:
                del self._children[key]

    def inc(self, amount: float = 1.0):
        with self._lock:
            self._v += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._v

    TYPE = "counter"

    def _sample_lines(self) -> List[str]:
        return [f"{self.name}{_label_str(self._labels)} {self.value}"]

    def render(self) -> str:
        children = self._children_snapshot()
        lines = [f"# TYPE {self.name} {self.TYPE}"]
        # the bare (unlabeled) series renders unless this is purely a
        # family handle for labeled children
        if not children or self._touched():
            lines.extend(self._sample_lines())
        for child in children:
            lines.extend(child._sample_lines())
        return "\n".join(lines) + "\n"

    def _touched(self) -> bool:
        return self.value != 0.0


class Gauge(Counter):
    TYPE = "gauge"

    def set(self, v: float):
        with self._lock:
            self._v = v


# Default latency buckets (seconds) — the prometheus client defaults plus a
# 30/60s tail for pod-startup SLIs (the GenAI-inference studies' regime).
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class Histogram:
    """Reservoir-sampled histogram: exact quantiles over the reservoir for
    in-process readers, plus cumulative `_bucket` counters for scrapers."""

    def __init__(self, name: str, help_: str = "", reservoir: int = 10000,
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
                 labels: Optional[_LabelKey] = None):
        self.name = name
        self.help = help_
        self._samples: List[float] = []
        self._count = 0
        self._sum = 0.0
        self._max_reservoir = reservoir
        self.buckets = tuple(sorted(buckets))
        self._bucket_counts = [0] * len(self.buckets)
        self._labels = labels
        self._children: Dict[_LabelKey, "Histogram"] = {}
        # hot leaf lock (every observe) — see Counter._lock
        self._lock = threading.Lock()

    def _make_child(self, key: _LabelKey) -> "Histogram":
        return Histogram(self.name, self.help, reservoir=self._max_reservoir,
                         buckets=self.buckets, labels=key)

    def labels(self, **kv: object) -> "Histogram":
        key = tuple(sorted((k, str(v)) for k, v in kv.items()))
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child(key)
        return child

    def _children_snapshot(self) -> List["Histogram"]:
        with self._lock:
            return [self._children[k] for k in sorted(self._children)]

    def remove_labels(self, **kv: object):
        """See Counter.remove_labels."""
        match = {(k, str(v)) for k, v in kv.items()}
        with self._lock:
            for key in [k for k in self._children
                        if match.issubset(set(k))]:
                del self._children[key]

    def observe(self, v: float):
        with self._lock:
            self._count += 1
            self._sum += v
            idx = bisect.bisect_left(self.buckets, v)
            if idx < len(self._bucket_counts):
                self._bucket_counts[idx] += 1
            if len(self._samples) < self._max_reservoir:
                bisect.insort(self._samples, v)
            else:
                idx = random.randrange(self._count)
                if idx < self._max_reservoir:
                    del self._samples[random.randrange(len(self._samples))]
                    bisect.insort(self._samples, v)

    def quantile(self, q: float) -> Optional[float]:
        with self._lock:
            if not self._samples:
                return None
            idx = min(len(self._samples) - 1, int(q * len(self._samples)))
            return self._samples[idx]

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def _sample_lines(self) -> List[str]:
        lines = []
        for q in (0.5, 0.9, 0.99):
            v = self.quantile(q)
            if v is not None:
                lines.append("%s%s %.6f" % (
                    self.name,
                    _label_str(self._labels, 'quantile="%s"' % q), v))
        with self._lock:
            cum, counts = 0, list(self._bucket_counts)
            count, total = self._count, self._sum
        for le, n in zip(self.buckets, counts):
            cum += n
            lines.append("%s_bucket%s %d" % (
                self.name, _label_str(self._labels, 'le="%s"' % le), cum))
        lines.append("%s_bucket%s %d" % (
            self.name, _label_str(self._labels, 'le="+Inf"'), count))
        lines.append("%s_sum%s %.6f" % (
            self.name, _label_str(self._labels), total))
        lines.append("%s_count%s %d" % (
            self.name, _label_str(self._labels), count))
        return lines

    def render(self) -> str:
        children = self._children_snapshot()
        lines = [f"# TYPE {self.name} histogram"]
        if not children or self.count:
            lines.extend(self._sample_lines())
        for child in children:
            lines.extend(child._sample_lines())
        return "\n".join(lines) + "\n"


class Registry:
    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def register(self, metric):
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None and existing is not metric:
                raise ValueError(
                    f"metric {metric.name!r} already registered as "
                    f"{type(existing).__name__}")
            self._metrics[metric.name] = metric
        return metric

    def _get_or_create(self, name: str, cls, help_: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help_)
            elif type(m) is not cls:
                # a silent wrong-type return here sent .observe() calls to a
                # Counter once — fail loudly at registration instead
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get_or_create(name, Counter, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get_or_create(name, Gauge, help_)

    def histogram(self, name: str, help_: str = "") -> Histogram:
        return self._get_or_create(name, Histogram, help_)

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        return "".join(m.render() for m in metrics)  # type: ignore[attr-defined]


class MetricsServer:
    """A component process's /metrics, /healthz and /readyz (and
    /debug/traces) over HTTP: the JAX package's ``MetricsServer`` without
    its flight recorder and profiler endpoints.

    ``extra`` maps a gauge name to a function read at each scrape.
    ``ready_fn`` backs /readyz: None means ready while serving; a callable
    gates readiness (informers synced, ...), and a falsy or raising one
    answers 503.  ``spans`` (a ``utils.spans.SpanCollector``) backs
    /debug/traces, served only on a loopback address."""

    def __init__(self, registry: Registry, host: str = "127.0.0.1",
                 port: int = 0, extra: Optional[Dict[str, object]] = None,
                 ready_fn=None, spans=None):
        import json as _json
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qs, urlsplit

        from .logutil import RateLimitedReporter

        extra_fns = dict(extra or {})
        # a permanently broken gauge must not print once a scrape
        gauge_err_reporter = RateLimitedReporter("metrics", window=60.0)
        debug_enabled = host in ("127.0.0.1", "localhost", "::1")

        class _H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # noqa: D102
                pass

            def _send(self, status: int, ctype: str, body: bytes):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                parts = urlsplit(self.path)
                if parts.path == "/debug/traces" and debug_enabled and spans is not None:
                    trace = (parse_qs(parts.query).get("trace") or [""])[0]
                    self._send(200, "application/json", spans.to_json(trace))
                elif parts.path == "/healthz":
                    self._send(200, "application/json",
                               _json.dumps({"status": "ok"}).encode())
                elif parts.path == "/readyz":
                    ready = True
                    if ready_fn is not None:
                        try:
                            ready = bool(ready_fn())
                        except Exception:  # noqa: BLE001 - a broken check reads as unready
                            ready = False
                    self._send(200 if ready else 503, "application/json", _json.dumps(
                        {"status": "ok" if ready else "unready"}).encode())
                elif parts.path == "/metrics":
                    text = registry.render()
                    for name, fn in extra_fns.items():
                        try:
                            text += f"# TYPE {name} gauge\n{name} {float(fn())}\n"
                        except Exception as e:  # noqa: BLE001 - one bad gauge must not end /metrics
                            gauge_err_reporter.report(f"extra gauge {name}: {e}")
                    self._send(200, "text/plain; version=0.0.4", text.encode())
                else:
                    self._send(404, "text/plain", b"")

        self._httpd = ThreadingHTTPServer((host, port), _H)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self.url = f"http://{self.host}:{self.port}"
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            daemon=True, name="metrics-server")
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
