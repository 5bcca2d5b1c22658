"""Pod-startup SLIs: a watch-driven decomposition of create -> Running.

The port's copy of the JAX package's ``utils/slo.py``.  The tracker turns
the control plane's phase stamps into per-phase Prometheus histograms:

  phase="scheduled"          created-at   -> scheduled-at
  phase="bind"               scheduled-at -> bound-at
  phase="admitted"           bound-at     -> admitted-at (kubelet and
                                             device plugin AdmitPod)
  phase="running"            admitted-at  -> Running observed
  phase="device_allocation"  scheduled-at -> admitted-at (pods that ask
                                             for cards only)
  phase="total"              created-at   -> Running observed

The stamps are wall-clock annotations written by the component that owns
each transition; "Running observed" is the tracker's own receipt of the
watch event, so the total includes the watch's fan-out.  The histograms
land in a Registry, served on an optional ``MetricsServer``; ``report()``
summarises them in process.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from ..api import types as t
from .metrics import MetricsServer, Registry

PHASE_METRIC = "ktpu_pod_startup_phase_seconds"

# (phase label, start stamp key, end stamp key); None = Running observation
_PHASES = (
    ("scheduled", t.CREATED_AT_ANNOTATION, t.SCHEDULED_AT_ANNOTATION),
    ("bind", t.SCHEDULED_AT_ANNOTATION, t.BOUND_AT_ANNOTATION),
    ("admitted", t.BOUND_AT_ANNOTATION, t.ADMITTED_AT_ANNOTATION),
    ("running", t.ADMITTED_AT_ANNOTATION, None),
    ("total", t.CREATED_AT_ANNOTATION, None),
)


def _stamp(pod, key: str) -> Optional[float]:
    raw = (pod.metadata.annotations or {}).get(key)
    if not raw:
        return None
    try:
        return float(raw)
    except (TypeError, ValueError):
        return None


class StartupSLITracker:
    """Watches pods and feeds the per-phase startup histograms.

    Runs anywhere a Clientset reaches the apiserver (``LocalCluster``
    wires one).  Pods already Running (or already bound with no created-at
    stamp) at first sight are ignored: their transitions predate this
    tracker and observation time would fabricate latencies."""

    def __init__(self, clientset, registry: Optional[Registry] = None,
                 metrics_port: Optional[int] = None):
        self.registry = registry or Registry()
        self.phase_seconds = self.registry.histogram(
            PHASE_METRIC,
            "pod-startup latency decomposed per phase (label phase=...)")
        self.pods_started = self.registry.counter(
            "ktpu_pods_started_total",
            "pods observed reaching Running with full SLI decomposition")
        self.informer = clientset.informer("pods")
        self._lock = threading.Lock()
        self._seen: Dict[str, dict] = {}  # uid -> {"done": bool, ...}
        self.metrics_server: Optional[MetricsServer] = None
        if metrics_port is not None:
            self.metrics_server = MetricsServer(
                self.registry, port=metrics_port,
                ready_fn=self.informer.has_synced)

    # ---------------------------------------------------------------- wiring

    def start(self) -> "StartupSLITracker":
        self.informer.add_handler(
            on_add=self._on_event,
            on_update=lambda _old, pod: self._on_event(pod),
            on_delete=self._on_delete,
        )
        self.informer.start()
        if self.metrics_server is not None:
            self.metrics_server.start()
        return self

    def stop(self):
        self.informer.stop()
        if self.metrics_server is not None:
            self.metrics_server.stop()

    # ------------------------------------------------------------- recording

    def _on_event(self, pod):
        self.record(pod, now=time.time())

    def _on_delete(self, pod):
        with self._lock:
            self._seen.pop(pod.metadata.uid, None)

    def record(self, pod, now: float):
        """Observe one watch event for `pod` at wall time `now`.  Pure
        state-machine + histogram math — tests drive it directly."""
        uid = pod.metadata.uid
        running = pod.status.phase == t.POD_RUNNING
        with self._lock:
            rec = self._seen.get(uid)
            if rec is None:
                # replayed history: a pod that reaches us already Running
                # (or mid-flight with no creation stamp) can't be decomposed
                ignore = running or (bool(pod.spec.node_name)
                                     and _stamp(pod, t.CREATED_AT_ANNOTATION)
                                     is None)
                rec = self._seen[uid] = {"done": ignore}
            if rec["done"] or not running:
                return
            rec["done"] = True
        stamps = {key: _stamp(pod, key)
                  for _, key, _ in _PHASES if key is not None}
        complete = True
        for phase, start_key, end_key in _PHASES:
            start = stamps.get(start_key)
            end = now if end_key is None else _stamp(pod, end_key)
            if start is None or end is None or end < start:
                complete = False
                continue
            self.phase_seconds.labels(phase=phase).observe(end - start)
        if pod.spec.extended_resources:
            start = _stamp(pod, t.SCHEDULED_AT_ANNOTATION)
            end = _stamp(pod, t.ADMITTED_AT_ANNOTATION)
            if start is not None and end is not None and end >= start:
                self.phase_seconds.labels(
                    phase="device_allocation").observe(end - start)
        if complete:
            self.pods_started.inc()

    # -------------------------------------------------------------- readouts

    def report(self) -> dict:
        """Per-phase summary: {phase: {count, p50_s, p99_s}}."""
        out = {}
        phases = [p for p, _, _ in _PHASES] + ["device_allocation"]
        for phase in phases:
            h = self.phase_seconds.labels(phase=phase)
            if not h.count:
                continue
            out[phase] = {
                "count": h.count,
                "p50_s": round(h.quantile(0.5) or 0.0, 4),
                "p99_s": round(h.quantile(0.99) or 0.0, 4),
            }
        return out
