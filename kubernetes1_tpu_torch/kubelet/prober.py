"""Probe manager: per-container liveness/readiness workers.

Ref: pkg/kubelet/prober/{prober_manager.go,worker.go,prober.go} — one worker
per (container, probe type) running on the probe's period; readiness results
gate the pod Ready condition (and through it Endpoints membership); a
liveness failure past failureThreshold makes the kubelet restart the
container. Probe actions: exec (run in container), httpGet, tcpSocket.
The port's copy of the JAX package's ``kubelet/prober.py``.
"""

from __future__ import annotations

import socket
import threading
import urllib.request
from typing import Callable, Dict, Optional, Tuple

from ..api import types as t

SUCCESS = "success"
FAILURE = "failure"
UNKNOWN = "unknown"


def run_probe(probe: t.Probe, target_host: str, exec_fn=None) -> bool:
    """Execute one probe attempt. exec_fn(command) -> exit code (for exec
    probes; the runtime provides the in-container execution)."""
    if probe.exec_action is not None:
        if exec_fn is None:
            return False
        try:
            return exec_fn(probe.exec_action.command) == 0
        except Exception:  # noqa: BLE001
            return False
    if probe.http_get is not None:
        host = probe.http_get.host or target_host or "127.0.0.1"
        url = f"http://{host}:{probe.http_get.port}{probe.http_get.path}"
        try:
            with urllib.request.urlopen(url, timeout=probe.timeout_seconds) as resp:
                return 200 <= resp.status < 400
        except Exception:  # noqa: BLE001
            return False
    if probe.tcp_socket is not None:
        host = probe.tcp_socket.host or target_host or "127.0.0.1"
        try:
            with socket.create_connection(
                (host, probe.tcp_socket.port), timeout=probe.timeout_seconds
            ):
                return True
        except OSError:
            return False
    return True  # no action configured counts as success (reference behavior)


class _Worker:
    """One probe loop (ref: prober/worker.go)."""

    def __init__(self, probe: t.Probe, kind: str, target_host: str,
                 exec_fn, on_result: Callable[[str], None],
                 is_running: Optional[Callable[[], bool]] = None):
        self.probe = probe
        self.kind = kind  # "liveness" | "readiness"
        self.target_host = target_host
        self.exec_fn = exec_fn
        self.on_result = on_result
        self.is_running = is_running
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._successes = 0
        self._failures = 0

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    def _run(self):
        if self.probe.initial_delay_seconds:
            if self._stop.wait(self.probe.initial_delay_seconds):
                return
        # readiness starts False until the first success; liveness starts OK
        while not self._stop.is_set():
            if self.is_running is not None and not self.is_running():
                # container down (crashed / restart backoff): don't probe —
                # a failure recorded now would be charged to the NEXT
                # instance and kill it the moment it comes up (the reference
                # prober likewise only probes running containers)
                self._successes = self._failures = 0
                if self._stop.wait(max(self.probe.period_seconds, 0.05)):
                    return
                continue
            ok = run_probe(self.probe, self.target_host, self.exec_fn)
            if ok:
                self._successes += 1
                self._failures = 0
                if self._successes >= self.probe.success_threshold:
                    self.on_result(SUCCESS)
            else:
                self._failures += 1
                self._successes = 0
                if self._failures >= self.probe.failure_threshold:
                    self.on_result(FAILURE)
            if self._stop.wait(max(self.probe.period_seconds, 0.05)):
                return


class ProberManager:
    """Tracks workers per (pod_uid, container, kind) and exposes results
    (ref: prober/prober_manager.go)."""

    def __init__(self, exec_in_container=None, container_running=None):
        # exec_in_container(pod_uid, container_name, command) -> exit code
        # container_running(pod_uid, container_name) -> bool
        self.exec_in_container = exec_in_container
        self.container_running = container_running
        self._lock = threading.Lock()
        self._workers: Dict[Tuple[str, str, str], _Worker] = {}
        self._results: Dict[Tuple[str, str, str], str] = {}

    def ensure_pod(self, pod: t.Pod):
        """Start workers for every probed container of a running pod."""
        uid = pod.metadata.uid
        host = pod.status.pod_ip or "127.0.0.1"
        for container in pod.spec.containers:
            for kind, probe in (
                ("liveness", container.liveness_probe),
                ("readiness", container.readiness_probe),
            ):
                if probe is None:
                    continue
                key = (uid, container.name, kind)
                with self._lock:
                    if key in self._workers:
                        continue
                    if kind == "readiness":
                        self._results[key] = UNKNOWN  # not ready until proven
                    exec_fn = None
                    cname = container.name
                    if self.exec_in_container is not None:
                        exec_fn = lambda cmd, u=uid, c=cname: self.exec_in_container(u, c, cmd)  # noqa: E731
                    is_running = None
                    if self.container_running is not None:
                        is_running = lambda u=uid, c=cname: self.container_running(u, c)  # noqa: E731
                    worker = _Worker(
                        probe, kind, host, exec_fn,
                        on_result=lambda res, k=key: self._record(k, res),
                        is_running=is_running,
                    )
                    self._workers[key] = worker
                worker.start()

    def _record(self, key, result: str):
        with self._lock:
            self._results[key] = result

    def remove_pod(self, pod_uid: str):
        with self._lock:
            for key in [k for k in self._workers if k[0] == pod_uid]:
                self._workers.pop(key).stop()
                self._results.pop(key, None)

    def restart_container(self, pod_uid: str, container_name: str):
        """Reset probe state after a container restart."""
        with self._lock:
            for kind in ("liveness", "readiness"):
                key = (pod_uid, container_name, kind)
                worker = self._workers.pop(key, None)
                if worker is not None:
                    worker.stop()
                self._results.pop(key, None)

    def is_ready(self, pod_uid: str, container_name: str) -> bool:
        """True unless a readiness probe exists and hasn't succeeded."""
        key = (pod_uid, container_name, "readiness")
        with self._lock:
            if key not in self._workers and key not in self._results:
                return True
            return self._results.get(key) == SUCCESS

    def liveness_failed(self, pod_uid: str, container_name: str) -> bool:
        key = (pod_uid, container_name, "liveness")
        with self._lock:
            return self._results.get(key) == FAILURE

    def stop(self):
        with self._lock:
            for worker in self._workers.values():
                worker.stop()
            self._workers.clear()
            self._results.clear()
