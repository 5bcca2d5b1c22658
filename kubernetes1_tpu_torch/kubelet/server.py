"""Kubelet API server (ref: pkg/kubelet/server/server.go — the :10250
endpoint serving containerLogs/stats/pods; auth there is delegated to the
apiserver).  The port's copy of the JAX package's ``kubelet/server.py``,
its read-only half:

  GET  /healthz, /readyz                      open
  GET  /metrics                               open: prometheus text
  GET  /pods                                  pods this kubelet manages
  GET  /containerLogs/<ns>/<pod>[/<c>]        ?tail=N
  GET  /stats/summary                         node + per-pod usage
  GET  /debug/traces                          ?trace=<id>: the pods' spans

The node advertises the endpoint as the `kubelet.ktpu.io/server`
annotation on its Node object; the apiserver's log proxy resolves it from
there (the reference publishes :10250 in nodeStatus.daemonEndpoints the
same way) and sends the kubelet's bearer token, which every path but the
open ones requires.
"""

from __future__ import annotations

import hmac
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from .runtime import CONTAINER_RUNNING

OPEN_PATHS = ("healthz", "readyz", "metrics")


class _KubeletHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "ktpu-kubelet/0.1"
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):  # noqa: D102
        pass

    @property
    def kubelet(self):
        return self.server.kubelet  # type: ignore[attr-defined]

    def _send(self, code: int, payload, content_type="application/json"):
        raw = payload if isinstance(payload, bytes) else (
            payload.encode() if isinstance(payload, str) else json.dumps(payload).encode())
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def _authorized(self) -> bool:
        # constant-time compare of bytes (str compare_digest raises on
        # non-ASCII header values)
        return hmac.compare_digest(
            self.headers.get("Authorization", "").encode("utf-8", "surrogateescape"),
            f"Bearer {self.server.token}".encode())  # type: ignore[attr-defined]

    def _resolve_container(self, ns: str, pod_name: str, cname: str):
        """(pod, container_id), or (None, None) with the 404 sent."""
        kl = self.kubelet
        pod = kl.pods.get(f"{ns}/{pod_name}")
        if pod is None:
            self._send(404, {"error": f"pod {ns}/{pod_name} not found on this node"})
            return None, None
        cname = cname or pod.spec.containers[0].name
        with kl._lock:
            cid = kl._containers.get((pod.metadata.uid, cname))
        if cid is None:
            self._send(404, {"error": f"container {cname!r} has no runtime record"})
            return None, None
        return pod, cid

    def _metrics(self) -> str:
        """ref pkg/kubelet/metrics/, and the fork's
        DevicePluginAllocationLatency (manager.go:231)."""
        kl = self.kubelet
        running = sum(1 for c in kl.runtime.list_containers() if c.state == CONTAINER_RUNNING)
        return (f"# TYPE kubelet_running_pods gauge\n"
                f"kubelet_running_pods {len(kl.pods.list())}\n"
                f"# TYPE kubelet_running_containers gauge\n"
                f"kubelet_running_containers {running}\n"
                + kl.device_manager.allocation_latency.render())

    def do_GET(self):
        parsed = urlparse(self.path)
        parts = [p for p in parsed.path.split("/") if p]
        q = {k: v[0] for k, v in parse_qs(parsed.query).items()}
        kl = self.kubelet
        try:
            if parts and parts[0] not in OPEN_PATHS and not self._authorized():
                # everything that exposes workload data requires the token
                # the apiserver holds
                self._send(401, {"error": "unauthorized"})
            elif parts == ["healthz"]:
                self._send(200, {"status": "ok"})
            elif parts == ["readyz"]:
                # ready once the pod informer delivered its first LIST —
                # before that the kubelet can't know what it should run
                if kl.pods.has_synced():
                    self._send(200, {"status": "ok"})
                else:
                    self._send(503, {"status": "unready"})
            elif parts == ["metrics"]:
                self._send(200, self._metrics(), content_type="text/plain; version=0.0.4")
            elif parts == ["debug", "traces"]:
                self._send(200, kl.spans.to_json(q.get("trace", "")))
            elif parts == ["pods"]:
                self._send(200, {"pods": sorted(p.key() for p in kl.pods.list())})
            elif parts[:1] == ["containerLogs"] and len(parts) >= 3:
                pod, cid = self._resolve_container(parts[1], parts[2],
                                                   parts[3] if len(parts) > 3 else "")
                if pod is not None:
                    self._send(200, kl.runtime.read_log(cid, tail=int(q.get("tail") or 0)),
                               content_type="text/plain")
            elif parts[:2] == ["stats", "summary"] or parts == ["stats"]:
                self._send(200, kl.stats_summary())
            else:
                self._send(404, {"error": f"unknown path {parsed.path}"})
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as e:  # noqa: BLE001 - the error goes back to the caller
            try:
                self._send(500, {"error": str(e)})
            except OSError:
                pass  # client already disconnected


class _KubeletHTTPServer(ThreadingHTTPServer):
    daemon_threads = True

    def handle_error(self, request, client_address):
        # a peer gone mid-request is routine: no stack trace for it
        if isinstance(sys.exc_info()[1], (ConnectionError, TimeoutError)):
            return
        super().handle_error(request, client_address)


class KubeletServer:
    """Owns the HTTP listener; the kubelet advertises `self.url` on its Node."""

    def __init__(self, kubelet, host: str = "127.0.0.1", port: int = 0, token: str = ""):
        self._httpd = _KubeletHTTPServer((host, port), _KubeletHandler)
        self._httpd.kubelet = kubelet  # type: ignore[attr-defined]
        self._httpd.token = token  # type: ignore[attr-defined]
        self.host, self.port = self._httpd.server_address[:2]
        self.url = f"http://{self.host}:{self.port}"
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            daemon=True, name="kubelet-server",
        )
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
