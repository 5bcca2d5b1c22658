"""Kubelet API server (ref: pkg/kubelet/server/server.go — the :10250
endpoint serving containerLogs/exec/attach/portForward/stats/pods; auth
there is delegated to the apiserver, streaming rides SPDY through
client-go/tools/remotecommand).  The port's copy of the JAX package's
``kubelet/server.py``:

  GET  /healthz, /readyz                      open
  GET  /metrics                               open: prometheus text
  GET  /pods                                  pods this kubelet manages
  GET  /containerLogs/<ns>/<pod>[/<c>]        ?tail=N
  GET  /stats/summary                         node + per-pod usage
  GET  /debug/traces                          ?trace=<id>: the pods' spans
  POST /exec/<ns>/<pod>[/<c>]                 {"command": [...]}
       -> {"exitCode": N, "output": "..."}    (ExecSync)
  GET  /exec/<ns>/<pod>[/<c>]                 ?command=..&stdin=1&tty=1, upgraded
  GET  /attach/<ns>/<pod>[/<c>]               upgraded: a 4 KiB tail of the
       log, then its growth until the container exits, then its exit code
  GET  /portForward/<ns>/<pod>                ?port=N, upgraded: raw bytes
       to and from 127.0.0.1:N

The three streams ride ``Upgrade: ktpu-stream`` (``utils/streams``).  The
node advertises the endpoint as the `kubelet.ktpu.io/server` annotation
on its Node object; the apiserver's log and stream proxies resolve it
from there (the reference publishes :10250 in nodeStatus.daemonEndpoints
the same way) and send the kubelet's bearer token, which every path but
the open ones requires.
"""

from __future__ import annotations

import fcntl
import hmac
import json
import os
import socket
import struct
import sys
import termios
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from ..utils import eventloop
from ..utils.streams import (ERROR, RESIZE, STDERR, STDIN, STDOUT, accept_upgrade, read_frame,
                             send_status, splice, wants_upgrade, write_frame)
from .runtime import CONTAINER_RUNNING

OPEN_PATHS = ("healthz", "readyz", "metrics")
STREAMS = ("exec", "attach", "portForward")
ATTACH_REPLAY_BYTES = 4096  # the log's tail an attacher sees first


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

    # ------------------------------------------------------------ streaming

    def _handle_stream(self, parts, rawq, q):
        """Upgraded bidirectional streams (ref: pkg/kubelet/server
        remotecommand exec/attach and portforward over SPDY; here the
        ktpu-stream channel protocol)."""
        kind = parts[0]
        if kind == "portForward":
            ns, pod_name = parts[1], parts[2]
            if self.kubelet.pods.get(f"{ns}/{pod_name}") is None:
                self._send(404, {"error": f"pod {ns}/{pod_name} not found on this node"})
                return
            port = int(q.get("port") or 0)
            if not port:
                self._send(400, {"error": "port required"})
                return
            try:
                target = socket.create_connection(("127.0.0.1", port), timeout=5)
            except OSError as e:
                self._send(502, {"error": f"connect 127.0.0.1:{port}: {e}"})
                return
            target.settimeout(None)
            sock = accept_upgrade(self)
            if sock is None:
                target.close()
                self._send(400, {"error": "expected Upgrade: ktpu-stream"})
                return
            try:
                splice(sock, target)  # raw bytes, no framing: the data is opaque
            finally:
                target.close()
            return

        pod, cid = self._resolve_container(parts[1], parts[2],
                                           parts[3] if len(parts) > 3 else "")
        if pod is None:
            return
        if kind == "attach":
            # a ProcessRuntime container writes its stdio to its log file:
            # attach follows that file (no held-open stdio pipe to take over)
            record = self.kubelet.runtime.container_status(cid)
            sock = accept_upgrade(self)
            if sock is None:
                self._send(400, {"error": "expected Upgrade: ktpu-stream"})
                return
            try:
                _follow_log(sock, self.kubelet.runtime, cid, record.log_path if record else "")
            finally:
                _hang_up(sock)
            return

        # exec: the handshake is checked BEFORE the spawn, so a bad Upgrade
        # header cannot leak a running process
        command = rawq.get("command") or []
        if not command:
            self._send(400, {"error": "command required"})
            return
        if not wants_upgrade(self):
            self._send(400, {"error": "expected Upgrade: ktpu-stream"})
            return
        res = self.kubelet.runtime.exec_stream(cid, command, tty=q.get("tty") in ("1", "true"),
                                               stdin=q.get("stdin") in ("1", "true"))
        if res is None:
            self._send(400, {"error": "runtime does not support streaming exec "
                                      "or container is not running"})
            return
        proc, master = res
        sock = accept_upgrade(self)  # the header was checked: cannot be None
        try:
            _pump_exec(sock, proc, master)
        finally:
            _hang_up(sock)

    def do_GET(self):
        parsed = urlparse(self.path)
        parts = [p for p in parsed.path.split("/") if p]
        rawq = parse_qs(parsed.query)
        q = {k: v[0] for k, v in rawq.items()}
        kl = self.kubelet
        try:
            if parts and parts[0] not in OPEN_PATHS and not self._authorized():
                # everything that exposes workload data requires the token
                # the apiserver holds
                self._send(401, {"error": "unauthorized"})
            elif parts[:1] and parts[0] in STREAMS and len(parts) >= 3 \
                    and self.headers.get("Upgrade"):
                self._handle_stream(parts, rawq, q)
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


    def do_POST(self):
        parsed = urlparse(self.path)
        parts = [p for p in parsed.path.split("/") if p]
        try:
            if parts[:1] == ["exec"] and len(parts) >= 3:
                if not self._authorized():
                    self._send(401, {"error": "unauthorized"})
                    return
                pod, cid = self._resolve_container(parts[1], parts[2],
                                                   parts[3] if len(parts) > 3 else "")
                if pod is None:
                    return
                length = int(self.headers.get("Content-Length") or 0)
                command = (json.loads(self.rfile.read(length)) if length else {}).get("command")
                if not command:
                    self._send(400, {"error": "command required"})
                    return
                code, output = self.kubelet.runtime.exec_capture(cid, command)
                self._send(200, {"exitCode": code, "output": output})
            else:
                self._send(404, {"error": f"unknown path {parsed.path}"})
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as e:  # noqa: BLE001 - the error goes back to the caller
            try:
                self._send(500, {"error": str(e)})
            except OSError:
                pass  # client already disconnected


def _hang_up(sock):
    """End a stream: shut the connection down before closing it.  The
    handler's file objects keep the socket open past close(), and a thread
    blocked in recv on it would hold it open after: the peer (the
    apiserver's splice) would wait on a stream that sent its last frame.
    The shutdown sends the FIN and wakes that thread."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    sock.close()


def _pump_exec(sock, proc, master_fd):
    """Frame-pump a streaming exec: socket frames <-> process stdio.

    pty mode: one master fd carries both directions (tty semantics);
    pipe mode: stdout and stderr are separate channels.  Ends with a status
    frame carrying the exit code (the SPDY error-channel contract)."""

    def sock_reader():
        """Client frames -> process stdin / resize."""
        try:
            while True:
                frame = read_frame(sock)
                if frame is None:
                    break
                channel, payload = frame
                if channel == STDIN:
                    if not payload:  # EOF
                        if master_fd is None and proc.stdin:
                            proc.stdin.close()
                        break
                    try:
                        if master_fd is not None:
                            os.write(master_fd, payload)
                        elif proc.stdin:
                            proc.stdin.write(payload)
                            proc.stdin.flush()
                    except (OSError, ValueError):
                        break
                elif channel == RESIZE and master_fd is not None:
                    try:
                        dims = json.loads(payload)
                        fcntl.ioctl(master_fd, termios.TIOCSWINSZ, struct.pack(
                            "HHHH", dims.get("rows", 24), dims.get("cols", 80), 0, 0))
                    except (OSError, ValueError, KeyError, AttributeError):
                        pass
        except OSError:
            pass

    threading.Thread(target=sock_reader, daemon=True).start()
    try:
        if master_fd is not None:
            while True:
                try:
                    data = os.read(master_fd, 65536)
                except OSError:  # a pty reads EIO once the child has exited
                    break
                if not data:
                    break
                write_frame(sock, STDOUT, data)
        else:
            def drain(f, channel):
                try:
                    while True:
                        data = f.read1(65536)
                        if not data:
                            break
                        write_frame(sock, channel, data)
                except (OSError, ValueError):
                    pass

            t_err = threading.Thread(target=drain, args=(proc.stderr, STDERR), daemon=True)
            t_err.start()
            drain(proc.stdout, STDOUT)
            t_err.join(timeout=5.0)
        code = proc.wait(timeout=30)
    except Exception as e:  # noqa: BLE001 - reported on the error channel
        send_status(sock, -1, str(e))
        proc.kill()
        proc.wait()
        return
    finally:
        if master_fd is not None:
            try:
                os.close(master_fd)
            except OSError:
                pass
        for f in (proc.stdin, proc.stdout, proc.stderr):
            if f is not None:
                try:
                    f.close()
                except OSError:
                    pass
    send_status(sock, code)


def _follow_log(sock, runtime, cid, log_path):
    """attach: the log's last ATTACH_REPLAY_BYTES, then its growth until
    the container exits (then its exit code) or the client hangs up (the
    client sends nothing on attach, so a readable EOF means it is gone)."""
    if not log_path or not os.path.exists(log_path):
        send_status(sock, -1, "no log stream for container")
        return
    with open(log_path, "rb") as f:
        f.seek(max(0, f.seek(0, os.SEEK_END) - ATTACH_REPLAY_BYTES))
        while True:
            data = f.read(65536)
            if data:
                try:
                    write_frame(sock, STDOUT, data)
                except OSError:
                    return
                continue
            record = runtime.container_status(cid)
            if record is None or record.state != CONTAINER_RUNNING:
                # what the container wrote between the last read and its exit
                rest = f.read()
                try:
                    if rest:
                        write_frame(sock, STDOUT, rest)
                except OSError:
                    return
                send_status(sock, record.exit_code if record else -1)
                return
            if eventloop.wait_readable(sock, 0.25) and not sock.recv(1):
                return
            time.sleep(0.05)


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
