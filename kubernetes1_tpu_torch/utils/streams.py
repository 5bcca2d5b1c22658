"""Bidirectional streaming over an upgraded HTTP connection: the port's
copy of the JAX package's ``utils/streams.py``, byte for byte on the wire.

Ref: the reference streams exec/attach/port-forward over SPDY channels
(pkg/kubelet/server/remotecommand, client-go/tools/remotecommand) or
WebSocket.  The wire form here is a minimal channel-framed protocol over
a hijacked socket:

    client:  GET/POST <path> HTTP/1.1
             Connection: Upgrade
             Upgrade: ktpu-stream
    server:  HTTP/1.1 101 Switching Protocols  (then raw frames both ways)

frame  = channel(1 byte) | length(4 bytes big-endian) | payload
channels mirror SPDY's: 0 stdin, 1 stdout, 2 stderr, 3 error/status,
4 resize.  A zero-length frame on a stream channel means EOF for that
channel.  The error channel carries one UTF-8 JSON object
{"exitCode": N, "error": "..."} and closes the stream.

``upgrade_request`` dials TLS when given an ``ssl_context`` (the CLI to
an https apiserver, the apiserver to an https kubelet).  Not here (ROADMAP
item 18): the JAX copy's ``stream.upgrade`` fault seam, its ``proto=``
knob and ``quiet_connection_errors``, which no caller of the port uses.
"""

from __future__ import annotations

import json
import re
import socket
import struct
import threading
from typing import Optional, Tuple

UPGRADE_PROTO = "ktpu-stream"

STDIN, STDOUT, STDERR, ERROR, RESIZE = 0, 1, 2, 3, 4

_HEADER = struct.Struct(">BI")
MAX_FRAME = 1 << 20


def write_frame(sock: socket.socket, channel: int, payload: bytes):
    sock.sendall(_HEADER.pack(channel, len(payload)) + payload)


def read_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def read_frame(sock: socket.socket) -> Optional[Tuple[int, bytes]]:
    """(channel, payload) or None on EOF/garbage."""
    header = read_exact(sock, _HEADER.size)
    if header is None:
        return None
    channel, length = _HEADER.unpack(header)
    if length > MAX_FRAME:
        return None
    if length == 0:
        return channel, b""
    payload = read_exact(sock, length)
    if payload is None:
        return None
    return channel, payload


def send_status(sock: socket.socket, exit_code: int, error: str = ""):
    try:
        write_frame(sock, ERROR, json.dumps(
            {"exitCode": exit_code, "error": error}).encode())
    except OSError:
        pass


class UpgradeRefused(ConnectionError):
    """The server answered the Upgrade handshake with a real HTTP status
    instead of 101 — it is alive but does not serve this stream (a 404,
    a 400).  `status` carries the code (0 when the head was unparseable)."""

    def __init__(self, message: str, status: int = 0):
        super().__init__(message)
        self.status = status


def upgrade_request(host: str, port: int, path: str, headers: dict,
                    timeout: float = 30.0, ssl_context=None) -> socket.socket:
    """Open a socket (TLS when ``ssl_context`` is given), perform the
    Upgrade handshake, return the socket ready for frames.  Raises
    UpgradeRefused (a ConnectionError) on a non-101 response."""
    sock = socket.create_connection((host, port), timeout=timeout)
    try:
        if ssl_context is not None:
            sock = ssl_context.wrap_socket(sock, server_hostname=host)
        lines = [f"GET {path} HTTP/1.1", f"Host: {host}:{port}",
                 "Connection: Upgrade", f"Upgrade: {UPGRADE_PROTO}"]
        for k, v in headers.items():
            lines.append(f"{k}: {v}")
        sock.sendall(("\r\n".join(lines) + "\r\n\r\n").encode())
        head = _read_http_head(sock)
        first = head.split("\r\n", 1)[0] if head else "EOF"
        if " 101 " not in first + " ":
            body = _read_error_body(sock, head)
            try:
                code = int(first.split(" ", 2)[1])
            except (IndexError, ValueError):
                code = 0
            raise UpgradeRefused(
                f"upgrade refused: {first}" + (f" — {body}" if body else ""),
                status=code)
        sock.settimeout(None)
        return sock
    except BaseException:
        sock.close()
        raise


def _read_http_head(sock: socket.socket) -> str:
    """Read the HTTP response head up to its blank line, and not a byte
    more: the frames a server sends right after its 101 may already have
    arrived, and they belong to the stream.  (The JAX copy reads 4 KiB at
    a time and drops what follows the head: a command that ends at once
    can lose its status frame there.)  One byte a call: a TLS socket takes
    no MSG_PEEK, and the bytes after the head stay in its record buffer,
    or the kernel's, for the stream's first read."""
    data = bytearray()
    while not data.endswith(b"\r\n\r\n") and len(data) <= 65536:
        byte = sock.recv(1)
        if not byte:
            break
        data += byte
    return data.decode(errors="replace")


def _read_error_body(sock: socket.socket, head: str) -> str:
    """The first 300 characters of a refusal's body (its Content-Length
    bytes, read with the handshake's timeout)."""
    m = re.search(r"^content-length:\s*(\d+)", head, re.I | re.M)
    if not m:
        return ""
    try:
        raw = read_exact(sock, min(int(m.group(1)), 65536)) or b""
    except OSError:
        return ""
    return raw.decode(errors="replace")[:300]


def wants_upgrade(handler) -> bool:
    """Whether a BaseHTTPRequestHandler's request asks for this stream."""
    return handler.headers.get("Upgrade", "").lower() == UPGRADE_PROTO


def accept_upgrade(handler) -> Optional[socket.socket]:
    """Server side: validate the Upgrade header on a BaseHTTPRequestHandler,
    send 101, and return the hijacked socket (caller owns it afterwards)."""
    if not wants_upgrade(handler):
        return None
    handler.send_response(101, "Switching Protocols")
    handler.send_header("Upgrade", UPGRADE_PROTO)
    handler.send_header("Connection", "Upgrade")
    handler.end_headers()
    handler.wfile.flush()
    sock = handler.connection
    handler.close_connection = True
    return sock


def splice(a: socket.socket, b: socket.socket):
    """Raw byte relay both directions until either side closes — the
    apiserver's proxy hop (it terminates the handshake on each side and
    then has no need to reframe)."""

    def pump(src, dst):
        try:
            while True:
                data = src.recv(65536)
                if not data:
                    break
                dst.sendall(data)
        except OSError:
            pass
        finally:
            for s in (src, dst):
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

    t = threading.Thread(target=pump, args=(b, a), daemon=True)
    t.start()
    pump(a, b)
    t.join(timeout=5.0)
