"""Device-plugin API: the kubelet's 4-RPC plugin protocol over unix sockets.

The port's copy of the JAX package's ``deviceplugin/api.py``, frame for
frame, so that the port's plugin serves an unchanged kubelet and the
port's client speaks to any plugin of the JAX package.  Service
DevicePlugin { GetPluginInfo; ListAndWatch (stream); AdmitPod;
InitContainer }, with plugins binding sockets at
``<plugin_dir>/<domain>/<name>.sock`` for the resource
``<domain>/<name>`` (``nvidia.com/gpu`` -> ``<dir>/nvidia.com/gpu.sock``).

Wire format, newline-delimited JSON:

  request:  {"id": N, "method": "...", "params": {...}}\\n
  response: {"id": N, "result": ...} | {"id": N, "error": "..."}\\n
  stream:   after a ListAndWatch request the connection is dedicated and
            the server pushes {"stream": N, "result": {"devices": [...]}}\\n
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

from ..utils.retry import Backoff

DEFAULT_PLUGIN_DIR = "/var/lib/ktpu/device-plugins"


def plugin_socket_path(plugin_dir: str, resource: str) -> str:
    """'nvidia.com/gpu' -> <dir>/nvidia.com/gpu.sock"""
    domain, name = resource.split("/", 1)
    return os.path.join(plugin_dir, domain, name + ".sock")


def resource_from_socket(plugin_dir: str, sock_path: str) -> Optional[str]:
    rel = os.path.relpath(sock_path, plugin_dir)
    parts = rel.split(os.sep)
    if len(parts) != 2 or not parts[1].endswith(".sock"):
        return None
    return f"{parts[0]}/{parts[1][:-5]}"


# --------------------------------------------------------------- data model


@dataclass
class DeviceSpec:
    """A device node to expose in the container."""

    host_path: str = ""
    container_path: str = ""
    permissions: str = "rw"


@dataclass
class Mount:
    host_path: str = ""
    container_path: str = ""
    read_only: bool = False


@dataclass
class ContainerSpec:
    """InitContainer's answer: what to inject into the container (envs is
    where ``CUDA_VISIBLE_DEVICES`` goes)."""

    envs: Dict[str, str] = field(default_factory=dict)
    mounts: List[Mount] = field(default_factory=list)
    devices: List[DeviceSpec] = field(default_factory=list)
    annotations: Dict[str, str] = field(default_factory=dict)

    def to_dict(self):
        return {
            "envs": self.envs,
            "mounts": [vars(m) for m in self.mounts],
            "devices": [vars(d) for d in self.devices],
            "annotations": self.annotations,
        }

    @staticmethod
    def from_dict(d):
        return ContainerSpec(
            envs=d.get("envs") or {},
            mounts=[Mount(**m) for m in d.get("mounts") or []],
            devices=[DeviceSpec(**x) for x in d.get("devices") or []],
            annotations=d.get("annotations") or {},
        )


# ------------------------------------------------------------------- server


class PluginServer:
    """Serves the 4-RPC plugin API for a plugin implementation.

    The implementation object provides:
      get_plugin_info() -> dict
      list_devices() -> [device dicts]          (initial ListAndWatch frame)
      watch_devices(send: Callable[[list], None], stop: Event)  (optional:
          sends the initial frame, then an update on every change; without
          it the server sends list_devices() once)
      admit_pod(params) -> dict
      init_container(params) -> ContainerSpec
    """

    def __init__(self, impl, socket_path: str):
        self.impl = impl
        self.socket_path = socket_path
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        os.makedirs(os.path.dirname(socket_path), exist_ok=True)
        if os.path.exists(socket_path):
            os.unlink(socket_path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(socket_path)
        self._sock.listen(16)

    def start(self):
        th = threading.Thread(target=self._accept_loop, daemon=True)
        th.start()
        self._threads.append(th)
        return self

    def stop(self):
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        if os.path.exists(self.socket_path):
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            th = threading.Thread(target=self._serve_conn, args=(conn,), daemon=True)
            th.start()

    def _serve_conn(self, conn: socket.socket):
        f = conn.makefile("rwb")
        try:
            for line in f:
                try:
                    req = json.loads(line)
                except json.JSONDecodeError:
                    break
                method, rid, params = req.get("method"), req.get("id"), req.get("params") or {}
                if method == "ListAndWatch":
                    self._serve_stream(f, rid)
                    return  # dedicated connection consumed
                try:
                    result = self._dispatch(method, params)
                    f.write(json.dumps({"id": rid, "result": result}).encode() + b"\n")
                except Exception as e:  # noqa: BLE001 - the error goes back to the caller
                    traceback.print_exc()
                    f.write(json.dumps({"id": rid, "error": str(e)}).encode() + b"\n")
                f.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, method: str, params: dict):
        if method == "GetPluginInfo":
            return self.impl.get_plugin_info()
        if method == "AdmitPod":
            return self.impl.admit_pod(params)
        if method == "InitContainer":
            spec = self.impl.init_container(params)
            return spec.to_dict() if isinstance(spec, ContainerSpec) else spec
        raise ValueError(f"unknown method {method!r}")

    def _serve_stream(self, f, rid):
        send_lock = threading.Lock()

        def send(devices: List[dict]):
            with send_lock:
                f.write(
                    json.dumps({"stream": rid, "result": {"devices": devices}}).encode()
                    + b"\n"
                )
                f.flush()

        try:
            watch = getattr(self.impl, "watch_devices", None)
            if watch is not None:
                # it sends the first frame itself, from a snapshot taken
                # as it subscribes: a health flip between the two would
                # otherwise wake no one
                watch(send, self._stop)
            else:
                send(self.impl.list_devices())
                self._stop.wait()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass


# ------------------------------------------------------------------- client


class PluginClient:
    """Kubelet-side connection to one plugin socket."""

    def __init__(self, socket_path: str, timeout: float = 10.0):
        self.socket_path = socket_path
        self.timeout = timeout
        self._lock = threading.Lock()
        self._conn: Optional[socket.socket] = None
        self._f = None
        self._next_id = 0

    def _connect(self, retry_window: float = 3.0):
        # the socket file appears at bind(), a beat before listen(): retry
        # a refused dial for a short window
        deadline = time.monotonic() + retry_window
        backoff = Backoff(base=0.02, factor=2.0, cap=0.1)
        while True:
            conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            conn.settimeout(self.timeout)
            try:
                conn.connect(self.socket_path)
                return conn
            except (ConnectionRefusedError, FileNotFoundError):
                conn.close()
                if time.monotonic() >= deadline:
                    raise
                backoff.sleep()

    def _ensure(self):
        if self._conn is None:
            self._conn = self._connect()
            self._f = self._conn.makefile("rwb")

    def call(self, method: str, params: Optional[dict] = None):
        with self._lock:  # one request and its response at a time on the socket
            self._ensure()
            self._next_id += 1
            rid = self._next_id
            frame = json.dumps({"id": rid, "method": method, "params": params or {}})
            try:
                self._f.write(frame.encode() + b"\n")
                self._f.flush()
                line = self._f.readline()
            except (BrokenPipeError, ConnectionResetError, OSError):
                self.close()
                raise ConnectionError(f"plugin {self.socket_path} unreachable")
            if not line:
                self.close()
                raise ConnectionError(f"plugin {self.socket_path} closed connection")
            resp = json.loads(line)
            if resp.get("error"):
                raise RuntimeError(f"plugin error from {method}: {resp['error']}")
            return resp.get("result")

    def list_and_watch(self) -> Iterator[List[dict]]:
        """Dedicated streaming connection yielding device lists."""
        conn = self._connect()
        conn.settimeout(None)  # the stream blocks until the plugin pushes
        f = conn.makefile("rwb")
        f.write(json.dumps({"id": 0, "method": "ListAndWatch", "params": {}}).encode() + b"\n")
        f.flush()

        def gen():
            try:
                for line in f:
                    frame = json.loads(line)
                    yield (frame.get("result") or {}).get("devices") or []
            except (ConnectionResetError, OSError, ValueError):
                return
            finally:
                try:
                    conn.close()
                except OSError:
                    pass

        return gen()

    def close(self):
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
            self._conn = None
            self._f = None
