"""Service VIP data plane: the userspace kube-proxy (ref: pkg/proxy/
userspace/proxier.go).

The port's copy of the JAX package's ``proxy/proxier.py``.  Every port of
a Service gets a real listening socket, and each accepted connection is
spliced to a backend picked round-robin, or by ClientIP affinity when the
Service asks for it.  A NodePort Service listens on its node port (the
socket is bound again when the node port changes).  The Service and
Endpoints informers (typed, ``Clientset.informers()``) feed a
rate-limited work queue, and one worker reconciles each Service's
sockets.  ClusterIP routing is ``resolve()`` / ``connect()``: the node
cannot own 10.96/16, so an in-cluster client routes a VIP through this
table as netfilter would.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..api import types as t
from ..client.clientset import Clientset
from ..client.informer import InformerFactory
from ..utils.workqueue import RateLimitingQueue


class _PortProxy:
    """One listening socket forwarding to a mutable backend set."""

    def __init__(self, listen_host: str, listen_port: int):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((listen_host, listen_port))
        self.sock.listen(64)
        self.port = self.sock.getsockname()[1]
        self.backends: List[Tuple[str, int]] = []
        self.affinity: Optional[str] = None  # None | "ClientIP"
        self.affinity_ttl = 10800.0
        self._affinity_map: Dict[str, Tuple[Tuple[str, int], float]] = {}
        self._rr = 0
        self._lock = threading.Lock()
        self._closed = False
        self.connections = 0
        self.errors = 0
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def set_backends(self, backends: List[Tuple[str, int]]):
        with self._lock:
            self.backends = list(backends)

    def _pick(self, client_ip: str) -> Optional[Tuple[str, int]]:
        with self._lock:
            if not self.backends:
                return None
            if self.affinity == "ClientIP":
                hit = self._affinity_map.get(client_ip)
                if hit and time.monotonic() - hit[1] < self.affinity_ttl \
                        and hit[0] in self.backends:
                    self._affinity_map[client_ip] = (hit[0], time.monotonic())
                    return hit[0]
            be = self.backends[self._rr % len(self.backends)]
            self._rr += 1
            if self.affinity == "ClientIP":
                self._affinity_map[client_ip] = (be, time.monotonic())
            return be

    def _accept_loop(self):
        while not self._closed:
            try:
                client, addr = self.sock.accept()
            except OSError:
                return
            threading.Thread(
                target=self._handle, args=(client, addr[0]), daemon=True
            ).start()

    def _handle(self, client: socket.socket, client_ip: str):
        be = self._pick(client_ip)
        if be is None:
            self.errors += 1
            client.close()
            return
        try:
            upstream = socket.create_connection(be, timeout=10)
        except OSError:
            self.errors += 1
            client.close()
            return
        self.connections += 1
        for a, b in ((client, upstream), (upstream, client)):
            threading.Thread(target=self._splice, args=(a, b), daemon=True).start()

    @staticmethod
    def _splice(src: socket.socket, dst: socket.socket):
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
                try:
                    s.close()
                except OSError:
                    pass

    def close(self):
        self._closed = True
        try:
            # wakes the accept loop: a bare close() leaves the socket
            # listening until a blocked accept() returns
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class Proxier:
    """Per-node service proxy: one _PortProxy per (service, port)."""

    def __init__(
        self,
        clientset: Clientset,
        factory: Optional[InformerFactory] = None,
        listen_host: str = "127.0.0.1",
    ):
        self.cs = clientset
        self.factory = factory or clientset.informers()
        self.listen_host = listen_host
        self.queue = RateLimitingQueue()
        # (ns, svc_name, port_name) -> _PortProxy
        self._proxies: Dict[Tuple[str, str, str], _PortProxy] = {}
        # (cluster_ip, service_port) -> local (host, port); the VIP table
        self._vips: Dict[Tuple[str, int], Tuple[str, int]] = {}
        # (ns, svc_name) -> vip keys owned by that service, for pruning
        self._svc_vips: Dict[Tuple[str, str], set] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._own_factory = factory is None

    def start(self):
        self.services = self.factory.informer("services")
        self.endpoints = self.factory.informer("endpoints")
        self.services.add_handler(
            on_add=self._enqueue, on_update=lambda _o, n: self._enqueue(n),
            on_delete=self._enqueue,
        )
        self.endpoints.add_handler(
            on_add=self._enqueue, on_update=lambda _o, n: self._enqueue(n),
            on_delete=self._enqueue,
        )
        if self._own_factory:
            self.factory.start_all()
            self.factory.wait_for_sync()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        return self

    def _enqueue(self, obj):
        self.queue.add(f"{obj.metadata.namespace}/{obj.metadata.name}")

    def _worker(self):
        while not self._stop.is_set():
            key = self.queue.get(timeout=0.5)
            if key is None:
                continue
            try:
                self._sync(key)
                self.queue.forget(key)
            except Exception:  # noqa: BLE001
                self.queue.add_rate_limited(key)
            finally:
                self.queue.done(key)

    def _sync(self, key: str):
        svc = self.services.get(key)
        ns, name = key.split("/", 1)
        if svc is None or svc.spec.cluster_ip == "None":
            self._remove_service(ns, name)
            return
        eps = self.endpoints.get(key)
        bind_error: Optional[OSError] = None
        new_vips = set()
        for sp in svc.spec.ports:
            pkey = (ns, name, sp.name)
            backends = self._backends_for(eps, sp)
            with self._lock:
                proxy = self._proxies.get(pkey)
                want_port = sp.node_port if svc.spec.type == "NodePort" else 0
                if proxy is not None and want_port and proxy.port != want_port:
                    self._proxies.pop(pkey).close()  # nodePort changed: rebind
                    proxy = None
                if proxy is None:
                    try:
                        proxy = _PortProxy(self.listen_host, want_port)
                    except OSError as e:
                        bind_error = e  # raise after the loop -> rate-limited retry
                        continue
                    self._proxies[pkey] = proxy
                proxy.affinity = svc.spec.session_affinity or None
                proxy.set_backends(backends)
                if svc.spec.cluster_ip:
                    vkey = (svc.spec.cluster_ip, sp.port)
                    self._vips[vkey] = (self.listen_host, proxy.port)
                    new_vips.add(vkey)
        with self._lock:
            # drop ports removed from the spec + VIP entries no longer valid
            live = {(ns, name, sp.name) for sp in svc.spec.ports}
            for pkey in [
                k for k in self._proxies if k[:2] == (ns, name) and k not in live
            ]:
                self._proxies.pop(pkey).close()
            for vkey in self._svc_vips.get((ns, name), set()) - new_vips:
                self._vips.pop(vkey, None)
            self._svc_vips[(ns, name)] = new_vips
        if bind_error is not None:
            raise bind_error

    def _backends_for(self, eps: Optional[t.Endpoints], sp) -> List[Tuple[str, int]]:
        if eps is None:
            return []
        out = []
        for subset in eps.subsets:
            port = None
            for ep in subset.ports:
                if ep.name == sp.name or (not ep.name and not sp.name):
                    port = ep.port
                    break
            if port is None and len(subset.ports) == 1:
                port = subset.ports[0].port
            if port is None:
                continue
            for addr in subset.addresses:
                out.append((addr.ip, port))
        return out

    def _remove_service(self, ns: str, name: str):
        with self._lock:
            for pkey in [k for k in self._proxies if k[:2] == (ns, name)]:
                self._proxies.pop(pkey).close()
            for vkey in self._svc_vips.pop((ns, name), set()):
                self._vips.pop(vkey, None)

    # ------------------------------------------------------------ client API

    def resolve(self, cluster_ip: str, port: int) -> Optional[Tuple[str, int]]:
        """VIP -> actual (host, port), as netfilter DNAT would."""
        with self._lock:
            return self._vips.get((cluster_ip, port))

    def connect(self, cluster_ip: str, port: int, timeout: float = 10) -> socket.socket:
        target = self.resolve(cluster_ip, port)
        if target is None:
            raise ConnectionRefusedError(f"no proxy for {cluster_ip}:{port}")
        return socket.create_connection(target, timeout=timeout)

    def node_port_for(self, ns: str, name: str, port_name: str = "") -> Optional[int]:
        with self._lock:
            p = self._proxies.get((ns, name, port_name))
            return p.port if p else None

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "services": len({k[:2] for k in self._proxies}),
                "ports": len(self._proxies),
                "connections": sum(p.connections for p in self._proxies.values()),
                "errors": sum(p.errors for p in self._proxies.values()),
            }

    def stop(self):
        self._stop.set()
        self.queue.shut_down()
        if self._own_factory:
            self.factory.stop_all()
        with self._lock:
            for p in self._proxies.values():
                p.close()
            self._proxies.clear()
            self._vips.clear()
            self._svc_vips.clear()
