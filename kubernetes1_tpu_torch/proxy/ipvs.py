"""IPVS-mode service proxier (ref: pkg/proxy/ipvs/proxier.go).

The port's copy of the JAX package's ``proxy/ipvs.py``.  What sets it
apart from the rule table is the data path:

- virtual servers with per-backend state (weight, active and total
  connections) in place of stateless probability rules;
- the schedulers of kube-proxy's ``--ipvs-scheduler``: ``rr``, ``wrr``
  (weighted), ``lc`` (least connections), ``sh`` (source hash);
- graceful termination: a backend removed from the Endpoints is weighted
  to 0 (it drains: open connections flow on, new ones avoid it) and is
  deleted once its last connection ends;
- ``dump()`` renders an ``ipvsadm -ln`` listing.

A virtual server is a real listening socket, so ``lc``'s connection
counts are real.
"""

from __future__ import annotations

import hashlib
import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..api import types as t
from ..client.clientset import Clientset
from ..client.informer import InformerFactory

SCHEDULERS = ("rr", "wrr", "lc", "sh")


class RealServer:
    """One backend of a virtual server (ipvs 'real server')."""

    __slots__ = ("addr", "weight", "active_conns", "total_conns")

    def __init__(self, addr: Tuple[str, int], weight: int = 1):
        self.addr = addr
        self.weight = weight
        self.active_conns = 0
        self.total_conns = 0


def _schedule(algo: str, backends: List[RealServer], client_ip: str,
              rr_state: List[int]) -> Optional[RealServer]:
    """Pick a backend.  Weight-0 backends (draining) are never picked."""
    eligible = [b for b in backends if b.weight > 0]
    if not eligible:
        return None
    if algo == "rr":
        rr_state[0] = (rr_state[0] + 1) % len(eligible)
        return eligible[rr_state[0]]
    if algo == "wrr":
        # expand by weight over a repeating cycle
        cycle = sum(b.weight for b in eligible)
        rr_state[0] = (rr_state[0] + 1) % cycle
        at = rr_state[0]
        for b in eligible:
            if at < b.weight:
                return b
            at -= b.weight
        return eligible[0]
    if algo == "lc":
        return min(eligible, key=lambda b: (b.active_conns, b.addr))
    if algo == "sh":
        h = int.from_bytes(
            hashlib.blake2s(client_ip.encode(), digest_size=4).digest(), "big")
        return eligible[h % len(eligible)]
    raise ValueError(f"unknown ipvs scheduler {algo!r}")


class VirtualServer:
    """A listening socket + scheduled real-server set (ipvs virtual svc)."""

    def __init__(self, listen_host: str, listen_port: int, algo: str):
        self.algo = algo
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((listen_host, listen_port))
        self.sock.listen(64)
        self.port = self.sock.getsockname()[1]
        self.backends: List[RealServer] = []
        self._rr_state = [0]
        self._lock = threading.Lock()
        self._closed = False
        threading.Thread(target=self._accept_loop, daemon=True).start()

    # ------------------------------------------------------------ backends

    def set_backends(self, addrs: List[Tuple[str, int]],
                     weights: Optional[Dict[Tuple[str, int], int]] = None):
        """Reconcile the real-server set.  Backends no longer in `addrs`
        are weighted to 0 and kept while they still carry connections
        (graceful termination); fully-drained ones are dropped."""
        weights = weights or {}
        with self._lock:
            have = {b.addr: b for b in self.backends}
            want = set(addrs)
            for addr in want:  # set: the same ip:port listed twice in the
                # endpoints must not become two real servers (double share)
                if addr in have:
                    have[addr].weight = weights.get(addr, 1)
                else:
                    b = RealServer(addr, weights.get(addr, 1))
                    self.backends.append(b)
                    have[addr] = b
            for b in self.backends:
                if b.addr not in want:
                    b.weight = 0  # drain
            self.backends = [
                b for b in self.backends
                if b.addr in want or b.active_conns > 0
            ]

    def pick(self, client_ip: str) -> Optional[RealServer]:
        with self._lock:
            return _schedule(self.algo, self.backends, client_ip,
                             self._rr_state)

    # ----------------------------------------------------------- data path

    def _accept_loop(self):
        while not self._closed:
            try:
                client, peer = self.sock.accept()
            except OSError:
                return
            threading.Thread(target=self._splice, args=(client, peer[0]),
                             daemon=True).start()

    def _splice(self, client: socket.socket, client_ip: str):
        backend = self.pick(client_ip)
        if backend is None:
            client.close()
            return
        try:
            upstream = socket.create_connection(backend.addr, timeout=10)
        except OSError:
            client.close()
            return
        with self._lock:
            backend.active_conns += 1
            backend.total_conns += 1
        upload_done = threading.Event()

        def pump(src, dst, done: Optional[threading.Event] = None):
            # half-close splice: EOF from src propagates as SHUT_WR on dst
            # only — shutting down both directions here would cut off the
            # response still flowing the other way
            try:
                while True:
                    data = src.recv(65536)
                    if not data:
                        break
                    dst.sendall(data)
            except OSError:
                pass
            finally:
                if done is not None:
                    done.set()
                try:
                    dst.shutdown(socket.SHUT_WR)
                except OSError:
                    pass

        threading.Thread(target=pump, args=(client, upstream, upload_done),
                         daemon=True).start()
        pump(upstream, client)
        # grace for the client->upstream direction: set ONLY by its own
        # pump, so an early backend half-close doesn't truncate an upload
        upload_done.wait(1.0)
        client.close()
        upstream.close()
        with self._lock:
            backend.active_conns -= 1
            # a drained backend disappears once its last connection ends
            self.backends = [
                b for b in self.backends
                if b.weight > 0 or b.active_conns > 0
            ]

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


class IPVSProxier:
    """Service proxy in ipvs mode (kube-proxy --proxy-mode=ipvs analog):
    one VirtualServer per service port, scheduler per --ipvs-scheduler."""

    def __init__(self, clientset: Clientset,
                 factory: Optional[InformerFactory] = None,
                 scheduler: str = "rr", listen_host: str = "127.0.0.1"):
        if scheduler not in SCHEDULERS:
            raise ValueError(
                f"unknown ipvs scheduler {scheduler!r} (have {SCHEDULERS})")
        self.cs = clientset
        self.factory = factory or clientset.informers()
        self.scheduler = scheduler
        self.listen_host = listen_host
        self.services = self.factory.informer("services")
        self.endpoints = self.factory.informer("endpoints")
        # (ns, svc, port_name) -> VirtualServer
        self._virtuals: Dict[tuple, VirtualServer] = {}
        self._vip_index: Dict[tuple, tuple] = {}  # (clusterIP, port) -> key
        self._lock = threading.Lock()
        self._dirty = threading.Event()
        self._stop = threading.Event()

    # ------------------------------------------------------------ lifecycle

    def start(self):
        for inf in (self.services, self.endpoints):
            inf.add_handler(on_add=lambda *_: self._dirty.set(),
                            on_update=lambda *_: self._dirty.set(),
                            on_delete=lambda *_: self._dirty.set())
        self.factory.start_all()
        self.factory.wait_for_sync()
        self._sync()
        threading.Thread(target=self._loop, daemon=True,
                         name="ipvs-sync").start()
        return self

    def stop(self):
        self._stop.set()
        self._dirty.set()
        with self._lock:
            for vs in self._virtuals.values():
                vs.close()
            self._virtuals.clear()
            self._vip_index.clear()
        self.factory.stop_all()

    def _loop(self):
        while not self._stop.is_set():
            self._dirty.wait(1.0)
            if self._stop.is_set():
                return
            if self._dirty.is_set():
                self._dirty.clear()
                try:
                    self._sync()
                except Exception:  # noqa: BLE001
                    import traceback

                    traceback.print_exc()

    # ----------------------------------------------------------------- sync

    @staticmethod
    def _subset_backends(ep, port_name: str):
        out = []
        for subset in ep.subsets:
            port = None
            for p in subset.ports:
                if not port_name or p.name == port_name:
                    port = p.port
                    break
            if port is None and subset.ports:
                # single-unnamed-port fallback, matching rules.py /
                # proxier.py: a named service port still routes to a
                # subset whose lone port carries no name
                port = subset.ports[0].port
            if port is None:
                continue
            out.extend((a.ip, port) for a in subset.addresses)
        return out

    def _sync(self):
        # one pass over the endpoints informer: per-port lookups below are
        # O(1), not a rescan of every Endpoints object (O(svc x eps) sync
        # would also stall resolve() behind the lock on big clusters)
        eps_by_key = {(ep.metadata.namespace, ep.metadata.name): ep
                      for ep in self.endpoints.list()}
        wanted = {}
        for svc in self.services.list():
            if not svc.spec.cluster_ip or svc.spec.cluster_ip == "None":
                continue
            for port in svc.spec.ports:
                key = (svc.metadata.namespace, svc.metadata.name, port.name)
                wanted[key] = (svc, port)
        with self._lock:
            for key in [k for k in self._virtuals if k not in wanted]:
                self._virtuals.pop(key).close()
            self._vip_index = {}
            for key, (svc, port) in wanted.items():
                vs = self._virtuals.get(key)
                if vs is None:
                    vs = VirtualServer(self.listen_host, 0, self.scheduler)
                    self._virtuals[key] = vs
                ep = eps_by_key.get(key[:2])
                vs.set_backends(
                    self._subset_backends(ep, key[2]) if ep else [])
                self._vip_index[(svc.spec.cluster_ip, port.port)] = key

    # ------------------------------------------------------------- routing

    def resolve(self, ip: str, port: int) -> Optional[Tuple[str, int]]:
        """ClusterIP:port -> local virtual-server address."""
        with self._lock:
            key = self._vip_index.get((ip, port))
            if key is None:
                return None
            return (self.listen_host, self._virtuals[key].port)

    def virtual_for(self, ns: str, name: str,
                    port_name: str = "") -> Optional[VirtualServer]:
        with self._lock:
            return self._virtuals.get((ns, name, port_name))

    def dump(self) -> str:
        """`ipvsadm -ln` style listing."""
        lines = ["IP Virtual Server (ktpu ipvs-mode analog)",
                 "Prot LocalAddress:Port Scheduler Flags",
                 "  -> RemoteAddress:Port  Weight ActiveConn TotalConn"]
        with self._lock:
            for (vip, port), key in sorted(self._vip_index.items()):
                vs = self._virtuals[key]
                lines.append(f"TCP  {vip}:{port} {vs.algo}")
                for b in vs.backends:
                    lines.append(
                        f"  -> {b.addr[0]}:{b.addr[1]}  "
                        f"{b.weight} {b.active_conns} {b.total_conns}")
        return "\n".join(lines) + "\n"
