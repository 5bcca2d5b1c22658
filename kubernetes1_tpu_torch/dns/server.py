"""Cluster DNS: `<svc>.<ns>.svc.cluster.local` A records from informers.

Ref: cluster/addons/dns/kube-dns.yaml.base + the kubelet's --cluster-dns
wiring (pods' resolv.conf points at the cluster resolver).  The reference
ships kube-dns/CoreDNS as a cluster addon; here the resolver is NODE-LOCAL
(the NodeLocal DNSCache shape): each kubelet hosts one, fed by the same
service/endpoints informers the proxy uses, and wires pods to it via a
bind-mounted resolv.conf + a KTPU_DNS_SERVER env var.  `*_SERVICE_HOST`
env is snapshot-at-start, DNS answers live: a service created AFTER a pod
started resolves on the next query.  The port's copy of the JAX package's
``dns/server.py``.

The wire protocol is hand-rolled RFC 1035 (headers, QNAME labels, A
answers with compression pointers) — a DNS library would be a dependency
for ~120 lines.  Non-cluster names forward to the host's upstream
resolver so pods keep resolving the outside world.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import List, Optional, Tuple

from ..utils.logutil import RateLimitedReporter

DEFAULT_DNS_IP = "127.0.51.1"   # loopback alias, systemd-resolved style
CLUSTER_DOMAIN = "cluster.local"

_FLAG_RESPONSE = 0x8180         # QR | RD | RA
_RCODE_NXDOMAIN = 3
_RCODE_SERVFAIL = 2


# ------------------------------------------------------------- wire format

def _encode_name(name: str) -> bytes:
    out = b""
    for label in name.rstrip(".").split("."):
        raw = label.encode()
        out += bytes([len(raw)]) + raw
    return out + b"\x00"


def _decode_name(data: bytes, off: int) -> Tuple[str, int]:
    """Returns (name, next_offset); follows compression pointers."""
    labels = []
    jumped = False
    end = off
    hops = 0
    while True:
        if off >= len(data):
            raise ValueError("truncated name")
        length = data[off]
        if length & 0xC0 == 0xC0:  # pointer
            if off + 1 >= len(data):
                raise ValueError("truncated pointer")
            ptr = struct.unpack("!H", data[off:off + 2])[0] & 0x3FFF
            if not jumped:
                end = off + 2
            off = ptr
            jumped = True
            hops += 1
            if hops > 16:
                raise ValueError("pointer loop")
            continue
        if length == 0:
            if not jumped:
                end = off + 1
            return ".".join(labels), end
        off += 1
        labels.append(data[off:off + length].decode(errors="replace"))
        off += length


def encode_query(name: str, qtype: int = 1, qid: int = 0x1234) -> bytes:
    """Client-side helper (tests + in-framework lookups)."""
    header = struct.pack("!HHHHHH", qid, 0x0100, 1, 0, 0, 0)
    return header + _encode_name(name) + struct.pack("!HH", qtype, 1)


def parse_response(data: bytes) -> Tuple[int, List[str]]:
    """(rcode, [A record IPs]) from a response packet."""
    (qid, flags, qd, an, ns, ar) = struct.unpack("!HHHHHH", data[:12])
    rcode = flags & 0xF
    off = 12
    for _ in range(qd):
        _, off = _decode_name(data, off)
        off += 4
    ips = []
    for _ in range(an):
        _, off = _decode_name(data, off)
        rtype, rclass, ttl, rdlen = struct.unpack("!HHIH", data[off:off + 10])
        off += 10
        if rtype == 1 and rdlen == 4:
            ips.append(socket.inet_ntoa(data[off:off + 4]))
        off += rdlen
    return rcode, ips


def _build_response(qid: int, question: bytes, rcode: int,
                    ips: List[str]) -> bytes:
    flags = _FLAG_RESPONSE | (rcode & 0xF)
    header = struct.pack("!HHHHHH", qid, flags, 1, len(ips), 0, 0)
    answers = b""
    for ip in ips:
        answers += (b"\xc0\x0c"                # pointer to QNAME at offset 12
                    + struct.pack("!HHIH", 1, 1, 5, 4)
                    + socket.inet_aton(ip))
    return header + question + answers


# ------------------------------------------------------------------ server

class ClusterDNS:
    """Node-local cluster resolver over the service/endpoints informers."""

    cluster_domain = CLUSTER_DOMAIN

    def __init__(self, clientset, bind_ip: str = DEFAULT_DNS_IP,
                 port: int = 53, upstream: Optional[str] = None):
        self._suffix = tuple(self.cluster_domain.split("."))
        self.services = clientset.informer("services")
        self.endpoints = clientset.informer("endpoints")
        self._upstream = upstream if upstream is not None \
            else self._host_upstream(bind_ip)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((bind_ip, port))  # raises: caller decides fallback
        self.ip, self.port = self._sock.getsockname()[:2]
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # at most 16 in-flight upstream forwards (each may block up to the
        # 2s upstream timeout); beyond that, _answer SERVFAILs immediately
        self._forward_slots = threading.Semaphore(16)
        self._drop_reporter = RateLimitedReporter("dns")

    @staticmethod
    def _host_upstream(self_ip: str) -> str:
        """First host nameserver that isn't us (resolv.conf chain-out)."""
        try:
            with open("/etc/resolv.conf") as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 2 and parts[0] == "nameserver" \
                            and parts[1] != self_ip:
                        return parts[1]
        except OSError:
            pass
        return ""

    def start(self) -> "ClusterDNS":
        self.services.start()
        self.endpoints.start()
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="cluster-dns")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self.services.stop()
        self.endpoints.stop()

    def resolv_conf(self, namespace: str) -> str:
        """The pod's resolv.conf (ref kubelet's --cluster-dns +
        --cluster-domain wiring): search path makes bare `redis-master`
        resolve within the pod's own namespace first."""
        d = self.cluster_domain
        return (f"nameserver {self.ip}\n"
                f"search {namespace}.svc.{d} svc.{d} {d}\n"
                f"options ndots:5\n")

    # ------------------------------------------------------------ resolution

    def resolve(self, name: str) -> Optional[List[str]]:
        """IPs for a cluster name, or None when the name is not ours.
        Accepted shapes: svc.ns | svc.ns.svc | svc.ns.svc.<domain>.
        Only the suffixed forms are AUTHORITATIVE (NXDOMAIN on miss); a
        bare two-label name that matches no service is None — it could be
        a real domain (example.com) and must forward upstream, exactly
        like kube-dns owning only cluster.local."""
        labels = tuple(name.rstrip(".").lower().split("."))
        authoritative = False
        if labels[-len(self._suffix):] == self._suffix:
            labels = labels[:-len(self._suffix)]
            authoritative = True
        if len(labels) == 3 and labels[2] == "svc":
            labels = labels[:2]
            authoritative = True
        if len(labels) != 2:
            # inside our zone with a shape we don't serve -> NXDOMAIN;
            # forwarding would leak every search-path expansion of every
            # external lookup (example.com.default.svc.cluster.local)
            # to the upstream resolver
            return [] if authoritative else None
        svc_name, ns = labels
        svc = self.services.get(f"{ns}/{svc_name}")
        if svc is None:
            return [] if authoritative else None
        if svc.spec.cluster_ip == "None":
            # headless: the endpoints ARE the answer (gang members find
            # each other directly)
            ep = self.endpoints.get(f"{ns}/{svc_name}")
            if ep is None:
                return []
            return [a.ip for s in ep.subsets for a in s.addresses if a.ip]
        return [svc.spec.cluster_ip] if svc.spec.cluster_ip else []

    # --------------------------------------------------------------- serving

    def _serve(self):
        while not self._stop.is_set():
            try:
                data, peer = self._sock.recvfrom(4096)
            except OSError:
                return
            try:
                resp = self._answer(data, peer)
            except Exception as e:  # noqa: BLE001 — a bad packet must not kill DNS
                # rate-limited: a spoofed-garbage flood must not turn the
                # single receive loop into a stderr-writing loop
                self._drop_reporter.report(f"malformed query from {peer}: {e}")
                continue
            if resp is not None:
                try:
                    self._sock.sendto(resp, peer)
                except OSError:
                    pass

    def _answer(self, data: bytes, peer) -> Optional[bytes]:
        if len(data) < 12:
            return None
        qid, flags, qd = struct.unpack("!HHH", data[:6])
        if qd < 1:
            return None
        name, off = _decode_name(data, 12)
        qtype, _qclass = struct.unpack("!HH", data[off:off + 4])
        question = data[12:off + 4]
        ips = self.resolve(name)
        if ips is None:
            # upstream forwards run OFF the serve thread: one slow external
            # lookup must not head-of-line-block every pod's cluster query.
            # Concurrency is BOUNDED (semaphore): an untrusted pod spamming
            # external lookups must not exhaust threads inside the kubelet
            # process hosting this resolver — saturation answers SERVFAIL
            # so the client can back off and retry.
            if not self._forward_slots.acquire(blocking=False):
                return _build_response(qid, question, _RCODE_SERVFAIL, [])
            try:
                threading.Thread(
                    target=self._forward_and_send,
                    args=(data, qid, question, peer), daemon=True).start()
            except RuntimeError:
                # can't spawn (process out of threads — the very pressure
                # this bound defends against): surrender the slot or 16
                # such failures would wedge forwarding permanently
                self._forward_slots.release()
                return _build_response(qid, question, _RCODE_SERVFAIL, [])
            return None
        if not ips:
            return _build_response(qid, question, _RCODE_NXDOMAIN, [])
        if qtype not in (1, 255):  # A / ANY only; AAAA etc: name exists,
            return _build_response(qid, question, 0, [])  # no records
        return _build_response(qid, question, 0, ips)

    def _forward_and_send(self, query: bytes, qid: int, question: bytes,
                          peer):
        try:
            self._sock.sendto(self._forward(query, qid, question), peer)
        except OSError:
            pass
        finally:
            self._forward_slots.release()

    def _forward(self, query: bytes, qid: int, question: bytes) -> bytes:
        if not self._upstream:
            return _build_response(qid, question, _RCODE_SERVFAIL, [])
        try:
            # a dead or slow resolver degrades to SERVFAIL
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as fwd:
                fwd.settimeout(2.0)
                fwd.sendto(query, (self._upstream, 53))
                return fwd.recvfrom(4096)[0]
        except OSError:
            return _build_response(qid, question, _RCODE_SERVFAIL, [])
