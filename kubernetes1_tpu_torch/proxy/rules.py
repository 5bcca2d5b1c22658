"""Rule-table proxier: the iptables-mode kube-proxy (ref: pkg/proxy/
iptables/proxier.go).

The port's copy of the JAX package's ``proxy/rules.py``.  Watch events
mark the table dirty; a sync pass compiles the whole rule table and swaps
it in at once (the iptables-restore batch); ``resolve()`` is a lookup with
a uniformly random backend (the iptables statistic module), or ClientIP
affinity.  No socket per Service.  ``dump()`` renders the compiled table
in iptables-save syntax (``KTPU-SERVICES`` / ``KTPU-SVC-*`` /
``KTPU-SEP-*``, the reference's ``KUBE-*`` chains).
"""

from __future__ import annotations

import hashlib
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..api import types as t
from ..client.clientset import Clientset
from ..client.informer import InformerFactory


class _ServiceRules:
    __slots__ = ("namespace", "name", "port_name", "protocol", "cluster_ip",
                 "port", "node_port", "affinity", "backends")

    def __init__(self, namespace, name, port_name, protocol, cluster_ip, port,
                 node_port, affinity, backends):
        self.namespace = namespace
        self.name = name
        self.port_name = port_name
        self.protocol = protocol
        self.cluster_ip = cluster_ip
        self.port = port
        self.node_port = node_port
        self.affinity = affinity
        self.backends = backends  # [(ip, port)]


class RuleTableProxier:
    """Compiles the service/endpoint state into an immutable lookup table,
    swapped atomically on every sync (the iptables-restore model)."""

    def __init__(self, clientset: Clientset, factory: Optional[InformerFactory] = None,
                 min_sync_period: float = 0.05):
        self.cs = clientset
        self.factory = factory or clientset.informers()
        self._own_factory = factory is None
        self.min_sync_period = min_sync_period
        self._dirty = threading.Event()
        self._stop = threading.Event()
        # immutable compiled tables, swapped as a unit
        self._by_vip: Dict[Tuple[str, int], _ServiceRules] = {}
        self._by_nodeport: Dict[int, _ServiceRules] = {}
        self._affinity: Dict[Tuple[str, str], Tuple[Tuple[str, int], float]] = {}
        self._affinity_lock = threading.Lock()  # written by resolve AND sync
        self._affinity_ttl = 10800.0
        self.sync_count = 0

    # --------------------------------------------------------------- control

    def start(self):
        self.services = self.factory.informer("services")
        self.endpoints = self.factory.informer("endpoints")
        mark = lambda *_a, **_k: self._dirty.set()  # noqa: E731
        for inf in (self.services, self.endpoints):
            inf.add_handler(on_add=mark, on_update=lambda _o, _n: self._dirty.set(),
                            on_delete=mark)
        if self._own_factory:
            self.factory.start_all()
            self.factory.wait_for_sync()
        self._dirty.set()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._dirty.set()
        if self._own_factory:
            self.factory.stop_all()

    def _loop(self):
        while not self._stop.is_set():
            self._dirty.wait(1.0)
            if self._stop.is_set():
                return
            if not self._dirty.is_set():
                continue
            self._dirty.clear()
            time.sleep(self.min_sync_period)  # coalesce bursts
            self.sync_all()

    # --------------------------------------------------------------- compile

    def sync_all(self):
        """Recompile the whole table (iptables-restore semantics: one atomic
        swap, partial state never visible)."""
        by_vip: Dict[Tuple[str, int], _ServiceRules] = {}
        by_nodeport: Dict[int, _ServiceRules] = {}
        for svc in self.services.list():
            if svc.spec.cluster_ip in ("", "None"):
                continue
            eps = self.endpoints.get(svc.key())
            for sp in svc.spec.ports:
                backends = self._backends_for(eps, sp)
                rules = _ServiceRules(
                    namespace=svc.metadata.namespace, name=svc.metadata.name,
                    port_name=sp.name, protocol=sp.protocol or "TCP",
                    cluster_ip=svc.spec.cluster_ip, port=sp.port,
                    node_port=sp.node_port or 0,
                    affinity=svc.spec.session_affinity or "",
                    backends=backends,
                )
                by_vip[(svc.spec.cluster_ip, sp.port)] = rules
                if rules.node_port:
                    by_nodeport[rules.node_port] = rules
        self._by_vip = by_vip  # atomic reference swap
        self._by_nodeport = by_nodeport
        # prune affinity state: expired entries and deleted services — the
        # map otherwise grows one entry per distinct client IP forever
        live = {f"{r.namespace}/{r.name}:{r.port_name}" for r in by_vip.values()}
        now = time.monotonic()
        with self._affinity_lock:
            for k in [
                k for k, v in self._affinity.items()
                if k[0] not in live or now - v[1] >= self._affinity_ttl
            ]:
                del self._affinity[k]  # prune in place: concurrent resolve()
                # writes between snapshot and swap must not be lost
        self.sync_count += 1

    @staticmethod
    def _backends_for(eps: Optional[t.Endpoints], sp) -> List[Tuple[str, int]]:
        if eps is None:
            return []
        out = []
        for subset in eps.subsets:
            port = None
            for ep in subset.ports:
                if not sp.name or ep.name == sp.name:
                    port = ep.port
                    break
            if port is None and subset.ports:
                port = subset.ports[0].port
            if port is None:
                continue
            for addr in subset.addresses:
                out.append((addr.ip, port))
        return sorted(out)

    # --------------------------------------------------------------- resolve

    def resolve(self, cluster_ip: str, port: int,
                client_ip: str = "") -> Optional[Tuple[str, int]]:
        """DNAT decision: weighted-random backend (the iptables statistic
        module), with ClientIP affinity when the service asks for it."""
        rules = self._by_vip.get((cluster_ip, port))
        return self._pick(rules, client_ip)

    def resolve_node_port(self, node_port: int,
                          client_ip: str = "") -> Optional[Tuple[str, int]]:
        return self._pick(self._by_nodeport.get(node_port), client_ip)

    def _pick(self, rules: Optional[_ServiceRules],
              client_ip: str) -> Optional[Tuple[str, int]]:
        if rules is None or not rules.backends:
            return None
        if rules.affinity == "ClientIP" and client_ip:
            akey = (f"{rules.namespace}/{rules.name}:{rules.port_name}", client_ip)
            now = time.monotonic()
            with self._affinity_lock:
                hit = self._affinity.get(akey)
                if hit and now - hit[1] < self._affinity_ttl and hit[0] in rules.backends:
                    self._affinity[akey] = (hit[0], now)
                    return hit[0]
                chosen = random.choice(rules.backends)
                self._affinity[akey] = (chosen, now)
            return chosen
        return random.choice(rules.backends)

    # ------------------------------------------------------------------ dump

    @staticmethod
    def _chain(prefix: str, *parts: str) -> str:
        h = hashlib.sha256("/".join(parts).encode()).hexdigest()[:16].upper()
        return f"{prefix}-{h}"

    def dump(self) -> str:
        """Render the compiled table in iptables-save syntax (KTPU-SERVICES /
        KTPU-SVC-* / KTPU-SEP-* mirror the reference's KUBE-* chains)."""
        lines = ["*nat", ":KTPU-SERVICES - [0:0]", ":KTPU-NODEPORTS - [0:0]"]
        svc_lines, sep_lines = [], []
        for (vip, port), rules in sorted(self._by_vip.items()):
            svc_chain = self._chain("KTPU-SVC", rules.namespace, rules.name,
                                    rules.port_name)
            lines.append(f":{svc_chain} - [0:0]")
            svc_lines.append(
                f"-A KTPU-SERVICES -d {vip}/32 -p {rules.protocol.lower()} "
                f"--dport {port} -m comment --comment "
                f'"{rules.namespace}/{rules.name}:{rules.port_name}" -j {svc_chain}'
            )
            if rules.node_port:
                svc_lines.append(
                    f"-A KTPU-NODEPORTS -p {rules.protocol.lower()} "
                    f"--dport {rules.node_port} -j {svc_chain}"
                )
            n = len(rules.backends)
            for i, (bip, bport) in enumerate(rules.backends):
                sep_chain = self._chain("KTPU-SEP", rules.namespace, rules.name,
                                        rules.port_name, f"{bip}:{bport}")
                lines.append(f":{sep_chain} - [0:0]")
                prob = ""
                if i < n - 1:
                    prob = (f" -m statistic --mode random "
                            f"--probability {1.0 / (n - i):.5f}")
                sep_lines.append(f"-A {svc_chain}{prob} -j {sep_chain}")
                sep_lines.append(
                    f"-A {sep_chain} -p {rules.protocol.lower()} "
                    f"-j DNAT --to-destination {bip}:{bport}"
                )
        lines.extend(svc_lines)
        lines.extend(sep_lines)
        lines.append("COMMIT")
        return "\n".join(lines) + "\n"
