"""The port's Service data plane (``kubernetes1_tpu_torch/proxy``) held to
the JAX package's (``kubernetes1_tpu/proxy``), tolerance 0.

The proxiers: for each of ``N_SCRIPTS`` seeds a script of Services and
Endpoints is made with numpy (ClusterIP, NodePort and headless Services,
named and unnamed ports, ClientIP affinity, a lone unnamed endpoint port
behind a named Service port, endpoint churn, a node port moved, a Service
deleted) and written, step by step, into one fresh in-process JAX
``Master``.  The JAX userspace ``Proxier``, ``RuleTableProxier`` and
``IPVSProxier`` (its scheduler rotating over rr, wrr, lc and sh) watch it
through a JAX informer factory and the port's three through the port's,
each side listening on a loopback address of its own.  After each step,
once both sides' informers hold the step's resourceVersions, each proxier
syncs (``_sync`` of each key, ``sync_all``, ``_sync``) and the step's
record is taken: ``resolve`` of every VIP, ``node_port_for``,
``resolve_node_port``, ``dump()``, a sequence of picks for a fixed list of
client IPs (the rule table's from ``random`` seeded alike), the real
servers' weights and ``stats()``.  The records must be equal, masking
only the listen address and the ephemeral listen ports (a node port is
kept).  Then one live case pushes real connections through both
userspace proxiers and both IPVS virtual servers to echo backends.

The balancer: ``LeastInflightBalancer(seed=0)`` of each package in turn
over the same held backends (each holds every request until the script
releases it), driven by one scripted request sequence: the picks, the
answers and ``stats()`` after each step; a refused dial retried before
the first byte; and a backend removed by ``set_backends`` while its
chunked response streams, which finishes while new requests go elsewhere
and then leaves the table.  ``EndpointsBalancerSync`` is fed the same
Endpoints (wire dicts, typed for JAX's) as JAX's.  A request that finds
no backend is answered 503 at once by both.
"""

import random
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest

from kubernetes1_tpu.apiserver import Master
from kubernetes1_tpu.client import Clientset as JaxClientset
from kubernetes1_tpu.client import InformerFactory as JaxInformerFactory
from kubernetes1_tpu.proxy import balancer as jbalancer
from kubernetes1_tpu.proxy import ipvs as jipvs
from kubernetes1_tpu.proxy import proxier as jproxier
from kubernetes1_tpu.proxy import rules as jrules
from kubernetes1_tpu_torch.client.clientset import Clientset as TorchClientset
from kubernetes1_tpu_torch.client.rest import Client
from kubernetes1_tpu_torch.proxy import balancer as tbalancer
from kubernetes1_tpu_torch.proxy import ipvs as tipvs
from kubernetes1_tpu_torch.proxy import proxier as tproxier
from kubernetes1_tpu_torch.proxy import rules as trules
from kubernetes1_tpu.machinery.scheme import from_dict as jax_from_dict
from kubernetes1_tpu.api import types as jt

SEED = 2200
N_SCRIPTS = 32
HOSTS = {"jax": "127.0.0.2", "torch": "127.0.0.3"}
CLIENTS = ["10.9.0.1", "10.9.0.2", "10.9.0.1", "10.9.0.3", "10.9.0.2", "10.9.0.1"]
SCHEDULERS = ("rr", "wrr", "lc", "sh")
NS = "default"


# ------------------------------------------------------------- the scripts


def _bindable(port):
    for host in HOSTS.values():
        s = socket.socket()
        try:
            s.bind((host, port))
        except OSError:
            return False
        finally:
            s.close()
    return True


def _node_port(rng, used):
    while True:
        p = int(rng.integers(30000, 32768))
        if p not in used and _bindable(p):
            used.add(p)
            return p


def _endpoints(rng, name, ports):
    """An Endpoints wire dict for a Service of ``ports`` (names): one or
    two subsets, or none; a lone unnamed port behind a named Service port
    now and then."""
    subsets = []
    for s in range(int(rng.integers(0, 3))):
        addrs = [{"ip": f"10.{s}.{int(rng.integers(0, 4))}.{int(rng.integers(1, 250))}",
                  "targetRef": f"{name}-{s}-{k}"} for k in range(int(rng.integers(1, 4)))]
        if rng.integers(4) == 0:
            eports = [{"port": int(rng.integers(8000, 9000))}]  # unnamed: the fallback
        else:
            eports = [{"name": n, "port": 8000 + 10 * k + s} for k, n in enumerate(ports)]
        subsets.append({"addresses": addrs, "ports": eports})
    return {"metadata": {"name": name, "namespace": NS}, "subsets": subsets}


def make_script(seed: int) -> list:
    """The steps of seed ``seed``: ("create"|"endpoints"|"nodeport"|
    "delete", name, wire dict)."""
    rng = np.random.default_rng(SEED + seed)
    used, steps, live = set(), [], {}
    for k in range(int(rng.integers(3, 5))):
        name = f"svc-{k}"
        kind = ["ClusterIP", "NodePort", "headless"][int(rng.integers(3))]
        n_ports = int(rng.integers(1, 3))
        names = [""] if n_ports == 1 and rng.integers(2) else \
            [f"p{j}" for j in range(n_ports)]
        ports = [{"name": n, "port": 80 + j, "targetPort": 8000 + 10 * j}
                 for j, n in enumerate(names)]
        spec = {"selector": {"app": name}, "ports": ports}
        if kind == "NodePort":
            spec["type"] = "NodePort"
            for p in ports:
                p["nodePort"] = _node_port(rng, used)
        if kind == "headless":
            spec["clusterIP"] = "None"
        if rng.integers(3) == 0:
            spec["sessionAffinity"] = "ClientIP"
        steps.append(("create", name, {"metadata": {"name": name, "namespace": NS},
                                       "spec": spec}))
        steps.append(("endpoints", name, _endpoints(rng, name, names)))
        live[name] = (kind, names)
    for _ in range(int(rng.integers(2, 5))):
        name = sorted(live)[int(rng.integers(len(live)))]
        kind, names = live[name]
        op = int(rng.integers(4))
        if op == 0 and kind == "NodePort":
            steps.append(("nodeport", name, _node_port(rng, used)))
        elif op == 1 and len(live) > 1:
            steps.append(("delete", name, None))
            del live[name]
        else:
            steps.append(("endpoints", name, _endpoints(rng, name, names)))
    return steps


def test_the_scripts_cover_every_kind():
    steps = [s for seed in range(N_SCRIPTS) for s in make_script(seed)]
    specs = [s[2]["spec"] for s in steps if s[0] == "create"]
    assert {s.get("type", "ClusterIP") for s in specs} == {"ClusterIP", "NodePort"}
    assert sum(s.get("clusterIP") == "None" for s in specs) >= 5
    assert sum(s.get("sessionAffinity") == "ClientIP" for s in specs) >= 5
    assert {p["name"] for s in specs for p in s["ports"]} >= {"", "p0", "p1"}
    eps = [s[2] for s in steps if s[0] == "endpoints"]
    assert any(len(e["subsets"]) == 2 for e in eps) and any(not e["subsets"] for e in eps)
    assert any(len(sub["ports"]) == 1 and "name" not in sub["ports"][0]
               for e in eps for sub in e["subsets"])
    assert {s[0] for s in steps} == {"create", "endpoints", "nodeport", "delete"}


# ------------------------------------------------------------ the two sides


class _Side:
    """One package's three proxiers over its own typed informer factory."""

    def __init__(self, side, url, scheduler):
        self.side = side
        self.host = HOSTS[side]
        if side == "jax":
            self.cs = JaxClientset(url)
            self.factory = JaxInformerFactory(self.cs)
            mods = (jproxier, jrules, jipvs)
        else:
            self.cs = TorchClientset(url)
            self.factory = self.cs.informers()
            mods = (tproxier, trules, tipvs)
        self.rules_mod = mods[1]
        self.proxier = mods[0].Proxier(self.cs, self.factory, listen_host=self.host)
        self.rules = mods[1].RuleTableProxier(self.cs, self.factory)
        self.ipvs = mods[2].IPVSProxier(self.cs, self.factory, scheduler=scheduler,
                                        listen_host=self.host)
        # the informers each proxier's start() would take, without its
        # threads: the script drives every sync
        self.services = self.factory.informer("services")
        self.endpoints = self.factory.informer("endpoints")
        for p in (self.proxier, self.rules):
            p.services, p.endpoints = self.services, self.endpoints
        self.factory.start_all()
        assert self.factory.wait_for_sync(10)

    def caught_up(self, want):
        """Whether both informers hold ``want``: {(plural, key): rv or None}."""
        for (plural, key), rv in want.items():
            inf = self.services if plural == "services" else self.endpoints
            obj = inf.get(key)
            if (obj is None) != (rv is None):
                return False
            if obj is not None and obj.metadata.resource_version != rv:
                return False
        return True

    def sync(self, keys):
        for key in sorted(keys):
            self.proxier._sync(key)
        self.rules.sync_all()
        self.ipvs._sync()

    def _mask(self, addr, node_ports):
        if addr is None:
            return None
        host, port = addr
        assert host == self.host
        return ["<listen>", port if port in node_ports else "<port>"]

    def record(self, seed, step):
        node_ports = {p.node_port for s in self.services.list() for p in s.spec.ports
                      if p.node_port}
        out = {"proxier": {}, "rules": {}, "ipvs": {}}
        svcs = sorted(self.services.list(), key=lambda s: s.metadata.name)
        for svc in svcs:
            for sp in svc.spec.ports:
                k = f"{svc.metadata.name}:{sp.name}:{sp.port}"
                vip = svc.spec.cluster_ip
                np_ = self.proxier.node_port_for(NS, svc.metadata.name, sp.name)
                out["proxier"][k] = {
                    "resolve": self._mask(self.proxier.resolve(vip, sp.port), node_ports),
                    "node_port": np_ if np_ is None or np_ in node_ports else "<port>"}
                pp = self.proxier._proxies.get((NS, svc.metadata.name, sp.name))
                if pp is not None:
                    out["proxier"][k]["backends"] = list(pp.backends)
                    out["proxier"][k]["affinity"] = pp.affinity
                    out["proxier"][k]["picks"] = [pp._pick(c) for c in CLIENTS]
                # the rule table's random pick, from a stream of its own
                self.rules_mod.random = random.Random(SEED * 1000 + seed * 10 + step)
                out["rules"][k] = {
                    "resolve": [self.rules.resolve(vip, sp.port, c) for c in CLIENTS],
                    "node_port": [self.rules.resolve_node_port(sp.node_port, c)
                                  for c in CLIENTS[:3]] if sp.node_port else None}
                vs = self.ipvs.virtual_for(NS, svc.metadata.name, sp.name)
                out["ipvs"][k] = {
                    "resolve": self._mask(self.ipvs.resolve(vip, sp.port), node_ports)}
                if vs is not None:
                    out["ipvs"][k]["picks"] = [
                        (b.addr, b.weight) if b else None for b in
                        (vs.pick(c) for c in CLIENTS)]
        out["proxier_stats"] = self.proxier.stats()
        out["rules_dump"] = self.rules.dump()
        out["ipvs_dump"] = self.ipvs.dump()
        return out

    def stop(self):
        self.rules_mod.random = random
        self.proxier.stop()
        self.rules.stop()
        self.ipvs.stop()
        self.factory.stop_all()
        self.cs.close()


def _apply(wire, step):
    """Write one step; returns {(plural, key): rv or None} it leaves."""
    op, name, body = step
    key = f"{NS}/{name}"
    if op == "create":
        obj = wire.services.create(body, NS)
        return {("services", key): obj["metadata"]["resourceVersion"]}
    if op == "endpoints":
        try:
            cur = wire.endpoints.get(name, NS)
            body = dict(body, metadata=dict(body["metadata"],
                                            resourceVersion=cur["metadata"]["resourceVersion"]))
            obj = wire.endpoints.update(body)
        except Exception:  # noqa: BLE001 - not there yet: create it
            obj = wire.endpoints.create(body, NS)
        return {("endpoints", key): obj["metadata"]["resourceVersion"]}
    if op == "nodeport":
        cur = wire.services.get(name, NS)
        cur["spec"]["ports"][0]["nodePort"] = body
        obj = wire.services.update(cur)
        return {("services", key): obj["metadata"]["resourceVersion"]}
    wire.services.delete(name, NS)
    try:
        wire.endpoints.delete(name, NS)
    except Exception:  # noqa: BLE001 - no endpoints were written
        pass
    return {("services", key): None, ("endpoints", key): None}


def _wait(what, fn, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.mark.parametrize("seed", range(N_SCRIPTS))
def test_proxiers_follow_the_script_as_jax_does(seed):
    m = Master().start()
    wire = Client(m.url)
    sides = {}
    try:
        for side in ("jax", "torch"):
            sides[side] = _Side(side, m.url, SCHEDULERS[seed % len(SCHEDULERS)])
        touched, want = set(), {}
        for i, step in enumerate(make_script(seed)):
            left = _apply(wire, step)
            want.update(left)
            touched |= {key for (_p, key) in left}
            records = {}
            for side, s in sides.items():
                _wait(f"{side}'s informers at step {i}", lambda s=s: s.caught_up(want))
                s.sync(touched)
                records[side] = s.record(seed, i)
            assert records["torch"] == records["jax"], f"step {i}: {step[0]} {step[1]}"
        assert records["jax"]["rules_dump"].startswith("*nat")
    finally:
        for s in sides.values():
            s.stop()
        wire.close()
        m.stop()


# --------------------------------------------------------- the live data path


class _Echo:
    """A TCP backend that answers each connection with its own name."""

    def __init__(self, name):
        self.name = name.encode()
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(16)
        self.port = self.sock.getsockname()[1]
        self._th = threading.Thread(target=self._serve, daemon=True)
        self._th.start()

    def _serve(self):
        while True:
            try:
                c, _ = self.sock.accept()
            except OSError:
                return
            with c:
                try:
                    c.recv(64)
                    c.sendall(self.name)
                except OSError:
                    pass

    def stop(self):
        try:
            self.sock.shutdown(socket.SHUT_RDWR)  # wakes the blocked accept
        except OSError:
            pass
        self.sock.close()
        self._th.join(timeout=5)


def _ask(host, port):
    with socket.create_connection((host, port), timeout=5) as s:
        s.sendall(b"hi")  # no half-close: the userspace splice ends both ways at an EOF
        out = b""
        while True:
            d = s.recv(64)
            if not d:
                return out.decode()
            out += d


def test_connections_through_the_proxiers_as_jax():
    """Real connections through each package's userspace proxier (round
    robin) and IPVS virtual server (lc) reach the same echo backends in the
    same order, and leave the same counters and ipvsadm listing."""
    echoes = [_Echo(f"b{i}") for i in range(3)]
    m = Master().start()
    wire = Client(m.url)
    sides = {}
    try:
        for side in ("jax", "torch"):
            sides[side] = _Side(side, m.url, "lc")
        ports = [e.port for e in echoes]
        want = {}
        for step in (("create", "live", {"metadata": {"name": "live", "namespace": NS},
                                         "spec": {"ports": [{"port": 80}]}}),
                     ("endpoints", "live", {"metadata": {"name": "live", "namespace": NS},
                                            "subsets": [{"addresses": [{"ip": "127.0.0.1"}],
                                                         "ports": [{"port": p}]}
                                                        for p in ports]})):
            want.update(_apply(wire, step))
        got = {}
        for side, s in sides.items():
            _wait(f"{side}'s informers", lambda s=s: s.caught_up(want))
            s.sync({f"{NS}/live"})
            vip = s.services.get(f"{NS}/live").spec.cluster_ip
            answers = [_ask(*s.proxier.resolve(vip, 80)) for _ in range(4)]
            for _ in range(4):  # lc picks by active connections: one at a time
                answers.append(_ask(*s.ipvs.resolve(vip, 80)))
                _wait(f"{side}'s virtual server to close the connection",
                      lambda s=s: all(b.active_conns == 0
                                      for b in s.ipvs.virtual_for(NS, "live").backends))
            _wait(f"{side}'s proxier to count its connections",
                  lambda s=s: s.proxier.stats()["connections"] == 4)
            got[side] = {"answers": answers, "stats": s.proxier.stats(),
                         "dump": s.ipvs.dump()}
        assert got["torch"] == got["jax"]
        assert sorted(set(got["jax"]["answers"])) == ["b0", "b1", "b2"]
        assert got["jax"]["stats"] == {"services": 1, "ports": 1, "connections": 4, "errors": 0}
    finally:
        for s in sides.values():
            s.stop()
        wire.close()
        m.stop()
        for e in echoes:
            e.stop()


# -------------------------------------------------------------- the balancer


class _Held:
    """An HTTP backend that holds each request until released: the script,
    not the clock, decides when a response goes out.  ``streamed``
    responses are chunked, their first chunk sent at once."""

    def __init__(self, idx):
        self.idx = idx
        self.sock = socket.socket()
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(32)
        self.addr = ("127.0.0.1", self.sock.getsockname()[1])
        self.held = {}  # request id -> (conn, release event, streamed)
        self.lock = threading.Lock()
        self._threads = []
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                c, _ = self.sock.accept()
            except OSError:
                return
            th = threading.Thread(target=self._serve, args=(c,), daemon=True)
            th.start()

    def _serve(self, c):
        with c:
            buf = b""
            while b"\r\n\r\n" not in buf:
                d = c.recv(4096)
                if not d:
                    return
                buf += d
            head = buf.split(b"\r\n\r\n")[0].decode("latin-1").lower()
            rid = next(ln.split(":", 1)[1].strip() for ln in head.split("\r\n")
                       if ln.startswith("x-req:"))
            streamed = "x-stream: 1" in head
            ev = threading.Event()
            if streamed:
                c.sendall(b"HTTP/1.1 200 OK\r\ntransfer-encoding: chunked\r\n\r\n"
                          b"5\r\nfirst\r\n")
            with self.lock:
                self.held[rid] = ev
            if not ev.wait(30):
                return
            body = f"b{self.idx}:{rid}".encode()
            if streamed:
                c.sendall(b"%x\r\n%s\r\n0\r\n\r\n" % (len(body), body))
            else:
                c.sendall(b"HTTP/1.1 200 OK\r\ncontent-length: %d\r\n\r\n%s"
                          % (len(body), body))

    def stop(self):
        with self.lock:
            for ev in self.held.values():
                ev.set()
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


def _refused_addr():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    addr = s.getsockname()
    s.close()
    return addr


class _Request(threading.Thread):
    def __init__(self, url, rid, streamed=False):
        super().__init__(daemon=True)
        self.req = urllib.request.Request(url + "/generate", data=b"{}", method="POST",
                                          headers={"x-req": rid,
                                                   **({"x-stream": "1"} if streamed else {})})
        self.answer = None
        self.start()

    def run(self):
        try:
            with urllib.request.urlopen(self.req, timeout=30) as r:
                self.answer = (r.status, r.read().decode())
        except Exception as e:  # noqa: BLE001 - the answer records it
            self.answer = ("error", str(e))


def _run_balancer_script(mod, held, refused):
    """Drive one package's balancer through the script; the record of each
    step (picks by backend index, answers, stats with addresses named)."""
    names = {f"{b.addr[0]}:{b.addr[1]}": f"b{b.idx}" for b in held}
    names[f"{refused[0]}:{refused[1]}"] = "refused"

    def named(stats):
        return {**stats,
                "backends": {names[a]: v for a, v in stats["backends"].items()},
                "picks": {names[a]: v for a, v in stats["picks"].items()}}

    bal = mod.LeastInflightBalancer(seed=0)
    record, reqs = [], {}
    try:
        def settle_table(n):
            _wait("the backend set", lambda: len(bal.stats()["backends"]) == n)

        def send(rid, streamed=False):
            reqs[rid] = _Request(bal.url, rid, streamed)
            _wait(f"request {rid} to be held",
                  lambda: any(rid in b.held for b in held))
            where = next(b.idx for b in held if rid in b.held)
            record.append(("pick", rid, where))

        def release(rid):
            b = next(b for b in held if rid in b.held)
            b.held[rid].set()
            reqs[rid].join(timeout=10)
            _wait(f"request {rid} to leave the in-flight count",
                  lambda: sum(v["inflight"] for v in bal.stats()["backends"].values())
                  == sum(1 for k, r in reqs.items() if r.answer is None))
            record.append(("answer", rid, reqs[rid].answer))

        bal.set_backends([b.addr for b in held])
        settle_table(len(held))
        # least in flight, ties by two seeded choices
        for rid in ("r0", "r1", "r2", "r3"):
            send(rid)
        record.append(("stats", named(bal.stats())))
        for rid in ("r1", "r3"):
            release(rid)
        for rid in ("r4", "r5", "r6"):
            send(rid)
        for rid in ("r0", "r2", "r4", "r5", "r6"):
            release(rid)
        record.append(("stats", named(bal.stats())))
        # a refused dial before the first byte: retried on a survivor
        bal.set_backends([refused] + [b.addr for b in held])
        settle_table(len(held) + 1)
        for rid in ("r7", "r8", "r9", "r10"):
            send(rid)
            release(rid)
        record.append(("stats", named(bal.stats())))
        # drain: backend 0 leaves the set while its chunked response streams
        bal.set_backends([b.addr for b in held])
        settle_table(len(held))
        send("s0", streamed=True)
        gone = next(b for b in held if "s0" in b.held)
        bal.set_backends([b.addr for b in held if b is not gone])
        _wait("the removed backend to drain",
              lambda: bal.stats()["backends"][f"{gone.addr[0]}:{gone.addr[1]}"]["draining"])
        for rid in ("r11", "r12", "r13"):
            send(rid)
            release(rid)
        assert all(step[2] != gone.idx for step in record[-6:] if step[0] == "pick")
        record.append(("stats", named(bal.stats())))
        release("s0")
        _wait("the drained backend to leave the table",
              lambda: len(bal.stats()["backends"]) == len(held) - 1)
        record.append(("stats", named(bal.stats())))
    finally:
        bal.stop()
        for r in reqs.values():
            r.join(timeout=5)
    return record


def test_balancer_follows_the_script_as_jax_does():
    held = [_Held(i) for i in range(3)]
    refused = _refused_addr()
    try:
        records = {}
        for side, mod in (("jax", jbalancer), ("torch", tbalancer)):
            for b in held:
                b.held.clear()
            records[side] = _run_balancer_script(mod, held, refused)
    finally:
        for b in held:
            b.stop()
    assert records["torch"] == records["jax"]
    rec = records["jax"]
    answers = {step[1]: step[2] for step in rec if step[0] == "answer"}
    assert all(a[0] == 200 for a in answers.values()), answers
    assert answers["s0"][1].startswith("first") and answers["s0"][1].endswith(":s0")
    stats = [step[1] for step in rec if step[0] == "stats"]
    assert stats[2]["retries"] >= 1 and stats[2]["errors"] == 0
    assert stats[2]["backends"]["refused"]["errors"] >= 1
    assert set(stats[0]["picks"]) == {"b0", "b1", "b2"}


class _Factory:
    """An informer factory whose one informer records its handlers."""

    def informer(self, plural):
        assert plural == "endpoints"
        return self

    def add_handler(self, on_add, on_update, on_delete):
        self.on_add, self.on_update, self.on_delete = on_add, on_update, on_delete


class _Sink:
    def __init__(self):
        self.sets = []

    def set_backends(self, addrs):
        self.sets.append(list(addrs))


def test_endpoints_sync_feeds_the_balancer_as_jax():
    """The same Endpoints events, typed for JAX's sync (its informer's
    cache) and wire dicts for the port's: the same backend sets, resolved by targetRef
    (the pod's name) and the subset's first port, not-ready addresses left
    out, the other Service ignored, a delete emptying the set."""
    def resolver(ident, port):
        return None if ident == "gone" else (f"host-{ident}", port + 1)

    wires = [
        {"metadata": {"name": "fleet", "namespace": NS}, "subsets": [
            {"addresses": [{"ip": "10.0.0.1", "targetRef": "pod-a"},
                           {"ip": "10.0.0.2", "targetRef": "pod-b"}],
             "notReadyAddresses": [{"ip": "10.0.0.3", "targetRef": "pod-c"}],
             "ports": [{"name": "http", "port": 8000}, {"name": "m", "port": 9000}]}]},
        {"metadata": {"name": "other", "namespace": NS}, "subsets": [
            {"addresses": [{"ip": "10.0.0.9"}], "ports": [{"port": 1}]}]},
        {"metadata": {"name": "fleet", "namespace": NS}, "subsets": [
            {"addresses": [{"ip": "10.0.0.4"}, {"ip": "10.0.0.5", "targetRef": "gone"}],
             "ports": [{"port": 7000}]},
            {"addresses": [{"ip": "10.0.0.6", "targetRef": "pod-d"}], "ports": []}]},
    ]
    got = {}
    for side, mod, conv in (
            ("jax", jbalancer, lambda w: jax_from_dict(jt.Endpoints, w)),
            ("torch", tbalancer, lambda w: w)):
        sink, fac = _Sink(), _Factory()
        mod.EndpointsBalancerSync(sink, fac, NS, "fleet", resolver=resolver)
        fac.on_add(conv(wires[0]))
        fac.on_update(conv(wires[0]), conv(wires[1]))
        fac.on_update(conv(wires[0]), conv(wires[2]))
        fac.on_delete(conv(wires[1]))
        fac.on_delete(conv(wires[2]))
        got[side] = sink.sets
    assert got["torch"] == got["jax"]
    assert got["jax"] == [[("host-pod-a", 8001), ("host-pod-b", 8001)],
                          [("host-10.0.0.4", 7001), ("host-pod-d", 1)], []]


def test_a_request_with_no_backend_is_answered_503_as_jax_does():
    """With no backend in its table each balancer answers 503 at once, and
    again once its one backend has left: the same answers and ``stats()``."""
    held = _Held(0)
    got = {}
    try:
        for side, mod in (("jax", jbalancer), ("torch", tbalancer)):
            bal = mod.LeastInflightBalancer(seed=0)
            try:
                t0 = time.monotonic()
                first = _Request(bal.url, "n0")
                first.join(timeout=10)
                took = time.monotonic() - t0
                bal.set_backends([held.addr])
                _wait("the backend in the table", lambda: bal.stats()["backends"])
                bal.set_backends([])
                _wait("an empty table", lambda: not bal.stats()["backends"])
                late = _Request(bal.url, "n1")
                late.join(timeout=10)
                stats = bal.stats()
                got[side] = (first.answer, late.answer, stats["errors"], stats["picks"])
                assert first.answer[0] == "error" and "503" in first.answer[1]
                assert took < 2.0, took
            finally:
                bal.stop()
    finally:
        held.stop()
    assert got["torch"] == got["jax"]
    assert got["jax"][2] == 2 and got["jax"][3] == {}
