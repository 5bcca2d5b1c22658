"""The port's apiserver client and informer against the JAX package's
apiserver (an in-process ``Master``).

What the port's ``Client`` creates reads back as the JAX ``Clientset``'s
``to_dict`` of the same object, for every resource the port writes; a
stale resourceVersion is a ``Conflict`` that ``retry_on_conflict``
recovers, a missing name ``NotFound``, a second create ``AlreadyExists``;
``delete_batch`` gives the JAX clientset's per-item outcomes; the Status
errors and ``is_transient`` mean what the JAX package's do; and the
informer delivers add, update and delete in order and, after its watch is
cut, relists and still reports a delete it did not see.  Against a raw
socket server: a broken HTTP exchange surfaces as a ConnectionError, and
a write on a keep-alive socket that the server closed goes out once, on a
new connection.
"""

import socket
import threading
import time

import pytest

from kubernetes1_tpu.api import types as t
from kubernetes1_tpu.apiserver import Master
from kubernetes1_tpu.client import Clientset
from kubernetes1_tpu.client import retry as jretry
from kubernetes1_tpu.machinery import errors as jerrors
from kubernetes1_tpu.machinery.scheme import to_dict
from kubernetes1_tpu_torch.client import errors
from kubernetes1_tpu_torch.client.informer import InformerFactory, SharedInformer
from kubernetes1_tpu_torch.client.rest import Client


@pytest.fixture()
def api():
    master = Master().start()
    client = Client(master.url)
    cs = Clientset(master.url)
    yield client, cs
    client.close()
    cs.close()
    master.stop()


def _pod(name):
    p = t.Pod()
    p.metadata.name = name
    p.metadata.namespace = "default"
    p.metadata.labels = {"app": "web"}
    c = t.Container(name="c", image="img", command=["sleep", "1"])
    c.resources.requests = {"cpu": "10m"}
    c.env = [t.EnvVar(name="K", value="v")]
    p.spec.containers = [c]
    p.spec.restart_policy = "Never"
    return p


def _job(name):
    j = t.Job()
    j.metadata.name = name
    j.metadata.namespace = "default"
    j.spec.completions = 2
    j.spec.parallelism = 2
    j.spec.completion_mode = "Indexed"
    j.spec.backoff_limit = 3
    j.spec.template.metadata.labels = {"app": name}
    j.spec.template.spec.containers = [t.Container(name="c", image="img")]
    return j


def _deployment(name):
    d = t.Deployment()
    d.metadata.name = name
    d.metadata.namespace = "default"
    d.spec.replicas = 2
    d.spec.selector = t.LabelSelector(match_labels={"app": name})
    d.spec.template.metadata.labels = {"app": name}
    d.spec.template.spec.containers = [t.Container(name="c", image="img")]
    return d


def _service(name):
    s = t.Service()
    s.metadata.name = name
    s.metadata.namespace = "default"
    s.spec.selector = {"app": name}
    s.spec.ports = [t.ServicePort(name="rl", port=80, target_port=8080)]
    return s


def _endpoints(name):
    e = t.Endpoints()
    e.metadata.name = name
    e.metadata.namespace = "default"
    e.subsets = [t.EndpointSubset(addresses=[t.EndpointAddress(ip="10.0.0.1")],
                                  ports=[t.EndpointPort(port=80)])]
    return e


def _pdb(name):
    b = t.PodDisruptionBudget()
    b.metadata.name = name
    b.metadata.namespace = "default"
    b.spec.selector = t.LabelSelector(match_labels={"app": name})
    b.spec.min_available = 1
    return b


RESOURCES = [("pods", _pod), ("jobs", _job), ("deployments", _deployment),
             ("services", _service), ("endpoints", _endpoints),
             ("poddisruptionbudgets", _pdb)]


def _bare(d):
    return {k: v for k, v in d.items() if k not in ("kind", "apiVersion")}


@pytest.mark.parametrize("plural,make", RESOURCES, ids=[r[0] for r in RESOURCES])
def test_created_objects_read_back_as_the_jax_clientsets(api, plural, make):
    client, cs = api
    rc = client.resource(plural)
    made = rc.create(to_dict(make("obj-1")))
    got = rc.get("obj-1", "default")
    want = to_dict(cs.resource(plural).get("obj-1", "default"))
    assert _bare(got) == want
    assert _bare(made) == want
    assert got["kind"] == rc.kind and got["apiVersion"] == rc.api_version
    items, rv = rc.list("default")
    assert [_bare(i) for i in items] == [want] and int(rv) > 0


def test_label_selected_list(api):
    client, _ = api
    for name, app in (("a", "web"), ("b", "db"), ("c", "web")):
        d = to_dict(_pod(name))
        d["metadata"]["labels"] = {"app": app}
        client.pods.create(d)
    items, _ = client.pods.list("default", "app=web")
    assert sorted(i["metadata"]["name"] for i in items) == ["a", "c"]


def test_stale_resource_version_conflicts_and_retry_on_conflict_recovers(api):
    client, cs = api
    client.pods.create(to_dict(_pod("p")))
    stale = client.pods.get("p")
    fresh = client.pods.get("p")
    fresh["metadata"]["labels"]["v"] = "1"
    client.pods.update(fresh)
    stale["metadata"]["labels"]["v"] = "2"
    with pytest.raises(errors.Conflict) as e:
        client.pods.update(stale)
    assert e.value.code == 409 and e.value.status["reason"] == "Conflict"
    calls = []

    def bump():
        cur = client.pods.get("p") if calls else stale  # the first try is stale
        calls.append(1)
        cur["metadata"]["labels"]["v"] = "3"
        return client.pods.update(cur)

    assert errors.retry_on_conflict(bump)["metadata"]["labels"]["v"] == "3"
    assert len(calls) == 2
    assert cs.pods.get("p", "default").metadata.labels["v"] == "3"


def test_retry_on_conflict_gives_up_after_its_steps():
    calls = []

    def always():
        calls.append(1)
        raise errors.Conflict("stale")

    with pytest.raises(errors.Conflict):
        errors.retry_on_conflict(always, steps=3, sleep=0.001)
    assert len(calls) == 3


def test_missing_name_and_second_create(api):
    client, _ = api
    with pytest.raises(errors.NotFound) as e:
        client.pods.get("ghost")
    assert e.value.code == 404
    with pytest.raises(errors.NotFound):
        client.pods.delete("ghost")
    client.pods.create(to_dict(_pod("twice")))
    with pytest.raises(errors.AlreadyExists) as e:
        client.pods.create(to_dict(_pod("twice")))
    assert e.value.code == 409


def test_delete_batch_per_item_outcomes_mixed(api):
    """The JAX clientset's mixed case: successes, a NotFound and a stale
    resourceVersion precondition Conflict, each item failing alone."""
    client, _ = api
    for i in range(3):
        client.pods.create({"metadata": {"name": f"db-{i}"},
                            "spec": {"containers": [{"name": "c", "image": "i"}]}})
    out = client.delete_batch("default", [
        "db-0", "ghost", {"name": "db-1", "resourceVersion": "999999"},
        {"name": "db-2", "gracePeriodSeconds": 0}])
    assert out[0] is None
    assert isinstance(out[1], errors.NotFound)
    assert isinstance(out[2], errors.Conflict)
    assert out[3] is None
    assert {p["metadata"]["name"] for p in client.pods.list("default")[0]} == {"db-1"}


def test_delete_with_grace_and_pod_log_of_a_missing_pod(api):
    client, _ = api
    client.pods.create(to_dict(_pod("g")))
    client.pods.delete("g", grace_seconds=0)
    assert client.pods.list("default")[0] == []
    with pytest.raises(errors.NotFound):
        client.pod_log("g")


def test_healthz_and_nodes(api):
    client, cs = api
    assert client.healthz()
    n = t.Node()
    n.metadata.name = "n1"
    cs.nodes.create(n)
    assert client.nodes.get("n1")["metadata"]["name"] == "n1"
    assert not Client("http://127.0.0.1:1").healthz()


STATUSES = [
    {"kind": "Status", "code": 404, "reason": "NotFound", "message": "x"},
    {"kind": "Status", "code": 409, "reason": "AlreadyExists", "message": "x"},
    {"kind": "Status", "code": 409, "reason": "Conflict", "message": "x"},
    {"kind": "Status", "code": 410, "reason": "Expired", "message": "x"},
    {"kind": "Status", "code": 429, "reason": "TooManyRequests", "message": "x"},
    {"kind": "Status", "code": 503, "reason": "ServiceUnavailable", "message": "x"},
    {"kind": "Status", "code": 422, "reason": "Invalid", "message": "x"},
    {"kind": "Status", "code": 500, "reason": "InternalError", "message": ""},
]


@pytest.mark.parametrize("status", STATUSES, ids=[s["reason"] for s in STATUSES])
def test_status_errors_mean_what_the_jax_packages_do(status):
    got = errors.ApiError.from_status(status)
    want = jerrors.ApiError.from_status(status)
    assert got.code == want.code == status["code"] and got.status == status
    assert errors.is_transient(got) == jretry.is_transient(want)
    for port_cls, jax_cls in ((errors.NotFound, jerrors.NotFound),
                              (errors.Conflict, jerrors.Conflict),
                              (errors.AlreadyExists, jerrors.AlreadyExists),
                              (errors.Gone, jerrors.TooOldResourceVersion)):
        assert isinstance(got, port_cls) == isinstance(want, jax_cls)


@pytest.mark.parametrize("exc", [ConnectionResetError(), TimeoutError(), OSError(),
                                 ValueError(), KeyError()], ids=lambda e: type(e).__name__)
def test_connection_failures_are_transient_as_in_the_jax_package(exc):
    assert errors.is_transient(exc) == jretry.is_transient(exc)


class _RawServer:
    """A loopback HTTP server that answers each request as ``answer(n)``
    says (n counts the requests), then keeps the connection open or, with
    ``close_after``, closes it at once; ``seen`` lists each request's
    method and connection number."""

    def __init__(self, answer, close_after: bool):
        self.answer, self.close_after = answer, close_after
        self.seen, self.closed = [], threading.Event()
        self.sock = socket.create_server(("127.0.0.1", 0))
        self.url = f"http://127.0.0.1:{self.sock.getsockname()[1]}"
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        conns = 0
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            conns += 1
            threading.Thread(target=self._conn, args=(conn, conns), daemon=True).start()

    def _conn(self, conn, number):
        f = conn.makefile("rb")
        with conn:
            while True:
                line = f.readline()
                if not line:
                    return
                length = 0
                while (h := f.readline()) not in (b"\r\n", b""):
                    if h.lower().startswith(b"content-length:"):
                        length = int(h.split(b":")[1])
                f.read(length)
                self.seen.append((line.split()[0].decode(), number))
                conn.sendall(self.answer(len(self.seen)))
                if self.close_after:
                    conn.shutdown(socket.SHUT_RDWR)
                    self.closed.set()
                    return

    def stop(self):
        self.sock.close()


def _answer(body: bytes, length: int) -> bytes:
    return (b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
            b"Content-Length: %d\r\n\r\n" % length) + body


@pytest.mark.parametrize("method", ["GET", "POST"])
def test_a_broken_exchange_raises_a_connection_error(method):
    """A body cut short (IncompleteRead, not an OSError) reaches the caller
    as a ConnectionError; a GET is retried first, a sent write is not."""
    srv = _RawServer(lambda n: _answer(b"{}", 10), close_after=True)
    client = Client(srv.url)
    try:
        with pytest.raises(ConnectionError):
            client.request(method, "/x", body=None if method == "GET" else {})
        assert [m for m, _ in srv.seen] == [method] * (4 if method == "GET" else 1)
    finally:
        client.close()
        srv.stop()


def test_a_write_on_a_keep_alive_socket_the_server_closed_goes_out_once():
    """The server answers and then closes the idle connection: the next
    write goes out once, on a new connection, and succeeds."""
    srv = _RawServer(lambda n: _answer(b'{"n": %d}' % n, len(b'{"n": %d}' % n)),
                     close_after=True)
    client = Client(srv.url)
    try:
        assert client.request("GET", "/x") == {"n": 1}
        assert srv.closed.wait(5)
        time.sleep(0.05)  # the close reaches the client's socket
        # a DELETE: no body, so the request goes out in one send
        assert client.request("DELETE", "/x") == {"n": 2}
        assert srv.seen == [("GET", 1), ("DELETE", 2)]
    finally:
        client.close()
        srv.stop()


class _Recorder:
    def __init__(self):
        self.events = []
        self.cond = threading.Condition()

    def handler(self, kind):
        def on(*args):
            obj = args[-1]
            with self.cond:
                self.events.append((kind, obj["metadata"]["name"],
                                    (obj["metadata"].get("labels") or {}).get("v")))
                self.cond.notify_all()
        return on

    def wait_for(self, n, timeout=20.0):
        deadline = time.monotonic() + timeout
        with self.cond:
            while len(self.events) < n and time.monotonic() < deadline:
                self.cond.wait(0.1)
            return list(self.events)


def _watch(informer):
    rec = _Recorder()
    informer.add_handler(on_add=rec.handler("add"), on_update=rec.handler("update"),
                         on_delete=rec.handler("delete"))
    return rec


def test_informer_sees_add_update_delete_in_order(api):
    client, cs = api
    inf = SharedInformer(client.pods, "default", "app=web")
    rec = _watch(inf)
    inf.start()
    try:
        assert inf.wait_for_sync(10)
        client.pods.create(to_dict(_pod("w")))
        other = to_dict(_pod("not-mine"))
        other["metadata"]["labels"] = {"app": "db"}
        client.pods.create(other)
        cur = client.pods.get("w")
        cur["metadata"]["labels"]["v"] = "2"
        client.pods.update(cur)
        cs.pods.delete("w", "default", grace_seconds=0)
        assert rec.wait_for(3) == [("add", "w", None), ("update", "w", "2"),
                                   ("delete", "w", "2")]
        assert inf.list() == []
    finally:
        inf.stop()


def test_informer_relists_after_a_cut_watch_and_reports_the_missed_delete(api):
    """The watch is cut, and the pod is deleted before the informer lists
    again: the relist dispatches the delete from the cache's difference."""
    client, cs = api
    factory = InformerFactory(client)
    inf = factory.informer("pods")
    assert factory.informer("pods") is inf
    rec = _watch(inf)
    gate = threading.Event()
    gate.set()
    listed = inf.client.list

    def gated_list(*a, **kw):
        assert gate.wait(20)
        return listed(*a, **kw)

    inf.client = type("Gated", (), {"list": staticmethod(gated_list),
                                    "watch": staticmethod(inf.client.watch),
                                    "resource": "pods"})()
    factory.start_all()
    try:
        assert factory.wait_for_sync(10)
        client.pods.create(to_dict(_pod("keep")))
        client.pods.create(to_dict(_pod("gone")))
        assert rec.wait_for(2) == [("add", "keep", None), ("add", "gone", None)]
        relists = inf.relists
        gate.clear()
        inf._stream.close()  # the watch is cut; the relist waits on the gate
        deadline = time.monotonic() + 10
        while inf._stream is not None and time.monotonic() < deadline:
            time.sleep(0.01)
        cs.pods.delete("gone", "default", grace_seconds=0)
        gate.set()
        got = rec.wait_for(4)
        assert inf.relists == relists + 1
        assert ("delete", "gone", None) in got[2:]
        assert {o["metadata"]["name"] for o in inf.list()} == {"keep"}
        client.pods.create(to_dict(_pod("after")))  # the new watch runs
        assert ("add", "after", None) in rec.wait_for(5)
    finally:
        gate.set()
        factory.stop_all()
