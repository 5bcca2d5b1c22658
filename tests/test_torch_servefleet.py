"""The port's servefleet against the JAX package's.

``SyntheticBackend`` answers the same requests with the same tokens,
buffered and streamed, exports the same metric names, and queues what
goes past its slots.  Then the rollout under traffic, as the JAX suite's
``TestRolloutUnderTraffic`` drives it: a JAX ``LocalCluster``, the port's
``ServeFleet`` and ``rolling_update`` over the port's apiserver client,
the JAX ``EndpointsBalancerSync`` over the fleet's resolver, and the
port's ``LoadGen`` through the balancer: the rollout completes with no
request failed and the PDB's floor held, once on synthetic backends and
once on ``DecodeServer(cfg=tiny(), device="cpu")`` backends, whose tokens,
before and after the rollout, are an in-process server's.  The
``torch-synthetic`` case runs the same rollout under the port's
apiserver, scheduler and controller manager as processes (``python -m
kubernetes1_tpu_torch <component>``) with two JAX kubelets in process, in
place of the ``LocalCluster``: the port's ReplicaSet controller, with its
expectations and its scale-down order, holds the PDB's floor.

Every wait has its own deadline, and the backends, balancer, informers
and cluster stop in ``finally``.
"""

import json
import re
import threading
import time
import urllib.request

import pytest

from kubernetes1_tpu.api import types as t
from kubernetes1_tpu.workloads import servefleet as jfleet
from kubernetes1_tpu_torch.client.informer import InformerFactory
from kubernetes1_tpu_torch.client.rest import Client
from kubernetes1_tpu_torch.workloads import llama, servefleet
from kubernetes1_tpu_torch.workloads.loadgen import LoadGen
from kubernetes1_tpu_torch.workloads.specs import pod_ready

APP = "fleet-serve"
PROMPTS = ([1, 2, 3], [9, 8], [42, 7, 100, 3, 250])


def _post(url, body, timeout=30.0):
    req = urllib.request.Request(url + "/generate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        if not body.get("stream"):
            return json.loads(resp.read())["tokens"]
        lines = [json.loads(line) for line in resp if line.strip()]
    assert lines[-1] == {"done": True}
    return [m["token"] for m in lines[:-1]]


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.read().decode()


def _metric_names(text):
    return {m.group(1) for m in re.finditer(r"^# TYPE (\w+)", text, re.M)}


@pytest.fixture()
def backends():
    ours = servefleet.SyntheticBackend(token_delay_s=0.001, slots=8).start()
    theirs = jfleet.SyntheticBackend(token_delay_s=0.001, slots=8).start()
    yield ours, theirs
    ours.stop()
    theirs.stop()


@pytest.mark.parametrize("stream", [False, True], ids=["buffered", "streamed"])
@pytest.mark.parametrize("body", [{"tokens": [1, 2, 3], "max_new": 5}, {"tokens": [200, 100]},
                                  {"max_new": 100}, {"tokens": [7], "max_new": 1}],
                         ids=["five", "default-eight", "capped", "one"])
def test_synthetic_backend_tokens_match_jax(backends, body, stream):
    ours, theirs = backends
    req = {**body, "stream": stream}
    assert _post(ours.url, req) == _post(theirs.url, req)


def test_synthetic_backend_surface_matches_jax(backends):
    ours, theirs = backends
    for b in (ours, theirs):
        _post(b.url, {"tokens": [1], "max_new": 2})
    assert _metric_names(_get(ours.url + "/metrics")) == \
        _metric_names(_get(theirs.url + "/metrics"))
    assert "ktpu_llama_slots_total 8.0" in _get(ours.url + "/metrics").splitlines()
    assert _get(ours.url + "/healthz") == _get(theirs.url + "/healthz")
    for b in (ours, theirs):
        req = urllib.request.Request(b.url + "/generate", data=b"not json")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 400
        e.value.close()
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(b.url + "/nothing", timeout=10)
        assert e.value.code == 404
        e.value.close()


@pytest.mark.parametrize("impl", [servefleet, jfleet], ids=["port", "jax"])
def test_requests_past_the_slots_queue(impl):
    """One slot, three requests of 10 tokens at 20 ms: they run one after
    another, and no more than one slot is ever leased."""
    b = impl.SyntheticBackend(token_delay_s=0.02, slots=1).start()
    try:
        seen, done = [], threading.Event()

        def watch():
            while not done.is_set():
                seen.append(b._active)
                time.sleep(0.005)

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        t0 = time.monotonic()
        threads = [threading.Thread(target=_post, args=(b.url, {"tokens": [i], "max_new": 10}))
                   for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        wall = time.monotonic() - t0
        done.set()
        watcher.join(timeout=5)
        assert max(seen) == 1
        assert wall >= 3 * 10 * 0.02 * 0.9
    finally:
        b.stop()


# ------------------------------------------------------- rollout under traffic


def _deployment(replicas):
    dep = t.Deployment()
    dep.metadata.name = APP
    dep.spec.replicas = replicas
    dep.spec.selector = t.LabelSelector(match_labels={"app": APP})
    dep.spec.template.metadata.labels = {"app": APP}
    c = t.Container(name="serve", image="llama-serve", command=["serve"])
    c.resources.requests = {"cpu": "10m"}
    dep.spec.template.spec.containers = [c]
    return dep


def _wait(what, fn, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = fn()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout} s waiting for {what}")


def _decode_factory(made):
    def make(pod):
        srv = llama.DecodeServer(cfg=llama.tiny(), seed=0, slots=4, device="cpu").start()
        made.append(srv)
        return srv
    return make


@pytest.fixture()
def no_disk_eviction(monkeypatch):
    """The in-process kubelets read no eviction signals: this test is
    about the fleet, and a host whose disk is nearly full would have them
    evict its pods (replaced by new ones) all through the rollout."""
    from kubernetes1_tpu.kubelet import eviction

    monkeypatch.setattr(eviction, "default_signals", lambda: {})


class _Pods:
    """A pods informer's handler registry, driven by hand."""

    def __init__(self):
        self.handlers = {}

    def informer(self, plural):
        return self

    def add_handler(self, on_add, on_update, on_delete):
        self.handlers = {"add": on_add, "update": on_update, "delete": on_delete}


def test_a_pod_deleted_while_its_backend_starts_gets_no_backend():
    """The delete arrives while the backend is being made: the fleet stops
    it as soon as it exists, and keeps no address for the gone pod."""
    pods = _Pods()
    release, made = threading.Event(), []

    def slow_backend(pod):
        assert release.wait(10)
        made.append(servefleet.SyntheticBackend().start())
        return made[-1]

    fleet = servefleet.ServeFleet(None, pods, APP, backend_factory=slow_backend)
    pod = {"metadata": {"name": "p", "namespace": "default", "uid": "u1",
                        "labels": {"app": APP}}, "status": {"phase": "Running"}}
    th = threading.Thread(target=pods.handlers["add"], args=(pod,))
    th.start()
    try:
        _wait("the backend to start building", lambda: "u1" in fleet._by_uid, 10)
        pods.handlers["delete"](pod)
    finally:
        release.set()
        th.join(timeout=10)
    assert not th.is_alive()
    assert fleet.backends() == [] and fleet.resolver("p", 0) is None
    assert (fleet.started, fleet.stopped) == (1, 1)
    with pytest.raises(OSError):
        _get(made[0].url + "/healthz")
    fleet.stop()


class _PortPlane:
    """The port's apiserver, scheduler and controller manager as processes
    and two JAX kubelets (FakeRuntime) in process: ``url``, ``cs`` (a JAX
    clientset) and ``stop()``, as a LocalCluster has them."""

    def __init__(self, tmp):
        from kubernetes1_tpu.client import Clientset as JaxClientset
        from kubernetes1_tpu.kubelet import FakeRuntime
        from tests.test_torch_gpu_cluster import (_kubelet, _port_controller_manager,
                                                  _port_scheduler, _PortApiserver)

        self.procs, self.kubelets = [], []
        try:
            self.procs.append(_PortApiserver(str(tmp / "apiserver.log")))
            self.url = self.procs[0].url
            self.cs = JaxClientset(self.url)
            self.procs.append(_port_scheduler(self.url, str(tmp / "scheduler.log")))
            self.procs.append(_port_controller_manager(self.url, str(tmp / "cm.log")))
            for i in range(2):
                self.kubelets.append(_kubelet(self.cs, f"node-{i}", FakeRuntime(),
                                              str(tmp / f"plugins{i}")))
                self.kubelets[-1].start()
            _wait("two Ready nodes", lambda: len([
                n for n in self.cs.nodes.list()[0] if any(
                    c.type == "Ready" and c.status == "True" for c in n.status.conditions)]) == 2,
                  30)
        except BaseException:
            self.stop()
            raise

    def stop(self):
        for kubelet in self.kubelets:
            kubelet.stop()
        for proc in reversed(self.procs):
            proc.stop()
        if getattr(self, "cs", None) is not None:
            self.cs.close()


@pytest.mark.usefixtures("no_disk_eviction")
@pytest.mark.parametrize("kind,plane", [("synthetic", "jax"), ("decode", "jax"),
                                        ("synthetic", "torch")],
                         ids=["synthetic", "decode", "torch-synthetic"])
def test_rolling_update_under_traffic_fails_no_request(kind, plane, tmp_path):
    from kubernetes1_tpu.client import InformerFactory as JaxInformerFactory
    from kubernetes1_tpu.localcluster import LocalCluster
    from kubernetes1_tpu.proxy import EndpointsBalancerSync, LeastInflightBalancer

    want_tokens = made = None
    if kind == "decode":
        ref = llama.DecodeServer(cfg=llama.tiny(), seed=0, device="cpu")
        try:
            want_tokens = [ref.generate(p, max_new=6) for p in PROMPTS]
        finally:
            ref.stop()
        made = []
    cluster = LocalCluster(nodes=2, tpus_per_node=4).start() if plane == "jax" \
        else _PortPlane(tmp_path)
    client = Client(cluster.url)
    factory = InformerFactory(client)
    jfactory = JaxInformerFactory(cluster.cs)
    fleet = bal = lg = None
    try:
        cs = cluster.cs
        cs.deployments.create(_deployment(3))
        svc = t.Service()
        svc.metadata.name = APP
        svc.spec.selector = {"app": APP}
        svc.spec.ports = [t.ServicePort(port=80)]
        cs.services.create(svc, "default")
        pdb = t.PodDisruptionBudget()
        pdb.metadata.name = f"{APP}-pdb"
        pdb.spec.selector = t.LabelSelector(match_labels={"app": APP})
        pdb.spec.min_available = 2
        cs.poddisruptionbudgets.create(pdb, "default")

        fleet = servefleet.ServeFleet(
            client, factory, APP,
            backend_factory=(servefleet.synthetic_factory(token_delay_s=0.002, slots=8)
                             if kind == "synthetic" else _decode_factory(made)))
        bal = LeastInflightBalancer(seed=0)
        EndpointsBalancerSync(bal, jfactory, "default", APP, resolver=fleet.resolver)
        factory.start_all()
        jfactory.start_all()
        assert factory.wait_for_sync(15) and jfactory.wait_for_sync(15)
        assert fleet.wait_backends(3, timeout=60) == 3
        _wait("the balancer's three backends", lambda: len(bal.stats()["backends"]) == 3, 30)
        if want_tokens is not None:
            for host, port in fleet.backends():
                assert [_post(f"http://{host}:{port}", {"tokens": p, "max_new": 6})
                        for p in PROMPTS] == want_tokens
        old = set(fleet.backends())

        lg = LoadGen(bal.url, qps=30, stream=True, seed=1).start()
        time.sleep(1.0)
        ru = servefleet.rolling_update(client, APP, timeout=90.0)
        time.sleep(1.0)
        lg.stop(drain_s=5.0)
        s = lg.summary()
        assert ru["completed"], ru
        assert s["failed"] == 0, s
        assert s["acked"] > 20, s
        # the PDB's floor (minAvailable 2 of 3) held all through
        assert ru["min_ready_observed"] >= 2, ru
        assert ru["replicas"] == 3 and set(ru) == {
            "completed", "duration_s", "min_ready_observed", "replicas", "poll_errors"}
        # the fleet settled: every Ready pod (all new) has a live backend, and
        # every other backend, old or of a surge pod the controllers ran
        # beside the rollout's, has stopped
        new = _wait("the fleet to settle on the new pods", lambda: fleet.settled(3, old), 30)
        assert fleet.started >= 6
        if want_tokens is not None:
            assert len(made) == fleet.started
            for host, port in new:
                assert [_post(f"http://{host}:{port}", {"tokens": p, "max_new": 6})
                        for p in PROMPTS] == want_tokens
        # each Ready pod's scrape annotation names its own backend (a surge
        # pod deleted before its annotation landed counts an annotate error)
        pods = [p for p in client.pods.list("default", f"app={APP}")[0]
                if pod_ready(p)]
        assert {("127.0.0.1", int(p["metadata"]["annotations"]["obs.ktpu.io/scrape-port"]))
                for p in pods} == new
    finally:
        if lg is not None:
            lg.stop(drain_s=0.5)
        if bal is not None:
            bal.stop()
        factory.stop_all()
        jfactory.stop_all()
        if fleet is not None:
            fleet.stop()
        client.close()
        cluster.stop()
