"""The port's ``LocalCluster`` and ``kubemark`` (``kubernetes1_tpu_torch/
localcluster.py``, ``kubemark.py``) on the CPU.

Two hollow nodes (the port's kubelet on a ``FakeRuntime``, each with the
port's GPU plugin in fake mode): both Ready with their ``nvidia.com/gpu``
cards (ResourceV2's device list), a Deployment's pods Running, a NodePort Service whose node port
the cluster's ``Proxier`` serves (spliced to an HTTP server the test runs
at the pods' target port: a hollow pod runs nothing), every component the
``ObsCollector`` scrapes up with the scheduler's e2e histogram in the
fleet's /metrics, the startup SLI tracker holding the pods, and ``stop()``
leaving no thread or socket (the conftest's guards).  ``real_gpu=True``
without a card advertises no card and never falls back to fake ones.
Then ``python -m kubernetes1_tpu_torch.kubemark`` registering K hollow
nodes against the port's apiserver and exiting 0 on SIGTERM.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from kubernetes1_tpu_torch import GPU_RESOURCE
from kubernetes1_tpu_torch.apiserver import Master
from kubernetes1_tpu_torch.client.rest import Client
from kubernetes1_tpu_torch.kubelet import kubelet as tkubelet
from kubernetes1_tpu_torch.localcluster import LocalCluster, free_node_port
from kubernetes1_tpu_torch.obs import aggregate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def no_disk_eviction(monkeypatch):
    """The hollow kubelets read no eviction signals: a host whose disk is
    nearly full would have them evict the pods under test."""
    monkeypatch.setattr(tkubelet, "default_signals", lambda: {})


def _wait(what, fn, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = fn()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout} s waiting for {what}")


class _Answer:
    """The pods' server: answers every GET with its name."""

    def __init__(self):
        class _H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                body = b'{"served-by": "hollow-web"}'
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), _H)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self._th = threading.Thread(target=self.httpd.serve_forever,
                                    kwargs={"poll_interval": 0.05}, daemon=True)
        self._th.start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self._th.join(timeout=5)


def _cards(node):
    """The node's advertised cards: ResourceV2 lists each device on the
    node's status.extendedResources, not as a capacity count."""
    return len((node["status"].get("extendedResources") or {}).get(GPU_RESOURCE) or [])


def _ready(node):
    return any(c["type"] == "Ready" and c["status"] == "True"
               for c in node["status"].get("conditions") or [])


@pytest.mark.usefixtures("no_disk_eviction")
def test_hollow_cluster_serves_a_node_port_and_its_obs_plane():
    answer = _Answer()
    cluster = LocalCluster(nodes=2, gpus_per_node=4, obs_interval=0.2)
    client = None
    try:
        cluster.start().wait_ready(30)
        client = Client(cluster.url)
        nodes = _wait("both nodes Ready with their cards", lambda: (
            lambda ns: ns if len(ns) == 2 else None)([
                n for n in client.nodes.list("")[0]
                if _cards(n) == 4 and _ready(n)]))
        assert sorted(n["metadata"]["name"] for n in nodes) == ["node-0", "node-1"]

        client.deployments.create({
            "metadata": {"name": "web", "namespace": "default"},
            "spec": {"replicas": 2, "selector": {"matchLabels": {"app": "web"}},
                     "template": {"metadata": {"labels": {"app": "web"}},
                                  "spec": {"containers": [{"name": "c", "image": "web",
                                                           "command": ["serve"]}]}}}},
            "default")
        node_port = free_node_port()
        client.services.create({
            "metadata": {"name": "web", "namespace": "default"},
            "spec": {"type": "NodePort", "selector": {"app": "web"},
                     "ports": [{"port": 80, "targetPort": answer.port,
                                "nodePort": node_port}]}}, "default")
        running = _wait("the Deployment's two pods Running", lambda: (
            lambda ps: ps if len(ps) == 2 else None)([
                p for p in client.pods.list("default", "app=web")[0]
                if (p.get("status") or {}).get("phase") == "Running"]))
        assert {p["spec"]["nodeName"] for p in running} <= {"node-0", "node-1"}

        _wait("the Proxier's node port", lambda: cluster.proxier.node_port_for(
            "default", "web") == node_port)
        _wait("the Endpoints behind it", lambda: cluster.proxier._proxies[
            ("default", "web", "")].backends)
        with urllib.request.urlopen(f"http://127.0.0.1:{node_port}/", timeout=10) as r:
            assert json.loads(r.read()) == {"served-by": "hollow-web"}
        assert cluster.proxier.stats()["connections"] >= 1

        _wait("every obs target up", lambda: all(
            i["up"] for i in cluster.obs.topology()["instances"]))
        topo = cluster.obs.topology()
        assert sorted(i["instance"] for i in topo["instances"]) == [
            "apiserver-0", "node-0", "node-1", "sched-0", "sli-0"]
        assert all(i["errors"] == 0 for i in topo["instances"])
        merged = _wait("the scheduler's binds in the fleet's /metrics", lambda: (
            lambda m: m if aggregate.select(m, "scheduler_e2e_scheduling_seconds_bucket",
                                            le="+Inf") and
            list(aggregate.select(m, "scheduler_e2e_scheduling_seconds_bucket",
                                  le="+Inf").values())[0] >= 2 else None)(
            aggregate.parse_metrics_text(cluster.obs.render_fleet_metrics())))
        assert aggregate.select(merged, "ktpu_obs_scrape_up", instance="sched-0")
        report = _wait("the startup SLIs of both pods", lambda: (
            lambda r: r if r.get("total", {}).get("count", 0) >= 2 else None)(
            cluster.sli.report()))
        assert report["scheduled"]["count"] >= 2
    finally:
        if client is not None:
            client.close()
        cluster.stop()
        answer.stop()
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{node_port}/", timeout=2)


@pytest.mark.usefixtures("no_disk_eviction")
def test_real_gpu_node_without_a_card_advertises_none(monkeypatch):
    """node 0 of ``real_gpu=True`` takes the cards discovery finds (none on
    this host) and never fake ones; its plugin is not started."""
    from kubernetes1_tpu_torch import localcluster

    monkeypatch.setattr(localcluster, "discover_gpu_devices", lambda: [])
    cluster = LocalCluster(nodes=2, gpus_per_node=2, real_gpu=True, obs=False)
    try:
        cluster.start().wait_ready(30)
        assert cluster.nodes[0].plugin is None and cluster.nodes[1].plugin is not None
        assert type(cluster.nodes[0].kubelet.runtime).__name__ == "ProcessRuntime"
        assert type(cluster.nodes[1].kubelet.runtime).__name__ == "FakeRuntime"
        got = _wait("node-1's cards", lambda: cluster.cs.nodes.get("node-1", "").status
                    .extended_resources.get(GPU_RESOURCE))
        assert len(got) == 2
        assert not cluster.cs.nodes.get("node-0", "").status.extended_resources.get(GPU_RESOURCE)
        assert cluster.obs is None
    finally:
        cluster.stop()


def test_kubemark_process_registers_hollow_nodes_and_exits_0_on_sigterm():
    root = tempfile.mkdtemp(prefix="km-")  # short: the plugins' unix sockets live under it
    master = Master().start()
    client = Client(master.url)
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubernetes1_tpu_torch.kubemark", "--server", master.url,
         "--count", "3", "--index-base", "5", "--gpus-per-node", "2",
         "--heartbeat-interval", "0.5", "--sync-interval", "0.2",
         "--root-dir", root],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": REPO})
    try:
        nodes = _wait("three hollow nodes with their cards", lambda: (
            lambda ns: ns if len(ns) == 3 else None)([
                n for n in client.nodes.list("")[0]
                if _cards(n) == 2]), 60)
        assert sorted(n["metadata"]["name"] for n in nodes) == [
            "hollow-5", "hollow-6", "hollow-7"]
        domains = {d["attributes"].get("nvidia.com/gpu/nvlink-domain")
                   for n in nodes for d in n["status"]["extendedResources"][GPU_RESOURCE]}
        assert domains == {"nvl-0"}
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
        assert proc.returncode == 0, out
        assert "kubemark worker: 3 hollow nodes up (hollow-5..hollow-7)" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=10)
        client.close()
        master.stop()
        shutil.rmtree(root, ignore_errors=True)
