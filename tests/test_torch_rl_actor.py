"""The port's rl_actor against the JAX package's.

``rollout`` gives JAX's arms and rewards bit for bit; ``reinforce_update``
(torch, float64) follows JAX's numpy loop over 60 batches within 1e-12;
the port's ``Learner(device="cpu")`` and ``run_actor`` meet the JAX
suite's loop checks, paired with each other and across with JAX's; the
spec builders' dicts pass the JAX apiserver and are the JAX builders'
``to_dict`` apart from the command and the ``nvidia.com/gpu`` ask; a gang
``learner_job`` of two workers runs on a fake two-card node through the
port's plugin, a card each; and ``ChurnDriver`` over the port's client
churns a hollow JAX ``LocalCluster`` and the port's own (batched and
singleton, one and two workers) with JAX's result keys, no error and
nothing left, and with a card an actor leaves every card free again.
"""

import json
import os
import subprocess
import sys
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from kubernetes1_tpu.apiserver import Master
from kubernetes1_tpu.client import Clientset
from kubernetes1_tpu.kubelet import FakeRuntime, ProcessRuntime
from kubernetes1_tpu.machinery.scheme import to_dict
from kubernetes1_tpu.utils.waitutil import must_poll_until
from kubernetes1_tpu.workloads import rl_actor as jrl
from kubernetes1_tpu_torch import GPU_RESOURCE
from kubernetes1_tpu_torch.client.rest import Client
from kubernetes1_tpu_torch.workloads import rl_actor, specs
from tests.test_torch_gpu_cluster import H100, _cards, _kubelet, _plugin, control_plane  # noqa: F401

WEIGHTS = [np.zeros(8), np.linspace(-1.0, 2.0, 8), np.array([3.0, -2.0, 0.5, 0.0, 1.0]),
           np.full(8, 7.5)]


@pytest.mark.parametrize("seed", [0, 1, 17, 100003])
@pytest.mark.parametrize("w", WEIGHTS, ids=["zeros", "ramp", "five-arms", "flat"])
def test_rollout_equals_jax_bit_for_bit(w, seed):
    assert rl_actor.rollout(w, steps=64, seed=seed) == jrl.rollout(w, steps=64, seed=seed)
    assert rl_actor.rollout(list(w), steps=7, seed=seed) == jrl.rollout(w, steps=7, seed=seed)


def test_reinforce_trajectory_follows_jax_over_60_batches():
    w_jax = np.zeros(8)
    w = torch.zeros(8, dtype=torch.float64)
    for i in range(60):
        batch = jrl.rollout(w_jax, steps=64, seed=i)
        w_jax, b_jax = jrl.reinforce_update(w_jax, batch)
        w, b = rl_actor.reinforce_update(w, batch)
        assert w.dtype == torch.float64 and w.device.type == "cpu"
        assert b == b_jax
        assert np.abs(w.numpy() - w_jax).max() <= 1e-12, i
    assert w[7] > w[0]


def test_reinforce_update_edges():
    w = torch.tensor([0.5, -0.5], dtype=torch.float64)
    got, mean = rl_actor.reinforce_update(w, {})
    assert torch.equal(got, w) and got is not w and mean == 0.0
    for bad in ({"arms": [0, 2], "rewards": [1.0, 0.0]}, {"arms": [-1], "rewards": [1.0]},
                {"arms": [0, 1], "rewards": [1.0]}, {"arms": ["x"], "rewards": [1.0]}):
        with pytest.raises(ValueError):
            rl_actor.reinforce_update(w, bad)


def _metric(url, name):
    with urllib.request.urlopen(url + "/metrics", timeout=5) as r:
        for line in r.read().decode().splitlines():
            if line.startswith(name + " "):
                return float(line.split()[1])
    return None


@pytest.mark.parametrize("actor", ["port", "jax"])
def test_learner_and_actor_loop(actor):
    """The JAX suite's loop checks, the port's learner with either actor."""
    run_actor = rl_actor.run_actor if actor == "port" else jrl.run_actor
    learner = rl_actor.Learner(port=0, device="cpu").start()
    try:
        out = run_actor(learner.url, lifetime_s=0.4, steps_per_batch=32, interval_s=0.01)
        assert out["batches_sent"] > 0
        assert out["errors"] == 0
        stats = learner.stats()
        assert stats["batches"] == out["batches_sent"]
        assert stats["frames"] == out["frames"]
        assert stats["updates"] > 0
        assert _metric(learner.url, "ktpu_rl_ingest_total") == stats["batches"]
        with urllib.request.urlopen(learner.url + "/weights", timeout=5) as r:
            weights = json.loads(r.read())["weights"]
        assert len(weights) == 8 and all(isinstance(x, float) for x in weights)
        assert [round(x, 4) for x in weights] == stats["weights"]
    finally:
        learner.stop()


def test_port_actor_feeds_the_jax_learner():
    learner = jrl.Learner(port=0).start()
    try:
        out = rl_actor.run_actor(learner.url, lifetime_s=0.4, steps_per_batch=32,
                                 interval_s=0.01)
        assert out["batches_sent"] > 0 and out["errors"] == 0
        assert learner.stats()["batches"] == out["batches_sent"]
    finally:
        learner.stop()


@pytest.mark.parametrize("given, want", [(None, "1"), ("4", "4")])
def test_the_actor_main_caps_the_blas_pool_unless_told(monkeypatch, given, want):
    """An actor under churn lives a second or two: its main caps numpy's
    OpenBLAS pool at one thread unless its environment sizes the pool."""
    monkeypatch.setenv("OPENBLAS_NUM_THREADS", "8")  # so that teardown restores the original
    if given is None:
        monkeypatch.delenv("OPENBLAS_NUM_THREADS")
    else:
        monkeypatch.setenv("OPENBLAS_NUM_THREADS", given)
    monkeypatch.setenv("KTPU_LEARNER_ADDR", "http://127.0.0.1:9")
    rl_actor.main(["--actor", "--lifetime", "0"])
    assert os.environ["OPENBLAS_NUM_THREADS"] == want


def test_learner_refuses_a_bad_batch_and_counts_it():
    learner = rl_actor.Learner(port=0, device="cpu").start()
    try:
        for body in (b"not json", b'{"arms": [9], "rewards": [1.0]}', b'[1, 2]'):
            req = urllib.request.Request(learner.url + "/experience", data=body)
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=5)
            assert e.value.code == 400
            e.value.close()
        assert learner.stats()["batches"] == 0
        assert _metric(learner.url, "ktpu_rl_ingest_errors_total") == 2.0
        assert _metric(learner.url, "ktpu_rl_ingest_total") == 0.0
    finally:
        learner.stop()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is visible")
def test_learner_raises_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rl_actor.Learner()


def test_module_imports_no_torch_and_the_learner_main_names_its_device():
    env = {**os.environ, "PYTHONPATH": specs.REPO_ROOT}
    code = ("import sys, kubernetes1_tpu_torch.workloads.rl_actor; "
            "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=60, check=True).stdout
    assert out.strip() == "False"
    proc = subprocess.Popen([sys.executable, "-m", rl_actor.MODULE, "--learner", "--device",
                             "cpu", "--port", "0"], env=env, stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
    finally:
        proc.kill()
        proc.wait(timeout=10)
        proc.stdout.close()
    assert line.startswith("learner serving on http://127.0.0.1:") and \
        line.rstrip().endswith(" on cpu"), line


# ---------------------------------------------------------------- builders


def _port_command(d):
    return ["python", "-m", rl_actor.MODULE] + d[3:]


def test_builders_are_the_jax_builders_but_for_command_and_card():
    pod = rl_actor.actor_pod(3, gen=2, learner_addr="http://x:1", lifetime_s=5.0)
    want = to_dict(jrl.actor_pod(3, gen=2, learner_addr="http://x:1", lifetime_s=5.0))
    c = want["spec"]["containers"][0]
    c["command"] = _port_command(c["command"])
    assert pod == want
    assert rl_actor.fleet_service("rl-actors") == to_dict(jrl.fleet_service("rl-actors"))
    for kw in ({"workers": 2, "scrape_port": 9, "scrape_host": "h"},
               {"name": "l", "ns": "rl", "workers": 1, "gang": False}):
        job = rl_actor.learner_job(gpus_per_worker=0, **kw)
        want = to_dict(jrl.learner_job(tpus_per_worker=0, **kw))
        c = want["spec"]["template"]["spec"]["containers"][0]
        c["command"] = _port_command(c["command"])
        assert job == want


def test_builders_ask_for_cards_in_the_pod_level_form():
    pod = rl_actor.actor_pod(0, gpus=2)
    assert pod["spec"]["extendedResources"] == [
        {"name": "actor-0-g0-gpu", "resource": GPU_RESOURCE, "quantity": 2}]
    assert pod["spec"]["containers"][0]["extendedResourceRequests"] == ["actor-0-g0-gpu"]
    tmpl = rl_actor.learner_job()["spec"]["template"]["spec"]
    assert tmpl["extendedResources"] == [{"name": "gpu", "resource": GPU_RESOURCE,
                                          "quantity": 1}]
    assert tmpl["containers"][0]["extendedResourceRequests"] == ["gpu"]
    assert "resources" not in tmpl["containers"][0]  # no container limit: ResourceV2 refuses it


def test_builders_pass_the_jax_apiserver():
    master = Master().start()
    client = Client(master.url)
    cs = Clientset(master.url)
    try:
        client.pods.create(rl_actor.actor_pod(0, gpus=1, learner_addr="http://x:1"))
        client.jobs.create(rl_actor.learner_job(workers=2))
        client.services.create(rl_actor.fleet_service("rl-actors"))
        pod = cs.pods.get("actor-0-g0", "default")
        assert pod.spec.extended_resources[0].resource == GPU_RESOURCE
        assert cs.jobs.get("rl-learner", "default").spec.gang_scheduling
        assert cs.services.get("rl-actors", "default").spec.ports[0].port == rl_actor.LEARNER_PORT
    finally:
        client.close()
        cs.close()
        master.stop()


# ------------------------------------------------------------- on fake cards


@pytest.fixture()
def two_card_node(request, control_plane, tmp_path):  # noqa: F811
    """One node with two fake H100s behind the port's plugin: a
    ProcessRuntime node, or a FakeRuntime (hollow) one with the parameter
    ``hollow``."""
    master, cs = control_plane
    plugin_dir = str(tmp_path / "plugins")
    plugin = _plugin(plugin_dir, f"{H100}:2:nv0:0")
    hollow = getattr(request, "param", "process") == "hollow"
    runtime = FakeRuntime() if hollow else ProcessRuntime(root_dir=str(tmp_path / "ktpu"))
    kubelet = _kubelet(cs, "gpu-node-0", runtime, plugin_dir)
    kubelet.start()
    must_poll_until(lambda: len(_cards(cs, "gpu-node-0")) == 2, timeout=20.0,
                    desc="gpu-node-0 advertises its two cards")
    client = Client(master.url)
    yield {"master": master, "cs": cs, "client": client}
    client.close()
    kubelet.stop()
    if not hollow:
        runtime.kill_all()
    plugin.stop()


def _pod_envs(marker):
    """The environment of every process whose KTPU_APISERVER is ``marker``
    (the kubelet sets it in each pod)."""
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                env = dict(kv.split("=", 1) for kv in f.read().decode(errors="replace")
                           .split("\0") if "=" in kv)
        except OSError:
            continue
        if env.get("KTPU_APISERVER") == marker:
            out.append(env)
    return out


def test_gang_learner_job_runs_a_card_a_worker(two_card_node):
    client, master = two_card_node["client"], two_card_node["master"]
    job = rl_actor.learner_job(workers=2, gpus_per_worker=1, gang=True)
    c = job["spec"]["template"]["spec"]["containers"][0]
    # the learner on the CPU (no card here), on a port of its own
    c["command"] = [sys.executable, "-m", rl_actor.MODULE, "--learner", "--device", "cpu",
                    "--port", "0"]
    c["env"] = [specs.pythonpath_env()]
    client.jobs.create(job)

    def running():
        pods, _ = client.pods.list("default", f"app={rl_actor.LEARNER_APP_LABEL}")
        return len(pods) == 2 and all((p.get("status") or {}).get("phase") == "Running"
                                      for p in pods) and pods

    pods = None
    deadline = time.monotonic() + 60
    while not pods and time.monotonic() < deadline:
        pods = running()
        time.sleep(0.1)
    assert pods, client.pods.list("default")[0]
    cards = [p["spec"]["extendedResources"][0].get("assigned") for p in pods]
    assert sorted(c[0] for c in cards) == ["nv0-h0-gpu0", "nv0-h0-gpu1"], cards
    assert len({p["spec"].get("schedulingGang") for p in pods}) == 1
    must_poll_until(lambda: len(_pod_envs(master.url)) == 2, timeout=30.0,
                    desc="both learner processes")
    assert sorted(env.get("CUDA_VISIBLE_DEVICES") for env in _pod_envs(master.url)) == ["0", "1"]
    client.jobs.delete("rl-learner")  # its pods go with it; the fixture kills their processes


@pytest.fixture()
def no_disk_eviction(monkeypatch):
    """The in-process kubelets (JAX's and the port's) read no eviction
    signals: a host whose disk is nearly full would have them evict the
    actors under the churn."""
    from kubernetes1_tpu.kubelet import eviction
    from kubernetes1_tpu_torch.kubelet import kubelet as tkubelet

    monkeypatch.setattr(eviction, "default_signals", lambda: {})
    monkeypatch.setattr(tkubelet, "default_signals", lambda: {})


def _churn_on(cluster, use_batch, workers):
    """ChurnDriver over the port's client on a started hollow cluster."""
    client = Client(cluster.url)
    driver = None
    try:
        cluster.wait_ready(60)
        client.services.create(rl_actor.fleet_service("rl-actors"))
        driver = rl_actor.ChurnDriver(client, actors=6, rate=20.0, use_batch=use_batch,
                                      grace_seconds=0)
        driver.start(ready_timeout=60.0)
        res = driver.run(duration=3.0, workers=workers)
        # JAX's result keys (JAX's ChurnDriver reads only its clientset's
        # pods client, to make an informer it never starts here)
        want_keys = set(jrl.ChurnDriver(types.SimpleNamespace(pods=None)).result())
        assert set(res) == want_keys
        assert res["mode"] == ("batched" if use_batch else "singleton")
        assert res["create_errors"] == 0 and res["delete_errors"] == 0, res
        assert res["recycles_completed"] > 0 and res["ops"] == res["creates"] + res["deletes"]
        deadline = time.monotonic() + 30
        live = None
        while time.monotonic() < deadline:
            live = rl_actor.ready_fleet_ips(client)
            if live is not None and rl_actor.service_endpoint_ips(client, "rl-actors") == live:
                break
            time.sleep(0.2)
        assert live and rl_actor.service_endpoint_ips(client, "rl-actors") == live
        assert driver.drain()
        assert client.pods.list("default", f"app={rl_actor.ACTOR_APP_LABEL}")[0] == []
    finally:
        if driver is not None:
            driver.stop()
        client.close()
        cluster.stop()


@pytest.mark.usefixtures("no_disk_eviction")
@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("use_batch", [True, False], ids=["batched", "singleton"])
def test_churn_driver_on_a_hollow_cluster(use_batch, workers):
    from kubernetes1_tpu.localcluster import LocalCluster

    _churn_on(LocalCluster(nodes=2, hollow=True, sync_interval=0.1).start(), use_batch, workers)


@pytest.mark.usefixtures("no_disk_eviction")
@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("use_batch", [True, False], ids=["batched", "singleton"])
def test_churn_driver_on_the_ports_hollow_cluster(use_batch, workers):
    """The same churn on the port's own LocalCluster: its apiserver,
    scheduler, controller manager and hollow kubelets, nothing of JAX."""
    from kubernetes1_tpu_torch.localcluster import LocalCluster

    _churn_on(LocalCluster(nodes=2, sync_interval=0.1, obs=False).start(),
              use_batch, workers)


def test_a_churn_workers_error_reaches_the_caller(monkeypatch):
    """run(workers=2): an error that ends one worker thread is raised by
    run, as the single worker's would be, not lost with the thread."""
    driver = rl_actor.ChurnDriver(Client("http://127.0.0.1:1"), actors=4)

    def worker(slots, rate, duration, tick, t0):
        if slots[0]["slot"] == 1:
            raise RuntimeError("worker 1 broke")

    monkeypatch.setattr(driver, "_run_worker", worker)
    with pytest.raises(RuntimeError, match="worker 1 broke"):
        driver.run(duration=0.1, workers=2)


@pytest.mark.parametrize("two_card_node", ["hollow"], indirect=True)
def test_churn_with_a_card_an_actor_frees_every_card(two_card_node):
    client, master = two_card_node["client"], two_card_node["master"]
    driver = rl_actor.ChurnDriver(client, actors=2, rate=8.0, gpus_per_actor=1,
                                  grace_seconds=0)
    try:
        driver.start(ready_timeout=60.0)
        res = driver.run(duration=3.0)
        assert res["create_errors"] == 0 and res["delete_errors"] == 0, res
        assert res["recycles_completed"] > 0, res
        assert driver.drain()
    finally:
        driver.stop()
    reg = master.registry
    must_poll_until(lambda: not reg._device_claims, timeout=10.0, desc="the claims released")
    # both cards at once for one pod: nothing of the churn holds either
    probe = {"metadata": {"name": "both-cards"},
             "spec": specs.gpu_request({"containers": [{"name": "c", "image": "i"}]}, 2)}
    client.pods.create(probe)
    must_poll_until(lambda: (client.pods.get("both-cards").get("status") or {}).get("phase")
                    == "Running", timeout=30.0, desc="a pod on both cards")
    assert sorted(client.pods.get("both-cards")["spec"]["extendedResources"][0]["assigned"]) \
        == ["nv0-h0-gpu0", "nv0-h0-gpu1"]
    client.pods.delete("both-cards", grace_seconds=0)
