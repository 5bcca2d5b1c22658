"""Multi-card, multi-worker Jobs in the port, on the CPU.

The chain that starts an Indexed Job's workers: the JAX package's
unchanged Job controller stamps each pod with its completion index, the
coordinator ``<job>-0.<ns>:8476`` and every worker's name
(``tpu.ktpu.io/*``); the port's device plugin (the Python one and
``ktpu-gpu-plugin``) turns them into ``RANK``, ``LOCAL_RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``; the pod launcher
(``workloads.launch``) finds the coordinator's address (by name, else its
pod's podIP from the apiserver) and execs torchrun with one process a
card.  Here:

- an Indexed gang Job of 2 workers x 1 fake card through the JAX Job
  controller, scheduler and kubelet: each pod's process holds its rank,
  the world and the coordinator, with each plugin; and the same under the
  port's apiserver, scheduler and controller manager (processes, the JAX
  kubelet), whose Job controller writes the ``gpu.ktpu.io/*`` keys alone,
  which both plugins read;
- BASELINE configs 4 and 5 (``examples/gpu-bert-large-4x8-h100.yaml``,
  ``examples/gpu-llama3-8b-32x8-h100-preemptible.yaml``) applied on
  hollow nodes of fake cards, scaled down as ``tests/test_examples_e2e.py``
  scales the TPU pair, with each plugin: the gang placed all or nothing,
  on cards of the asked model only, ranks 0..N-1 of world N; Llama's
  priority, gang and checkpoint claim;
- config 4 run end to end at 2 workers x 2 fake cards on two
  process-runtime nodes, its module's arguments overridden to ``--config
  tiny --device cpu``: both launchers form one gloo world of 4, and rank
  0's loss is one process's f32 ``train_demo`` over the whole batch within
  1e-5 (the bar of ``tests/test_torch_sharding.py``'s data-parallel step);
- the launcher alone: k, resolution by name and through the apiserver, a
  coordinator that never appears and a world that never forms ending it
  non-zero within ``--timeout``, a pod alone as a world of one;
- ``sharding.init_from_env`` refusing the plugin's env in a process that
  sees more cards, and ``specs.payload_job`` going through the launcher.

No test sets ``RANK``, ``WORLD_SIZE`` or ``MASTER_ADDR``: a pod's come
from the plugin, given the annotations that the Job controller writes.
Every wait has its own deadline.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading
import time

import pytest
import torch
import yaml

from kubernetes1_tpu.api import types as t
from kubernetes1_tpu.apiserver import Master
from kubernetes1_tpu.machinery.scheme import from_dict
from kubernetes1_tpu.utils.waitutil import must_poll_until, poll_until
from kubernetes1_tpu_torch import GPU_RESOURCE
from kubernetes1_tpu_torch.deviceplugin import gpu_plugin as gp
from kubernetes1_tpu_torch.workloads import bert as tbert
from kubernetes1_tpu_torch.workloads import launch, sharding, specs
from kubernetes1_tpu_torch.workloads import llama as tllama
from tests.test_torch_gpu_cluster import (  # noqa: F401
    A100, H100, control_plane, native_bins, nodes)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
BERT_YAML = "gpu-bert-large-4x8-h100.yaml"
LLAMA_YAML = "gpu-llama3-8b-32x8-h100-preemptible.yaml"
DIST_ENV = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
F32_TOL = 1e-5


BOTH_PLUGINS = pytest.mark.parametrize("nodes", ["python", "native"], indirect=True)


def _job_pods(client, job):
    return client.pods.list("default", f"batch.ktpu.io/job-name={job}")[0]


def _succeeded(client, job, n):
    return ((client.jobs.get(job).get("status") or {}).get("succeeded") or 0) >= n


def _failed_scheduling(client, pod):
    return [e for e in client.events.list("default")[0]
            if (e.get("involvedObject") or {}).get("name") == pod
            and e.get("reason") == "FailedScheduling"]


# ------------------------------------------------ the Job controller's chain


@pytest.mark.parametrize("control_plane,nodes", [
    ("jax", "python"), ("jax", "native"), ("torch", "python"), ("torch", "native")],
    indirect=True, ids=["python", "native", "torch-python", "torch-native"])
def test_indexed_gang_job_workers_get_rank_world_and_coordinator(control_plane, nodes):
    """An Indexed gang Job of 2 workers x 1 card: each pod's process holds
    RANK = its completion index, LOCAL_RANK 0, WORLD_SIZE 2 and the
    coordinator <job>-0.<ns>:8476, from the Job controller's annotations
    through the plugin: the JAX controller's tpu.ktpu.io keys, or under the
    port's control plane (``torch``) the gpu.ktpu.io keys alone."""
    nodes.add("gpu-node-0", f"{H100}:1:nv0:0")
    nodes.add("gpu-node-1", f"{H100}:1:nv1:1")
    out = nodes.tmp / "envs"
    out.mkdir()
    code = (f"import json, os; open(os.path.join({str(out)!r}, os.environ['INDEX'] + '.json'), "
            f"'w').write(json.dumps({{k: os.environ.get(k) for k in {DIST_ENV!r}}}))")
    pod_spec = {"containers": [{
        "name": "main", "image": "ktpu/torch-workload", "command": [sys.executable, "-c", code],
        "env": [{"name": "INDEX", "valueFrom": {"fieldRef": {
            "fieldPath": f"metadata.annotations['{t.COMPLETION_INDEX_ANNOTATION}']"}}}]}],
        "restartPolicy": "Never"}
    specs.gpu_request(pod_spec, 1)
    nodes.client.jobs.create({
        "metadata": {"name": "ranks", "namespace": "default"},
        "spec": {"completionMode": "Indexed", "completions": 2, "parallelism": 2,
                 "gangScheduling": True, "backoffLimit": 0,
                 "template": {"metadata": {"labels": {"app": "ranks"}}, "spec": pod_spec}}})
    must_poll_until(lambda: _succeeded(nodes.client, "ranks", 2), timeout=90.0,
                    desc="both workers ran to their end")
    pods = _job_pods(nodes.client, "ranks")
    assert sorted(p["spec"]["nodeName"] for p in pods) == ["gpu-node-0", "gpu-node-1"]
    for p in pods:
        index = p["metadata"]["annotations"][t.COMPLETION_INDEX_ANNOTATION]
        env = json.loads((out / f"{index}.json").read_text())
        assert env == {"RANK": index, "LOCAL_RANK": "0", "WORLD_SIZE": "2",
                       "MASTER_ADDR": "ranks-0.default", "MASTER_PORT": "8476"}, (index, env)
        ann = p["metadata"]["annotations"]
        ours, theirs = (sorted(k for k in ann if k.startswith(f"{pre}.ktpu.io/worker")
                               or k.startswith(f"{pre}.ktpu.io/coordinator"))
                        for pre in ("gpu", "tpu"))
        stamps = ["coordinator-address", "worker-hostnames", "worker-id"]
        if not isinstance(control_plane[0], Master):  # the port's apiserver process
            assert ours == [f"gpu.ktpu.io/{k}" for k in stamps] and not theirs, ann
        else:
            assert theirs == [f"tpu.ktpu.io/{k}" for k in stamps] and not ours, ann


# ------------------------------------------------ the manifests on fake cards


def _manifest(name):
    with open(os.path.join(EXAMPLES, name)) as f:
        return [d for d in yaml.safe_load_all(f) if d]


def _wire(doc):
    return {k: v for k, v in doc.items() if k not in ("kind", "apiVersion")}


def _scale(job, workers, cards):
    """The Job at ``workers`` x ``cards``, the rest as the manifest has it."""
    job["spec"]["completions"] = job["spec"]["parallelism"] = workers
    job["spec"]["template"]["spec"]["extendedResources"][0]["quantity"] = cards
    return job


def _container_envs(runtimes):
    """{pod name: the env its container was started with}, over hollow runtimes."""
    out = {}
    for rt in runtimes:
        pods = {sb.id: sb.pod_name for sb in rt.list_pod_sandboxes()}
        for c in rt.list_containers():
            if c.sandbox_id in pods:
                out[pods[c.sandbox_id]] = rt.configs[c.id].env
    return out


def _check_workers(nodes, job, workers, cards, runtimes, h100_nodes):
    """Every worker on its own H100 node with ``cards`` cards of that node,
    all of the asked model, and its process's env rank = its index of
    world ``workers``, the coordinator the index-0 worker."""
    pods = _job_pods(nodes.client, job)
    assert len(pods) == workers
    envs = _container_envs(runtimes)
    placed = set()
    for p in pods:
        node = p["spec"]["nodeName"]
        assert node in h100_nodes
        placed.add(node)
        per = p["spec"]["extendedResources"][0]
        assert (per["resource"], per["quantity"], len(per["assigned"])) == (
            GPU_RESOURCE, cards, cards)
        devs = {d["id"]: d for d in nodes.client.nodes.get(node)["status"][
            "extendedResources"][GPU_RESOURCE]}
        assert {devs[c]["attributes"][gp.ATTR_GPU_MODEL] for c in per["assigned"]} == {H100}
        index = p["metadata"]["annotations"][t.COMPLETION_INDEX_ANNOTATION]
        env = envs[p["metadata"]["name"]]
        assert {k: env.get(k) for k in DIST_ENV} == {
            "RANK": index, "LOCAL_RANK": "0", "WORLD_SIZE": str(workers),
            "MASTER_ADDR": f"{job}-0.default", "MASTER_PORT": "8476"}
        assert len(env["CUDA_VISIBLE_DEVICES"].split(",")) == cards
    assert len(placed) == workers  # a worker a host
    assert sorted(p["metadata"]["annotations"][t.COMPLETION_INDEX_ANNOTATION]
                  for p in pods) == [str(i) for i in range(workers)]
    return pods


@BOTH_PLUGINS
def test_bert_manifest_places_its_gang_all_or_nothing_on_h100s(nodes):
    """Config 4 at 3 workers x 2 cards: with two H100 hosts (and an A100
    one) no worker is placed; a third H100 host takes the whole gang at
    once, a worker a host, ranks 0..2 of world 3."""
    runtimes = [nodes.add(name, spec, hollow=True) for name, spec in (
        ("h100-0", f"{H100}:2:nva:0"), ("h100-1", f"{H100}:2:nvb:1"),
        ("a100-0", f"{A100}:2:nvc:2:40960"))]
    (doc,) = _manifest(BERT_YAML)
    job = _scale(_wire(doc), 3, 2)
    name = job["metadata"]["name"]
    nodes.client.jobs.create(job)
    must_poll_until(lambda: len(_job_pods(nodes.client, name)) == 3 and all(
        _failed_scheduling(nodes.client, p["metadata"]["name"])
        for p in _job_pods(nodes.client, name)), timeout=30.0,
        desc="every worker of the gang refused a place")
    assert not [p["spec"].get("nodeName") for p in _job_pods(nodes.client, name)
                if p["spec"].get("nodeName")]
    runtimes.append(nodes.add("h100-2", f"{H100}:2:nvd:3", hollow=True))
    must_poll_until(lambda: all((p.get("status") or {}).get("phase") == t.POD_RUNNING
                                for p in _job_pods(nodes.client, name)), timeout=30.0,
                    desc="the whole gang running")
    pods = _check_workers(nodes, name, 3, 2, runtimes, {"h100-0", "h100-1", "h100-2"})
    assert len({p["spec"].get("schedulingGang") for p in pods}) == 1
    command = pods[0]["spec"]["containers"][0]["command"]
    assert command[:5] == ["python", "-m", "kubernetes1_tpu_torch.workloads.launch", "-m",
                           "kubernetes1_tpu_torch.workloads.bert"]


@BOTH_PLUGINS
def test_llama_manifest_is_a_low_priority_gang_with_its_checkpoint_claim(nodes):
    """Config 5 at 2 workers x 2 cards: priority -100 from its
    PriorityClass, a gang stamped by the Job controller, the ConfigMap's
    env, the claim Bound to the manifest's volume, ranks 0..1 of world 2
    on the H100 hosts."""
    runtimes = [nodes.add(name, spec, hollow=True) for name, spec in (
        ("h100-0", f"{H100}:2:nva:0"), ("h100-1", f"{H100}:2:nvb:1"),
        ("a100-0", f"{A100}:2:nvc:2:40960"))]
    docs = _manifest(LLAMA_YAML)
    assert [d["kind"] for d in docs] == ["PriorityClass", "ConfigMap", "PersistentVolume",
                                         "PersistentVolumeClaim", "Job"]
    cs = nodes.cs
    for doc in docs:
        if doc["kind"] == "PersistentVolume":  # the checkpoint volume in this test's tmp
            doc["spec"]["hostPath"]["path"] = str(nodes.tmp / "ckpt")
        if doc["kind"] == "Job":
            _scale(doc, 2, 2)
            assert doc["spec"]["backoffLimit"] == 1000
        cs.resource(cs.scheme.resource_of[doc["kind"]]).create(cs.scheme.decode(doc))
    name = docs[-1]["metadata"]["name"]
    must_poll_until(lambda: [p for p in _job_pods(nodes.client, name)
                             if (p.get("status") or {}).get("phase") == t.POD_RUNNING] and all(
        (p.get("status") or {}).get("phase") == t.POD_RUNNING
        for p in _job_pods(nodes.client, name)), timeout=30.0, desc="both workers running")
    pods = _check_workers(nodes, name, 2, 2, runtimes, {"h100-0", "h100-1"})
    envs = _container_envs(runtimes)
    for p in pods:
        assert p["spec"]["priority"] == -100
        assert p["spec"]["schedulingGang"]
        assert p["spec"]["volumes"][0]["persistentVolumeClaim"]["claimName"] == "llama3-ckpt"
        assert envs[p["metadata"]["name"]]["GLOBAL_BATCH"] == "1024"
    pvc = cs.persistentvolumeclaims.get("llama3-ckpt", "default")
    assert pvc.status.phase == "Bound" and pvc.spec.volume_name == "llama3-ckpt-pv"
    command = pods[0]["spec"]["containers"][0]["command"]
    assert command[:7] == ["python", "-m", "kubernetes1_tpu_torch.workloads.launch", "-m",
                           "kubernetes1_tpu_torch.workloads.llama", "--config", "llama_3_8b"]


def test_manifests_run_configs_the_modules_have():
    for name, module in ((BERT_YAML, tbert), (LLAMA_YAML, tllama)):
        job = _manifest(name)[-1]
        command = job["spec"]["template"]["spec"]["containers"][0]["command"]
        config = command[command.index("--config") + 1]
        assert config in module.CONFIGS and config != "tiny"
        assert module.CONFIGS[config]().n_layers in (24, 32)  # full depth
        assert job["spec"]["gangScheduling"] and job["spec"]["completionMode"] == "Indexed"
        workers = job["spec"]["completions"]
        cards = job["spec"]["template"]["spec"]["extendedResources"][0]["quantity"]
        assert (workers * cards, cards) == ({BERT_YAML: 32, LLAMA_YAML: 256}[name], 8)


# ------------------------------------------------ config 4 run end to end


def test_bert_job_forms_one_gloo_world_of_4_through_the_launcher(nodes, monkeypatch):
    """Config 4's Job at 2 workers x 2 fake cards on two process-runtime
    nodes, the module's arguments overridden to --config tiny --device
    cpu: the launchers find the coordinator's pod through the apiserver
    (its name does not resolve here), torchrun starts 2 processes a pod,
    and rank 0's loss over the world of 4 equals one process's f32
    train_demo over the whole batch."""
    for key in DIST_ENV:
        monkeypatch.delenv(key, raising=False)
    nodes.add("gpu-node-0", f"{H100}:2:nv0:0")
    nodes.add("gpu-node-1", f"{H100}:2:nv1:1")
    (doc,) = _manifest(BERT_YAML)
    job = _scale(_wire(doc), 2, 2)
    name = job["metadata"]["name"]
    job["spec"]["backoffLimit"] = 0
    pod = job["spec"]["template"]["spec"]
    pod["restartPolicy"] = "Never"
    c = pod["containers"][0]
    at = c["command"].index("kubernetes1_tpu_torch.workloads.bert")
    c["command"] = [sys.executable] + c["command"][1:at + 1] + ["--config", "tiny",
                                                                 "--device", "cpu"]
    c["env"] = [specs.pythonpath_env(), {"name": "OMP_NUM_THREADS", "value": "1"}]
    nodes.client.jobs.create(job)
    done = poll_until(lambda: _succeeded(nodes.client, name, 2) or any(
        (p.get("status") or {}).get("phase") == t.POD_FAILED
        for p in _job_pods(nodes.client, name)), 0.1, 150.0, "both workers ended")
    logs = {p["metadata"]["name"]: nodes.client.pod_log(p["metadata"]["name"])
            for p in _job_pods(nodes.client, name)}
    assert done and _succeeded(nodes.client, name, 2), (logs, [
        (p["spec"].get("nodeName"), p.get("status")) for p in _job_pods(nodes.client, name)])
    coordinator = f"{name}-0.default"
    for rank in (0, 1):
        assert (f"launch: rank {rank} world 2 k 2 coordinator {coordinator} port 8476 "
                f"address 127.0.0.1 (podIP of default/{name}-0 from the apiserver)"
                in logs[f"{name}-{rank}"]), logs
    said = [line.split() for line in logs[f"{name}-0"].splitlines()
            if line.startswith("mlm-loss ")]
    assert "world 4 formed (gloo)" in logs[f"{name}-0"] and len(said) == 1, logs
    assert "mlm-loss" not in logs[f"{name}-1"]
    want = tbert.train_demo(dataclasses.replace(tbert.tiny(), dtype=torch.float32),
                            device="cpu")
    assert abs(float(said[0][1]) - want) <= F32_TOL, (said, want)


# ------------------------------------------------ the launcher alone


def _plugin_env(annotations, cards=1):
    """The env the plugin injects into a pod with these annotations and
    ``cards`` fake cards."""
    impl = gp.GPUDevicePlugin(devices=gp._fake_devices(f"{H100}:{cards}:nv0:0"))
    return impl.init_container({"device_ids": [d["id"] for d in impl.devices],
                                "pod_annotations": annotations}).envs


def _job_annotations(job, index, workers):
    """What the JAX Job controller stamps on pod ``index`` of an Indexed Job."""
    from kubernetes1_tpu.controllers.job import COORDINATOR_PORT

    return {gp.JOB_ANN_WORKER_ID: str(index),
            gp.JOB_ANN_COORDINATOR: f"{job}-0.default:{COORDINATOR_PORT}",
            gp.JOB_ANN_WORKER_HOSTNAMES: ",".join(f"{job}-{i}.default" for i in range(workers))}


def _launcher_env(extra):
    env = {k: v for k, v in os.environ.items() if k not in DIST_ENV + ("CUDA_VISIBLE_DEVICES",)}
    env.update(extra)
    env["PYTHONPATH"] = specs.pythonpath_env()["value"]
    env["OMP_NUM_THREADS"] = "1"
    return env


def _run_launcher(env, argv, limit):
    t0 = time.monotonic()
    res = subprocess.run([sys.executable, "-m", "kubernetes1_tpu_torch.workloads.launch", *argv],
                         env=env, cwd=REPO, capture_output=True, text=True, timeout=limit)
    return res, time.monotonic() - t0


@pytest.mark.parametrize("visible,k", [(None, 1), ("", 1), ("0", 1), ("0,1", 2),
                                       ("GPU-a,GPU-b,GPU-c", 3), (" , ", 1)])
def test_k_is_the_cards_in_the_pod(visible, k):
    env = {} if visible is None else {"CUDA_VISIBLE_DEVICES": visible}
    assert launch.cards_in_pod(env) == k


def test_a_coordinator_that_resolves_is_taken_by_name():
    env = _plugin_env({gp.ANN_WORKER_ID: "0", gp.ANN_COORDINATOR: "localhost:29500",
                       gp.ANN_WORKER_HOSTNAMES: "localhost"})
    deadline = time.monotonic() + 5
    assert launch.coordinator_address(env["MASTER_ADDR"], deadline, env) == (
        "localhost", "resolved by name")


def test_an_unresolved_coordinator_is_its_pods_ip_from_the_apiserver(control_plane):  # noqa: F811
    """The coordinator's pod is created, and given its IP, after the
    launcher started asking: it waits, then takes the IP."""
    master, cs = control_plane
    env = {**_plugin_env(_job_annotations("late", 1, 2)), "KTPU_APISERVER": master.url}
    name = env["MASTER_ADDR"]
    assert name == "late-0.default" and not launch.resolves(name)

    def appear():
        time.sleep(0.5)
        cs.pods.create(from_dict(t.Pod, {"metadata": {"name": "late-0", "namespace": "default"},
                                         "spec": {"containers": [{"name": "c", "image": "x"}]}}))
        time.sleep(0.3)
        pod = cs.pods.get("late-0", "default")
        pod.status.pod_ip = "10.9.8.7"
        cs.pods.update_status(pod)

    maker = threading.Thread(target=appear)
    t0 = time.monotonic()
    maker.start()
    try:
        got = launch.coordinator_address(name, time.monotonic() + 20, env)
    finally:
        maker.join(timeout=20)
    assert got == ("10.9.8.7", "podIP of default/late-0 from the apiserver")
    assert time.monotonic() - t0 >= 0.8


def test_a_coordinator_that_never_appears_ends_the_launcher_within_its_timeout(
        control_plane):  # noqa: F811
    master, _ = control_plane
    env = _launcher_env({**_plugin_env(_job_annotations("ghost", 1, 2)),
                         "KTPU_APISERVER": master.url})
    res, took = _run_launcher(env, ["--timeout", "3", "-m", "kubernetes1_tpu_torch.workloads.bert",
                                    "--device", "cpu"], 60)
    assert res.returncode == 1 and took < 3 + 2, (res, took)
    assert "ghost-0.default does not resolve, and its pod default/ghost-0 had no podIP" \
        in res.stderr
    assert res.stdout == ""  # no launch line: torchrun never started


def test_a_world_that_never_forms_ends_torchrun_within_the_timeout(tmp_path):
    """Worker 1 of 2 whose coordinator resolves but never listens: torchrun's
    rendezvous gives up with what is left of --timeout, and exits non-zero."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = _launcher_env(_plugin_env({gp.ANN_WORKER_ID: "1",
                                     gp.ANN_COORDINATOR: f"localhost:{port}",
                                     gp.ANN_WORKER_HOSTNAMES: "a,b"}))
    res, took = _run_launcher(env, ["--timeout", "8", "-m",
                                    "kubernetes1_tpu_torch.workloads.bert", "--device", "cpu"],
                              120)
    assert res.returncode != 0, res
    assert res.stdout.startswith(f"launch: rank 1 world 2 k 1 coordinator localhost port {port} "
                                 f"address localhost (resolved by name)")
    assert f"localhost, {port}" in res.stderr and "timed out" in res.stderr
    assert took < 8 + 20, took  # the limit, and torchrun's own start and teardown


def test_a_pod_alone_is_a_world_of_one_on_a_free_port():
    """A pod no Indexed Job made (no coordinator in its env): rank 0 of a
    world of one, the module's result printed by its rank 0."""
    env = _launcher_env(_plugin_env({}))
    res, _ = _run_launcher(env, ["--timeout", "60", "-m", "kubernetes1_tpu_torch.workloads.bert",
                                 "--device", "cpu", "--steps", "1"], 120)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[0].startswith("launch: rank 0 world 1 k 1 coordinator this pod port ")
    assert lines[0].endswith("address 127.0.0.1 (this pod alone)")
    assert lines[1:3] == ["world 1 formed (gloo)", lines[2]] and lines[2].startswith("mlm-loss ")
    want = tbert.train_demo(dataclasses.replace(tbert.tiny(), dtype=torch.float32), steps=1,
                            device="cpu")
    assert float(lines[2].split()[1]) == want  # world 1 through a mesh: the same bits


def test_launcher_usage_without_a_module():
    res, _ = _run_launcher(_launcher_env({}), ["--timeout", "1"], 60)
    assert res.returncode != 0 and "-m <module>" in res.stderr


# ------------------------------------------------ the mains


def test_llama_main_prints_loss_of_train_demo():
    env = _launcher_env({})
    res = subprocess.run([sys.executable, "-m", "kubernetes1_tpu_torch.workloads.llama",
                          "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16"],
                         env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    (line,) = res.stdout.splitlines()
    assert line.split()[0] == "loss"
    want = tllama.train_demo(dataclasses.replace(tllama.tiny(), dtype=torch.float32), steps=2,
                             batch=2, seq=16, device="cpu")
    assert float(line.split()[1]) == want


def test_configs_name_the_models():
    assert tbert.CONFIGS["bert_large"]() == tbert.bert_large()
    assert tbert.CONFIGS["tiny"]() == tbert.tiny()
    assert tllama.CONFIGS["llama_3_8b"]() == tllama.llama_3_8b()
    assert tllama.CONFIGS["tiny"]() == tllama.tiny()


# ------------------------------------------------ guards against one card of k


def _fake_cards(monkeypatch, n, calls):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: calls.append(("set_device", i)))
    monkeypatch.setattr(sharding.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(sharding.dist, "init_process_group",
                        lambda backend: calls.append(("init", backend)))


def _plugin_env_in_process(monkeypatch, cards):
    for key in DIST_ENV + ("LOCAL_WORLD_SIZE",):
        monkeypatch.delenv(key, raising=False)
    for key, value in _plugin_env(_job_annotations("bert", 1, 2), cards).items():
        monkeypatch.setenv(key, value)


def test_init_from_env_refuses_the_plugins_env_in_a_process_that_sees_more_cards(monkeypatch):
    calls = []
    _plugin_env_in_process(monkeypatch, 2)
    _fake_cards(monkeypatch, 2, calls)
    with pytest.raises(RuntimeError, match="kubernetes1_tpu_torch.workloads.launch"):
        sharding.init_from_env("cuda")
    assert calls == []


@pytest.mark.parametrize("case", ["one-card", "under-torchrun"])
def test_init_from_env_takes_the_plugins_env_with_one_card_or_under_torchrun(monkeypatch, case):
    calls = []
    _plugin_env_in_process(monkeypatch, 1 if case == "one-card" else 2)
    if case == "under-torchrun":
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    _fake_cards(monkeypatch, 1 if case == "one-card" else 2, calls)
    sharding.init_from_env("cuda")
    assert calls == [("set_device", 0), ("init", "nccl")]


def test_payload_job_with_more_cards_goes_through_the_launcher():
    job = specs.payload_job("rn", ["kubernetes1_tpu_torch.workloads.resnet_bench", "--steps", "2"],
                            gpus=4, out="/tmp/r.json")
    c = job["spec"]["template"]["spec"]["containers"][0]
    assert c["command"] == [sys.executable, "-m", "kubernetes1_tpu_torch.workloads.launch",
                            "-m", "kubernetes1_tpu_torch.workloads.resnet_bench", "--steps", "2",
                            "--out", "/tmp/r.json"]
    assert job["spec"]["template"]["spec"]["extendedResources"][0]["quantity"] == 4
    one = specs.payload_job("rn", ["kubernetes1_tpu_torch.workloads.resnet_bench"], gpus=1)
    assert one["spec"]["template"]["spec"]["containers"][0]["command"] == [
        sys.executable, "-m", "kubernetes1_tpu_torch.workloads.resnet_bench"]
