"""The nvidia.com/gpu device plane end to end on the CPU: the JAX package's
unchanged apiserver, scheduler, controllers and kubelet (in process) with
the port's GPU plugin in fake mode in the node's plugin dir, the shape of
``bench.py``'s workload phase.

A node advertises the card with its attributes and a pod in the pod-level
form gets it, with CUDA_VISIBLE_DEVICES injected into its process;
attribute affinity picks the right one of two nodes; a second pod waits
with "insufficient nvidia.com/gpu" until the card is free, and a
finished pod holds its card until it is deleted; a container
limit on nvidia.com/gpu is refused by the JAX apiserver's ResourceV2
admission and rewritten into the pod-level form by the port's; the MNIST Job of
``examples/gpu-mnist-single-card.yaml`` runs on the CPU with its command
overridden, and ``examples/gpu-resnet50-h100.yaml`` reaches Running on a
hollow node.  The card, the waiting pod and the MNIST Job also run with the
native plugin (``ktpu-gpu-plugin``, built once per test run with make) in
the plugin dir in place of the Python one.  With each plugin, the JAX
scheduler picks cards by NVLink domain (the fake spec's domain field one a
card): a 2-card pod gets an intact pair, and a gang of 2 workers x 2 cards
goes whole to the NVLink domain that holds it.

The scheduling tests run under each control plane (the ``control_plane``
fixture's parameter): ``jax``, the JAX package's ``Master``,
``Scheduler``, controllers and kubelets in process, and ``torch``, the
port's apiserver, scheduler and controller manager as the processes
``python -m kubernetes1_tpu_torch apiserver --port <port>``, ``python -m
kubernetes1_tpu_torch scheduler --server <url>`` and ``python -m
kubernetes1_tpu_torch controller-manager --server <url>`` (stopped by
SIGTERM), with the port's kubelets in process (``kubernetes1_tpu_torch
.kubelet``, over the port's clientset and runtimes).
Both give the same node and the same cards: the waiting pod's reason,
affinity on the cards' model and memory, a 2-card pod on one NVLink pair,
a gang on the domain that holds it, a gang bound all or nothing, and a
pod of higher priority preempting the pod that holds the cards.

The kubelets read no eviction signals: these tests are about devices, and
a pod must not be evicted because the host's disk is nearly full.
"""

import io
import json
import os
import signal
import subprocess
import sys
import time
import types

import pytest
import yaml

from kubernetes1_tpu.api import types as t
from kubernetes1_tpu.apiserver import Master
from kubernetes1_tpu.cli import CLI
from kubernetes1_tpu.client import Clientset
from kubernetes1_tpu.controllers import ControllerManager
from kubernetes1_tpu.kubelet import FakeRuntime, Kubelet, ProcessRuntime
from kubernetes1_tpu.machinery import Invalid, NotFound
from kubernetes1_tpu.machinery.scheme import from_dict
from kubernetes1_tpu.scheduler import Scheduler
from kubernetes1_tpu.utils.waitutil import must_poll_until
from kubernetes1_tpu_torch import GPU_RESOURCE, native
from kubernetes1_tpu_torch import kubelet as tkubelet
from kubernetes1_tpu_torch.client.clientset import Clientset as TorchClientset
from kubernetes1_tpu_torch.client.rest import Client
from kubernetes1_tpu_torch.deviceplugin import api as tapi
from kubernetes1_tpu_torch.deviceplugin import gpu_plugin as gp
from kubernetes1_tpu_torch.workloads import specs

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA H100 80GB HBM3"
A100 = "NVIDIA A100-SXM4-40GB"
INJECTED = ("CUDA_VISIBLE_DEVICES", "NVIDIA_VISIBLE_DEVICES", "CUDA_DEVICE_ORDER")


def _plugin(plugin_dir, fake_spec):
    impl = gp.GPUDevicePlugin(devices=gp._fake_devices(fake_spec), health_check_interval=0.2)
    return tapi.PluginServer(impl, tapi.plugin_socket_path(plugin_dir, GPU_RESOURCE)).start()


class _NativePlugin:
    """``ktpu-gpu-plugin`` in fake mode, stopped as a PluginServer is."""

    def __init__(self, binary, plugin_dir, fake_spec):
        env = {**os.environ, "KTPU_FAKE_GPUS": fake_spec}
        self.proc = subprocess.Popen([binary, "--plugin-dir", plugin_dir], env=env,
                                     stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        sock = tapi.plugin_socket_path(plugin_dir, GPU_RESOURCE)
        deadline = time.monotonic() + 10
        while not os.path.exists(sock):
            if self.proc.poll() is not None or time.monotonic() > deadline:
                self.stop()
                raise RuntimeError(f"the native plugin did not serve {sock}")
            time.sleep(0.02)

    def stop(self):
        if self.proc.poll() is None:
            self.proc.terminate()
        self.proc.wait(timeout=10)


@pytest.fixture(scope="session")
def native_bins(tmp_path_factory):
    return native.build(str(tmp_path_factory.mktemp("native-bin")))


KUBELET_TIMING = dict(heartbeat_interval=0.5, sync_interval=0.3, pleg_interval=0.3,
                      eviction_signals_fn=lambda: {},
                      capacity={"cpu": "16", "memory": "64Gi", "pods": "110"})


def _kubelet(cs, name, runtime, plugin_dir):
    return Kubelet(cs, node_name=name, runtime=runtime, plugin_dir=plugin_dir, **KUBELET_TIMING)


class _Node:
    """A node's kubelet and runtime: the JAX package's, or under the port's
    control plane (``torch``) the port's, with a clientset of its own."""

    def __init__(self, request, master, cs, name, plugin_dir, hollow, root):
        self.cs = None
        if _plane(request) == "torch":
            self.cs = TorchClientset(master.url)
            self.runtime = tkubelet.FakeRuntime() if hollow else tkubelet.ProcessRuntime(
                root_dir=root)
            self.kubelet = tkubelet.Kubelet(self.cs, name, self.runtime, plugin_dir=plugin_dir,
                                            **KUBELET_TIMING)
        else:
            self.runtime = FakeRuntime() if hollow else ProcessRuntime(root_dir=root)
            self.kubelet = _kubelet(cs, name, self.runtime, plugin_dir)
        self.kubelet.start()

    def stop(self):
        self.kubelet.stop()
        if hasattr(self.runtime, "kill_all"):
            self.runtime.kill_all()  # no container outlives the test
        if self.cs is not None:
            self.cs.close()


def _plane(request) -> str:
    """The test's control plane: ``jax`` unless parametrized ``torch``."""
    callspec = getattr(request.node, "callspec", None)
    return callspec.params.get("control_plane", "jax") if callspec else "jax"


class _PortComponent:
    """One of the port's component processes, ``python -m
    kubernetes1_tpu_torch <argv>``, its output in ``log``; running once it
    prints ``ready``, stopped by SIGTERM with exit code 0."""

    def __init__(self, argv, log, ready):
        self.log, self.ready, self.what = log, ready, f"the port's {argv[0]}"
        with open(log, "w") as out:
            self.proc = subprocess.Popen([sys.executable, "-m", "kubernetes1_tpu_torch", *argv],
                                         cwd=REPO, stdout=out, stderr=subprocess.STDOUT)
        try:
            must_poll_until(self._running, timeout=30.0, desc=f"{self.what} running")
        except BaseException:
            self.stop()
            raise

    def _running(self):
        if self.proc.poll() is not None:
            raise RuntimeError(f"{self.what} exited {self.proc.returncode}: "
                               f"{open(self.log).read()}")
        return self.ready in open(self.log).read()

    def stop(self):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        assert self.proc.wait(timeout=15) == 0, open(self.log).read()


def _port_scheduler(url, log):
    return _PortComponent(["scheduler", "--server", url, "--metrics-port", "-1"], log,
                          "scheduler running")


def _port_controller_manager(url, log):
    return _PortComponent(["controller-manager", "--server", url, "--node-monitor-grace", "5",
                           "--pod-eviction-timeout", "5"], log, "controller manager running")


class _PortApiserver(_PortComponent):
    """The port's apiserver process on a loopback port it picks itself
    (``--port 0``), at ``url``, read off its "listening on" line."""

    LISTENING = "ktpu-apiserver listening on "

    def __init__(self, log):
        super().__init__(["apiserver", "--port", "0"], log, self.LISTENING)
        line = next(ln for ln in open(log).read().splitlines() if ln.startswith(self.LISTENING))
        self.url = line[len(self.LISTENING):].strip()


@pytest.fixture()
def control_plane(request, tmp_path):
    """An apiserver, a scheduler and a controller manager: the JAX ones in
    process, or with the parameter ``torch``, the port's as processes."""
    if getattr(request, "param", "jax") == "torch":
        master = _PortApiserver(str(tmp_path / "apiserver.log"))
        cs = Clientset(master.url)
        sched = _port_scheduler(master.url, str(tmp_path / "scheduler.log"))
        try:
            cm = _port_controller_manager(master.url, str(tmp_path / "controller-manager.log"))
        except BaseException:
            sched.stop()
            cs.close()
            master.stop()
            raise
    else:
        master = Master().start()
        cs = Clientset(master.url)
        sched = Scheduler(cs)
        sched.start()
        cm = ControllerManager(cs, monitor_grace=5.0, eviction_timeout=5.0).start()
    yield master, cs
    cm.stop()
    sched.stop()
    cs.close()
    master.stop()


@pytest.fixture()
def gpu_node(request, control_plane, tmp_path):
    """One ProcessRuntime node with one fake H100 behind the port's plugin:
    the Python one, or with the parameter ``native``, ``ktpu-gpu-plugin``."""
    master, cs = control_plane
    plugin_dir = str(tmp_path / "plugins")
    if getattr(request, "param", "python") == "native":
        binary = request.getfixturevalue("native_bins")[native.PLUGIN]
        plugin = _NativePlugin(binary, plugin_dir, f"{H100}:1:nv0:0")
    else:
        plugin = _plugin(plugin_dir, f"{H100}:1:nv0:0")
    node = _Node(request, master, cs, "gpu-node-0", plugin_dir, False, str(tmp_path / "ktpu"))
    must_poll_until(lambda: _cards(cs, "gpu-node-0"), timeout=20.0,
                    desc="gpu-node-0 advertises its card")
    yield {"master": master, "cs": cs, "tmp": tmp_path}
    node.stop()
    plugin.stop()


@pytest.fixture()
def hollow_nodes(request, control_plane, tmp_path):
    """Two FakeRuntime nodes: an H100 and an A100, each behind its own plugin."""
    master, cs = control_plane
    nodes = []
    for name, spec in (("h100-node", f"{H100}:1:nvh:0"), ("a100-node", f"{A100}:1:nva:0:40960")):
        plugin = _plugin(str(tmp_path / name), spec)
        nodes.append((_Node(request, master, cs, name, str(tmp_path / name), True, ""), plugin))
    for name in ("h100-node", "a100-node"):
        must_poll_until(lambda: _cards(cs, name), timeout=20.0, desc=f"{name}'s card")
    yield {"master": master, "cs": cs}
    for node, plugin in nodes:
        node.stop()
        plugin.stop()


@pytest.fixture()
def nodes(request, control_plane, tmp_path):
    """``add(name, fake_spec, hollow)`` starts a node with its own plugin
    in fake mode (the Python one, or with the parameter ``native``,
    ``ktpu-gpu-plugin``) and a ProcessRuntime (or, hollow, a FakeRuntime)
    kubelet; returns the runtime.  Everything started stops at teardown."""
    master, cs = control_plane
    kind = getattr(request, "param", "python")
    made = []

    def add(name, fake, hollow=False):
        # short: a unix socket's path has at most 107 bytes
        plugin_dir = str(tmp_path / f"p{len(made)}")
        if kind == "native":
            plugin = _NativePlugin(request.getfixturevalue("native_bins")[native.PLUGIN],
                                   plugin_dir, fake)
        else:
            plugin = _plugin(plugin_dir, fake)
        node = _Node(request, master, cs, name, plugin_dir, hollow, str(tmp_path / f"r{len(made)}"))
        made.append((node, plugin))
        must_poll_until(lambda: _cards(cs, name), timeout=20.0, desc=f"{name}'s cards")
        return node.runtime

    client = Client(master.url)
    yield types.SimpleNamespace(master=master, cs=cs, client=client, add=add, tmp=tmp_path)
    client.close()
    for node, plugin in made:
        node.stop()
        plugin.stop()


BOTH_PLUGINS = pytest.mark.parametrize("gpu_node", ["python", "native"], indirect=True)
NODES_BOTH_PLUGINS = pytest.mark.parametrize("nodes", ["python", "native"], indirect=True)
BOTH_SCHEDULERS = pytest.mark.parametrize("control_plane", ["jax", "torch"], indirect=True)


def _cards(cs, node):
    try:
        status = cs.nodes.get(node, "").status
    except NotFound:
        return []
    return [d for d in (status.extended_resources or {}).get(GPU_RESOURCE, [])
            if d.health == t.DEVICE_HEALTHY]


def _pod(name, code, gpus=1, affinity=None):
    """A pod running ``python -c code`` that asks for cards in the
    pod-level form, decoded from the port's wire-form dict."""
    pod_spec = {"containers": [{"name": "main", "image": "ktpu/torch-workload",
                                "command": [sys.executable, "-c", code],
                                "env": [specs.pythonpath_env()]}],
                "restartPolicy": "Never"}
    if gpus:
        specs.gpu_request(pod_spec, gpus, affinity=affinity)
    return from_dict(t.Pod, {"metadata": {"name": name, "namespace": "default"},
                             "spec": pod_spec})


def _env_dump(path):
    return (f"import os, json; open({str(path)!r}, 'w').write(json.dumps("
            f"{{k: os.environ.get(k) for k in {INJECTED!r}}}))")


def _phase(cs, name):
    return cs.pods.get(name, "default").status.phase


def _failed_scheduling(cs, pod):
    events, _ = cs.events.list(namespace="default")
    return [e.message for e in events
            if e.involved_object.name == pod and e.reason == "FailedScheduling"]


@BOTH_PLUGINS
def test_node_advertises_the_card_and_a_pod_gets_it(gpu_node):
    cs, tmp = gpu_node["cs"], gpu_node["tmp"]
    (card,) = _cards(cs, "gpu-node-0")
    assert card.id == "nv0-h0-gpu0"
    assert card.attributes == {
        gp.ATTR_GPU_MODEL: H100, gp.ATTR_GPU_MEMORY: "81559",
        gp.ATTR_GPU_UUID: "GPU-fake-nv0-h0-0", gp.ATTR_GPU_NVLINK_DOMAIN: "nv0",
        gp.ATTR_GPU_MINOR: "0", gp.ATTR_SLICE: "nv0", gp.ATTR_COORDS: "0",
        gp.ATTR_DEVICE_INDEX: "0"}
    out = tmp / "env.json"
    cs.pods.create(_pod("cuda-env", _env_dump(out)))
    must_poll_until(lambda: _phase(cs, "cuda-env") == t.POD_SUCCEEDED, timeout=60.0,
                    desc="the pod ran to its end")
    pod = cs.pods.get("cuda-env", "default")
    assert pod.spec.node_name == "gpu-node-0"
    assert pod.spec.extended_resources[0].assigned == ["nv0-h0-gpu0"]
    assert json.loads(out.read_text()) == {"CUDA_VISIBLE_DEVICES": "0",
                                           "NVIDIA_VISIBLE_DEVICES": "0",
                                           "CUDA_DEVICE_ORDER": "PCI_BUS_ID"}


@BOTH_SCHEDULERS
@BOTH_PLUGINS
def test_second_pod_waits_with_insufficient_gpu_until_the_card_is_free(gpu_node):
    cs = gpu_node["cs"]
    cs.pods.create(_pod("holder", "import time; time.sleep(300)"))
    must_poll_until(lambda: _phase(cs, "holder") == t.POD_RUNNING, timeout=60.0,
                    desc="the holder runs on the card")
    cs.pods.create(_pod("waiter", "print('ran')"))
    must_poll_until(lambda: any("insufficient nvidia.com/gpu" in m
                                for m in _failed_scheduling(cs, "waiter")),
                    timeout=30.0, desc="the scheduler's reason for the waiter")
    waiter = cs.pods.get("waiter", "default")
    assert waiter.spec.node_name == "" and waiter.status.phase == t.POD_PENDING
    cs.pods.delete("holder", "default")
    must_poll_until(lambda: _phase(cs, "waiter") == t.POD_SUCCEEDED, timeout=60.0,
                    desc="the waiter runs once the card is free")
    assert cs.pods.get("waiter", "default").spec.extended_resources[0].assigned == [
        "nv0-h0-gpu0"]


def test_a_finished_pod_holds_its_card_until_it_is_deleted(gpu_node):
    """The JAX scheduler's accounting, as the cluster phase on the card
    found it: a bound pod's cards stay taken after it Succeeded, until the
    pod is deleted (``scheduler/cache.py`` ``NodeInfo.add_pod``), so a Job's
    finished pod must go before the next pod can have its card."""
    cs = gpu_node["cs"]
    cs.pods.create(_pod("done", "print('done')"))
    must_poll_until(lambda: _phase(cs, "done") == t.POD_SUCCEEDED, timeout=60.0,
                    desc="the first pod finished")
    cs.pods.create(_pod("next", "print('next')"))
    must_poll_until(lambda: any("insufficient nvidia.com/gpu" in m
                                for m in _failed_scheduling(cs, "next")),
                    timeout=30.0, desc="the next pod waits behind the finished one")
    assert cs.pods.get("next", "default").spec.node_name == ""
    cs.pods.delete("done", "default")
    must_poll_until(lambda: _phase(cs, "next") == t.POD_SUCCEEDED, timeout=60.0,
                    desc="the next pod runs once the finished one is gone")


@BOTH_SCHEDULERS
def test_gpu_container_limit_is_refused_by_jax_and_rewritten_by_the_ports_resource_v2(gpu_node,
                                                                                      request):
    """A pre-v2 PodSpec, an nvidia.com/gpu container limit: the JAX
    apiserver's ResourceV2 refuses it; the port's rewrites it into the
    pod-level form, and the pod gets the card and runs."""
    cs = gpu_node["cs"]
    pod = _pod("limited", "print('ran')", gpus=0)
    pod.spec.containers[0].resources.limits = {GPU_RESOURCE: 1}
    if request.node.callspec.params["control_plane"] == "jax":
        with pytest.raises(Invalid, match="'nvidia.com/gpu' is not available on this cluster"):
            cs.pods.create(pod)
        with pytest.raises(NotFound):
            cs.pods.get("limited", "default")
        return
    cs.pods.create(pod)
    must_poll_until(lambda: _phase(cs, "limited") == t.POD_SUCCEEDED, timeout=60.0,
                    desc="the rewritten pod ran on the card")
    spec = cs.pods.get("limited", "default").spec
    (per,) = spec.extended_resources
    assert (per.resource, per.quantity, per.assigned) == (GPU_RESOURCE, 1, ["nv0-h0-gpu0"])
    assert spec.containers[0].extended_resource_requests == [per.name]
    assert GPU_RESOURCE not in spec.containers[0].resources.limits
    assert spec.node_name == "gpu-node-0"


@BOTH_PLUGINS
def test_mnist_job_from_the_manifest_succeeds_with_the_injected_env(gpu_node):
    cs, tmp = gpu_node["cs"], gpu_node["tmp"]
    with open(os.path.join(EXAMPLES, "gpu-mnist-single-card.yaml")) as f:
        doc = yaml.safe_load(f)
    job = from_dict(t.Job, {k: v for k, v in doc.items() if k not in ("kind", "apiVersion")})
    c = job.spec.template.spec.containers[0]
    code = c.command[-1]
    assert "train()" in code
    out = tmp / "mnist-env.json"
    # on the CPU: the same code, the plain versions, and the injected env kept
    c.command = [sys.executable, "-c",
                 code.replace("train()", "train(device='cpu')") + "; " + _env_dump(out)]
    c.env = [t.EnvVar(name="PYTHONPATH", value=specs.pythonpath_env()["value"]),
             t.EnvVar(name="OMP_NUM_THREADS", value="1")]  # one core beside the suite
    cs.jobs.create(job)
    must_poll_until(lambda: cs.jobs.get("mnist-1gpu", "default").status.succeeded >= 1,
                    timeout=180.0, desc="the MNIST Job succeeded")
    (pod,), _ = cs.pods.list(namespace="default",
                             label_selector="batch.ktpu.io/job-name=mnist-1gpu")
    assert pod.spec.extended_resources[0].assigned == ["nv0-h0-gpu0"]
    assert json.loads(out.read_text())["CUDA_VISIBLE_DEVICES"] == "0"


@BOTH_SCHEDULERS
def test_affinity_on_model_and_memory_picks_the_node(hollow_nodes):
    cs = hollow_nodes["cs"]
    big = [{"key": gp.ATTR_GPU_MODEL, "operator": "In", "values": [H100]},
           {"key": gp.ATTR_GPU_MEMORY, "operator": "Gt", "values": ["80000"]}]
    small = [{"key": gp.ATTR_GPU_MEMORY, "operator": "Lt", "values": ["50000"]}]
    huge = [{"key": gp.ATTR_GPU_MEMORY, "operator": "Gt", "values": ["100000"]}]
    for name, affinity in (("wants-h100", big), ("wants-40g", small), ("wants-huge", huge)):
        cs.pods.create(_pod(name, "pass", affinity=affinity))
    must_poll_until(lambda: all(_phase(cs, n) == t.POD_RUNNING
                                for n in ("wants-h100", "wants-40g")),
                    timeout=30.0, desc="both pods running")
    assert cs.pods.get("wants-h100", "default").spec.node_name == "h100-node"
    assert cs.pods.get("wants-h100", "default").spec.extended_resources[0].assigned == [
        "nvh-h0-gpu0"]
    assert cs.pods.get("wants-40g", "default").spec.node_name == "a100-node"
    must_poll_until(lambda: _failed_scheduling(cs, "wants-huge"), timeout=30.0,
                    desc="no card matches the huge pod")
    assert cs.pods.get("wants-huge", "default").spec.node_name == ""


def test_resnet_manifest_reaches_running_on_a_hollow_node(hollow_nodes):
    master, cs = hollow_nodes["master"], hollow_nodes["cs"]
    out = io.StringIO()
    cli = CLI(master.url, "default", out=out)
    try:
        cli.apply(type("A", (), {"filename": os.path.join(EXAMPLES, "gpu-resnet50-h100.yaml")})())
    finally:
        cli.cs.close()

    def running():
        pods, _ = cs.pods.list(namespace="default", label_selector="app=resnet50-gpu")
        return [p for p in pods if p.status.phase == t.POD_RUNNING]

    must_poll_until(running, timeout=30.0, desc="the ResNet-50 pod running")
    (pod,) = running()
    per = pod.spec.extended_resources[0]
    assert (per.resource, per.quantity, len(per.assigned)) == (GPU_RESOURCE, 1, 1)
    node = cs.nodes.get(pod.spec.node_name, "")
    assert per.assigned[0] in {d.id for d in node.status.extended_resources[GPU_RESOURCE]}
    assert not pod.spec.containers[0].resources.limits


# ------------------------------------------ the NVLink domain in the scheduler


def _assigned(cs, name):
    pod = cs.pods.get(name, "default")
    return pod.spec.node_name, pod.spec.extended_resources[0].assigned


@BOTH_SCHEDULERS
@NODES_BOTH_PLUGINS
def test_two_card_pod_lands_on_one_nvlink_pair(nodes):
    """A node of two fake NVLink pairs (nvl-a: cards 0, 1; nvl-b: 2, 3):
    a 1-card pod takes card 0, and the next 2-card pod gets the intact
    pair nvl-b, not cards 1 and 2 (the IDs' order), whose traffic would
    cross PCIe."""
    nodes.add("pairs-node", f"{H100}:4:nvl-a,nvl-a,nvl-b,nvl-b:0", hollow=True)
    cs = nodes.cs
    cs.pods.create(_pod("one", "pass", gpus=1))
    must_poll_until(lambda: _phase(cs, "one") == t.POD_RUNNING, timeout=30.0,
                    desc="the 1-card pod running")
    assert _assigned(cs, "one") == ("pairs-node", ["nvl-a-h0-gpu0"])
    cs.pods.create(_pod("two", "pass", gpus=2))
    must_poll_until(lambda: _phase(cs, "two") == t.POD_RUNNING, timeout=30.0,
                    desc="the 2-card pod running")
    assert _assigned(cs, "two") == ("pairs-node", ["nvl-b-h0-gpu2", "nvl-b-h0-gpu3"])


@BOTH_SCHEDULERS
@NODES_BOTH_PLUGINS
def test_gang_goes_to_the_nvlink_domain_that_holds_it(nodes):
    """A node of two NVLink pairs (4 cards) and one of an 8-card NVSwitch
    domain: an Indexed gang Job of 2 workers x 2 cards (4 cards) goes
    whole to the NVSwitch domain, the one that holds it, where best-fit
    by the count of free cards alone would pack it onto the pairs, a
    worker a pair."""
    nodes.add("pairs-node", f"{H100}:4:nvl-1a,nvl-1a,nvl-1b,nvl-1b:1", hollow=True)
    nodes.add("switch-node", f"{H100}:8:nvl-0:0", hollow=True)
    pod_spec = {"containers": [{"name": "main", "image": "ktpu/torch-workload",
                                "command": [sys.executable, "-c", "pass"]}],
                "restartPolicy": "Never"}
    specs.gpu_request(pod_spec, 2)
    nodes.client.jobs.create({
        "metadata": {"name": "gang", "namespace": "default"},
        "spec": {"completionMode": "Indexed", "completions": 2, "parallelism": 2,
                 "gangScheduling": True, "backoffLimit": 0,
                 "template": {"metadata": {"labels": {"app": "gang"}}, "spec": pod_spec}}})

    def running():
        pods, _ = nodes.cs.pods.list(namespace="default",
                                     label_selector="batch.ktpu.io/job-name=gang")
        return len(pods) == 2 and all(p.status.phase == t.POD_RUNNING for p in pods) and pods

    must_poll_until(running, timeout=30.0, desc="the whole gang running")
    pods = running()
    assert {p.spec.node_name for p in pods} == {"switch-node"}
    cards = sorted(c for p in pods for c in p.spec.extended_resources[0].assigned)
    assert cards == [f"nvl-0-h0-gpu{i}" for i in range(4)]


# --------------------------------- gangs and preemption, under each scheduler


def _gang_pod(name, gpus, gang, size, priority=0):
    pod = _pod(name, "pass", gpus=gpus)
    pod.spec.scheduling_gang, pod.spec.gang_size, pod.spec.priority = gang, size, priority
    return pod


@BOTH_SCHEDULERS
def test_gang_binds_all_or_nothing(nodes):
    """Two hosts of 4 cards in one NVLink domain (``fabric``): a gang of 2
    pods x 4 cards binds whole, a host each, every card of each.  The
    scheduler integration suite's gang scenario, on fake GPU nodes."""
    nodes.add("h0", f"{H100}:4:fabric:0", hollow=True)
    nodes.add("h1", f"{H100}:4:fabric:1", hollow=True)
    cs = nodes.cs
    for i in range(2):
        cs.pods.create(_gang_pod(f"worker-{i}", 4, "bert", 2))
    must_poll_until(lambda: all(_phase(cs, f"worker-{i}") == t.POD_RUNNING for i in range(2)),
                    timeout=30.0, desc="both gang members running")
    got = sorted(_assigned(cs, f"worker-{i}") for i in range(2))
    assert got == [("h0", [f"fabric-h0-gpu{k}" for k in range(4)]),
                   ("h1", [f"fabric-h1-gpu{k}" for k in range(4)])]


@BOTH_SCHEDULERS
def test_gang_waits_for_all_members(nodes):
    """A gang of 2 with one member made: nothing binds until the second
    exists, then both bind."""
    nodes.add("h0", f"{H100}:4:fabric:0", hollow=True)
    nodes.add("h1", f"{H100}:4:fabric:1", hollow=True)
    cs = nodes.cs
    cs.pods.create(_gang_pod("lone-0", 4, "solo", 2))
    time.sleep(1.0)
    assert cs.pods.get("lone-0", "default").spec.node_name == ""  # an incomplete gang holds
    cs.pods.create(_gang_pod("lone-1", 4, "solo", 2))
    must_poll_until(lambda: all(_phase(cs, f"lone-{i}") == t.POD_RUNNING for i in range(2)),
                    timeout=30.0, desc="the completed gang running")
    assert sorted(_assigned(cs, f"lone-{i}")[0] for i in range(2)) == ["h0", "h1"]


@BOTH_SCHEDULERS
def test_high_priority_pod_preempts_the_pod_holding_the_cards(nodes):
    """A node of 4 cards held whole by a pod of priority 0: a pod of
    priority 100 asking for 4 evicts it through the eviction subresource
    (the scheduler's Preempted event on the victim) and binds the same 4
    cards once the kubelet has finished the victim."""
    nodes.add("n1", f"{H100}:4:nvl:0", hollow=True)
    cs = nodes.cs
    cs.pods.create(_gang_pod("victim", 4, "", 0))
    must_poll_until(lambda: _phase(cs, "victim") == t.POD_RUNNING, timeout=30.0,
                    desc="the victim running on the cards")
    cards = [f"nvl-h0-gpu{k}" for k in range(4)]
    assert _assigned(cs, "victim") == ("n1", cards)
    cs.pods.create(_gang_pod("vip", 4, "", 0, priority=100))
    must_poll_until(lambda: _phase(cs, "vip") == t.POD_RUNNING, timeout=45.0,
                    desc="the preemptor running")
    assert _assigned(cs, "vip") == ("n1", cards)
    with pytest.raises(NotFound):
        cs.pods.get("victim", "default")

    def preempted():
        events, _ = cs.events.list(namespace="default")
        return [e.message for e in events
                if e.involved_object.name == "victim" and e.reason == "Preempted"]

    must_poll_until(preempted, timeout=10.0, desc="the scheduler's Preempted event")
    assert preempted() == ["preempted by default/vip (priority 100)"]
