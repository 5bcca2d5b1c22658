"""The port's nvidia.com/gpu device plugin against the JAX package's device
plane, over real unix sockets on the CPU.

The wire protocol in both directions (the JAX client against the port's
server, the port's client against the JAX package's TPU plugin), the JAX
kubelet's unchanged DeviceManager registering the port's plugin, health
flips (set_health, the port's device.health seam, a vanished device node,
a stopped or killed plugin), admission's paths, the exact injection, real
discovery with a stand-in nvidia-smi, and the plugin's main.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading

import pytest

from kubernetes1_tpu.api import types as t
from kubernetes1_tpu.deviceplugin import api as japi
from kubernetes1_tpu.deviceplugin.tpu_plugin import TPUDevicePlugin
from kubernetes1_tpu.deviceplugin.tpu_plugin import _fake_devices as tpu_fake_devices
from kubernetes1_tpu.kubelet.devicemanager import DeviceManager
from kubernetes1_tpu.machinery.scheme import from_dict
from kubernetes1_tpu.scheduler.cache import NodeInfo
from kubernetes1_tpu.scheduler.devices import allocate_for_pod
from kubernetes1_tpu.scheduler.predicates import TOPOLOGY_TPU_SLICE, node_topology_value
from kubernetes1_tpu.utils.waitutil import must_poll_until
from kubernetes1_tpu_torch import GPU_RESOURCE
from kubernetes1_tpu_torch.api import types as torch_types
from kubernetes1_tpu_torch.deviceplugin import api as tapi
from kubernetes1_tpu_torch.deviceplugin import gpu_plugin as gp
from kubernetes1_tpu_torch.utils import faultline

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture()
def plugin_dir(tmp_path):
    return str(tmp_path / "plugins")


def _serve(plugin_dir, devices, interval=0.1):
    impl = gp.GPUDevicePlugin(devices=devices, health_check_interval=interval)
    server = tapi.PluginServer(impl, tapi.plugin_socket_path(plugin_dir, GPU_RESOURCE))
    return impl, server.start()


@pytest.fixture()
def served_gpu(plugin_dir):
    impl, server = _serve(plugin_dir, gp._fake_devices(f"{H100}:4:nv0:0"))
    yield impl, server, plugin_dir
    server.stop()


@pytest.fixture()
def manager(plugin_dir):
    dm = DeviceManager(plugin_dir, poll_interval=0.1).start()
    yield dm
    dm.stop()


def _gpu_pod(name, uid, assigned, quantity=1):
    pod = t.Pod()
    pod.metadata.name, pod.metadata.namespace, pod.metadata.uid = name, "default", uid
    per = t.PodExtendedResource(name="gpu", resource=GPU_RESOURCE, quantity=quantity,
                                assigned=list(assigned))
    pod.spec.extended_resources = [per]
    pod.spec.containers = [t.Container(name="main", image="x",
                                       extended_resource_requests=["gpu"])]
    return pod


def _healths(dm):
    return {d.id: d.health for d in dm.get_capacity().get(GPU_RESOURCE, [])}


def _stream(client):
    frames = []
    stream = client.list_and_watch()
    th = threading.Thread(target=lambda: frames.extend(stream), daemon=True)
    th.start()
    return frames


# ------------------------------------------------------------------- wire


def test_socket_path_layout_matches_the_jax_package():
    for resource in (GPU_RESOURCE, "google.com/tpu"):
        assert tapi.plugin_socket_path("/d", resource) == japi.plugin_socket_path("/d", resource)
    path = tapi.plugin_socket_path("/d", GPU_RESOURCE)
    assert path == "/d/nvidia.com/gpu.sock"
    assert tapi.resource_from_socket("/d", path) == GPU_RESOURCE
    assert japi.resource_from_socket("/d", path) == GPU_RESOURCE
    assert tapi.resource_from_socket("/d", "/d/junk") is None


def test_jax_client_drives_the_port_server_over_all_four_rpcs(served_gpu):
    impl, server, _ = served_gpu
    client = japi.PluginClient(server.socket_path)
    try:
        info = client.call("GetPluginInfo")
        assert info == {"name": GPU_RESOURCE, "version": "v1", "device_count": 4}
        frames = _stream(client)
        must_poll_until(lambda: frames, desc="initial frame")
        assert [d["id"] for d in frames[0]] == [f"nv0-h0-gpu{i}" for i in range(4)]
        impl.set_health("nv0-h0-gpu2", t.DEVICE_UNHEALTHY)
        must_poll_until(lambda: len(frames) >= 2, desc="health frame")
        assert {d["id"]: d["health"] for d in frames[-1]}["nv0-h0-gpu2"] == t.DEVICE_UNHEALTHY
        ok = client.call("AdmitPod", {"pod_uid": "u1", "assignments": {"gpu": ["nv0-h0-gpu0"]}})
        assert ok == {"allowed": True}
        sick = client.call("AdmitPod", {"pod_uid": "u2",
                                        "assignments": {"gpu": ["nv0-h0-gpu2"]}})
        assert sick["allowed"] is False and "unhealthy" in sick["reason"]
        spec = japi.ContainerSpec.from_dict(client.call("InitContainer", {
            "pod_uid": "u1", "container_name": "main", "device_ids": ["nv0-h0-gpu0"],
            "pod_annotations": {}}))
        assert spec.envs["CUDA_VISIBLE_DEVICES"] == "0"
        assert spec.annotations == {"gpu.ktpu.io/injected": "true"}
        with pytest.raises(RuntimeError, match="unknown method"):
            client.call("Allocate")
    finally:
        client.close()


def test_port_client_drives_the_jax_tpu_plugin_over_all_four_rpcs(plugin_dir):
    impl = TPUDevicePlugin(devices=tpu_fake_devices("v5e:4:s0:0"), health_check_interval=0.1)
    server = japi.PluginServer(impl, japi.plugin_socket_path(plugin_dir, "google.com/tpu"))
    server.start()
    client = tapi.PluginClient(server.socket_path)
    try:
        assert client.call("GetPluginInfo")["name"] == "google.com/tpu"
        frames = _stream(client)
        must_poll_until(lambda: frames, desc="initial frame")
        assert len(frames[0]) == 4
        impl.set_health("s0-h0-chip1", t.DEVICE_UNHEALTHY)
        must_poll_until(lambda: len(frames) >= 2, desc="health frame")
        assert {d["id"]: d["health"] for d in frames[-1]}["s0-h0-chip1"] == t.DEVICE_UNHEALTHY
        assert client.call("AdmitPod", {"pod_uid": "u", "assignments": {
            "r": ["s0-h0-chip0"]}}) == {"allowed": True}
        assert client.call("AdmitPod", {"pod_uid": "u", "assignments": {
            "r": ["nope"]}})["allowed"] is False
        spec = tapi.ContainerSpec.from_dict(client.call("InitContainer", {
            "pod_uid": "u", "container_name": "main", "device_ids": ["s0-h0-chip0",
                                                                   "s0-h0-chip3"]}))
        assert spec.envs["TPU_VISIBLE_CHIPS"] == "0,3"
        assert spec.annotations == {"tpu.ktpu.io/injected": "true"}
    finally:
        client.close()
        server.stop()


def test_frames_are_the_jax_package_frames_byte_for_byte(served_gpu):
    """A raw socket sees the same newline-delimited JSON from the port's
    server as the JAX package's encoder writes."""
    _, server, _ = served_gpu
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as conn:
        conn.settimeout(10)
        conn.connect(server.socket_path)
        f = conn.makefile("rwb")
        f.write(b'{"id": 7, "method": "GetPluginInfo", "params": {}}\n')
        f.write(b'{"id": 8, "method": "Nope"}\n')
        f.flush()
        info = f.readline()
        assert info == json.dumps({"id": 7, "result": {
            "name": GPU_RESOURCE, "version": "v1", "device_count": 4}}).encode() + b"\n"
        assert json.loads(f.readline()) == {"id": 8, "error": "unknown method 'Nope'"}
        f.close()
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as conn:
        conn.settimeout(10)
        conn.connect(server.socket_path)
        f = conn.makefile("rwb")
        f.write(b'{"id": 3, "method": "ListAndWatch", "params": {}}\n')
        f.flush()
        frame = json.loads(f.readline())
        assert sorted(frame) == ["result", "stream"] and frame["stream"] == 3
        assert len(frame["result"]["devices"]) == 4
        f.close()


# ----------------------------------------------------------- registration


def test_jax_device_manager_registers_the_port_plugin(served_gpu, manager):
    must_poll_until(lambda: manager.get_capacity().get(GPU_RESOURCE),
                    desc="nvidia.com/gpu discovered")
    assert manager.has_plugin(GPU_RESOURCE)
    devices = manager.get_capacity()[GPU_RESOURCE]
    assert [d.id for d in devices] == [f"nv0-h0-gpu{i}" for i in range(4)]
    attrs = devices[3].attributes
    assert attrs[gp.ATTR_GPU_MODEL] == H100
    assert attrs[gp.ATTR_GPU_MEMORY] == "81559"
    assert attrs[gp.ATTR_GPU_UUID] == "GPU-fake-nv0-h0-3"
    assert attrs[gp.ATTR_GPU_NVLINK_DOMAIN] == "nv0"
    assert attrs[gp.ATTR_DEVICE_INDEX] == "3"
    assert all(d.health == t.DEVICE_HEALTHY for d in devices)


# ----------------------------------------------------------------- health


def test_set_health_flip_reaches_the_manager_store(served_gpu, manager):
    impl = served_gpu[0]
    must_poll_until(lambda: len(_healths(manager)) == 4, desc="devices known")
    impl.set_health("nv0-h0-gpu1", t.DEVICE_UNHEALTHY)
    must_poll_until(lambda: _healths(manager)["nv0-h0-gpu1"] == t.DEVICE_UNHEALTHY,
                    desc="unhealthy in the store")
    impl.set_health("nv0-h0-gpu1", t.DEVICE_HEALTHY)
    must_poll_until(lambda: _healths(manager)["nv0-h0-gpu1"] == t.DEVICE_HEALTHY,
                    desc="healthy again")


def test_device_health_seam_kills_one_card_at_a_time(served_gpu, manager):
    must_poll_until(lambda: len(_healths(manager)) == 4, desc="devices known")
    faultline.activate(5, "device.health=drop")
    try:
        must_poll_until(lambda: list(_healths(manager).values()).count(t.DEVICE_UNHEALTHY) >= 2,
                        desc="the seam's card deaths in the store")
        # each fired pass takes the first healthy card, in inventory order
        assert _healths(manager)["nv0-h0-gpu0"] == t.DEVICE_UNHEALTHY
        assert _healths(manager)["nv0-h0-gpu1"] == t.DEVICE_UNHEALTHY
    finally:
        faultline.deactivate()


def test_faultline_seam_is_seeded_and_refuses_bad_specs():
    def decisions(seed):
        faultline.activate(seed, "device.health=drop@0.5")
        out = []
        for _ in range(64):
            try:
                faultline.check("device.health")
                out.append(0)
            except faultline.FaultInjected:
                out.append(1)
        return out

    try:
        a, b = decisions(3), decisions(3)
        assert a == b and 0 < sum(a) < 64
        assert decisions(4) != a
        faultline.activate(1, "device.health=drop@0")
        faultline.check("device.health")  # probability 0 never fires
        for bad in ("device.health", "device.health=melt", "device.health=drop@2",
                    "device.health=drop@x", "=drop"):
            with pytest.raises(faultline.FaultSpecError):
                faultline.activate(1, bad)
    finally:
        faultline.deactivate()
    assert not faultline.active()
    faultline.check("device.health")  # identity when inactive
    assert issubclass(faultline.FaultInjected, ConnectionError)


def test_vanished_device_node_marks_its_card_unhealthy(plugin_dir, tmp_path, manager):
    nodes = [tmp_path / f"nvidia{i}" for i in range(2)]
    for n in nodes:
        n.write_text("")
    devices = [gp._device(f"host-nvidia{i}", i, H100, "81559", f"GPU-{i}", "host", str(n))
               for i, n in enumerate(nodes)]
    _, server = _serve(plugin_dir, devices)
    try:
        must_poll_until(lambda: len(_healths(manager)) == 2, desc="devices known")
        nodes[1].unlink()
        must_poll_until(lambda: _healths(manager)["host-nvidia1"] == t.DEVICE_UNHEALTHY,
                        desc="vanished node unhealthy")
        assert _healths(manager)["host-nvidia0"] == t.DEVICE_HEALTHY
    finally:
        server.stop()


def test_stopped_plugin_marks_every_card_unhealthy(served_gpu, manager):
    server = served_gpu[1]
    must_poll_until(lambda: len(_healths(manager)) == 4, desc="devices known")
    server.stop()
    assert not os.path.exists(server.socket_path)
    must_poll_until(lambda: set(_healths(manager).values()) == {t.DEVICE_UNHEALTHY},
                    timeout=5.0, desc="all unhealthy after the plugin stopped")


# ---------------------------------------------------------------- admission


def test_admit_pod_paths(served_gpu, manager):
    """tests/test_deviceplugin.py's four paths, for nvidia.com/gpu."""
    impl = served_gpu[0]
    must_poll_until(lambda: manager.has_plugin(GPU_RESOURCE), desc="plugin up")
    must_poll_until(lambda: manager.get_capacity().get(GPU_RESOURCE), desc="devices known")
    res = manager.admit_pod(_gpu_pod("p0", "uid-0", []))
    assert not res.allowed and "no assignment" in res.reason and not res.retriable
    res = manager.admit_pod(_gpu_pod("p1", "uid-1", ["nv0-h0-gpu2", "nv0-h0-gpu3"], 2))
    assert res.allowed, res.reason
    res = manager.admit_pod(_gpu_pod("p2", "uid-2", ["bogus"]))
    assert not res.allowed and "not in local inventory" in res.reason
    impl.set_health("nv0-h0-gpu1", t.DEVICE_UNHEALTHY)
    must_poll_until(lambda: _healths(manager)["nv0-h0-gpu1"] == t.DEVICE_UNHEALTHY,
                    desc="unhealthy propagated")
    res = manager.admit_pod(_gpu_pod("p3", "uid-3", ["nv0-h0-gpu1"]))
    assert not res.allowed and "unhealthy" in res.reason
    assert manager.allocation_latency.count >= 1


def test_plugin_admit_pod_refuses_what_is_not_its_own():
    impl = gp.GPUDevicePlugin(devices=gp._fake_devices(f"{H100}:2:nv0:0"))
    assert impl.admit_pod({"pod_uid": "a", "assignments": {"g": ["nv0-h0-gpu1"]}}) == {
        "allowed": True}
    assert impl.admit_pod({"pod_uid": "b", "assignments": {"g": ["nv0-h1-gpu0"]}}) == {
        "allowed": False, "reason": "device nv0-h1-gpu0 not on this node"}
    impl.set_health("nv0-h0-gpu0", gp.DEVICE_UNHEALTHY)
    assert impl.admit_pod({"pod_uid": "c", "assignments": {"g": ["nv0-h0-gpu0"]}}) == {
        "allowed": False, "reason": "device nv0-h0-gpu0 unhealthy"}


# ---------------------------------------------------------------- injection


def test_init_container_fake_mode_env_with_multi_host_annotations():
    impl = gp.GPUDevicePlugin(devices=gp._fake_devices(f"{H100}:4:nv0:1"))
    spec = impl.init_container({
        "pod_uid": "u", "container_name": "train",
        "device_ids": ["nv0-h1-gpu1", "nv0-h1-gpu3", "elsewhere"],
        "pod_annotations": {
            gp.ANN_WORKER_ID: "2",
            gp.ANN_COORDINATOR: "bert-0.bert:29500",
            gp.ANN_WORKER_HOSTNAMES: "bert-0.bert,bert-1.bert,bert-2.bert,bert-3.bert",
        }})
    assert spec.envs == {
        "CUDA_VISIBLE_DEVICES": "1,3", "NVIDIA_VISIBLE_DEVICES": "1,3",
        "CUDA_DEVICE_ORDER": "PCI_BUS_ID", "RANK": "2", "LOCAL_RANK": "0",
        "MASTER_ADDR": "bert-0.bert", "MASTER_PORT": "29500", "WORLD_SIZE": "4"}
    assert spec.devices == [] and spec.mounts == []
    assert spec.annotations == {"gpu.ktpu.io/injected": "true"}


# What the JAX Job controller stamps on index 1 of a 2-worker Indexed Job
# named bert in namespace default (kubernetes1_tpu/controllers/job.py).
JOB_ANNOTATIONS = {
    "tpu.ktpu.io/worker-id": "1",
    "tpu.ktpu.io/coordinator-address": "bert-0.default:8476",
    "tpu.ktpu.io/worker-hostnames": "bert-0.default,bert-1.default",
}


def test_job_controller_keys_are_the_jax_packages():
    from kubernetes1_tpu.controllers.job import COORDINATOR_PORT
    from kubernetes1_tpu.deviceplugin import tpu_plugin as jtp

    assert (gp.JOB_ANN_WORKER_ID, gp.JOB_ANN_COORDINATOR, gp.JOB_ANN_WORKER_HOSTNAMES) == (
        jtp.ANN_WORKER_ID, jtp.ANN_COORDINATOR, jtp.ANN_WORKER_HOSTNAMES)
    assert set(JOB_ANNOTATIONS) == {jtp.ANN_WORKER_ID, jtp.ANN_COORDINATOR,
                                    jtp.ANN_WORKER_HOSTNAMES}
    assert COORDINATOR_PORT == 8476


def test_init_container_reads_the_job_controllers_annotations():
    """An Indexed Job's worker gets its rank, world and coordinator from
    the keys the Job controller writes, with no gpu.ktpu.io key."""
    impl = gp.GPUDevicePlugin(devices=gp._fake_devices(f"{H100}:2:nv0:0"))
    spec = impl.init_container({"device_ids": ["nv0-h0-gpu0", "nv0-h0-gpu1"],
                                "pod_annotations": JOB_ANNOTATIONS})
    assert spec.envs == {
        "CUDA_VISIBLE_DEVICES": "0,1", "NVIDIA_VISIBLE_DEVICES": "0,1",
        "CUDA_DEVICE_ORDER": "PCI_BUS_ID", "RANK": "1", "LOCAL_RANK": "0",
        "MASTER_ADDR": "bert-0.default", "MASTER_PORT": "8476", "WORLD_SIZE": "2"}


GPU_OVERRIDES = {
    "worker-id": ({gp.ANN_WORKER_ID: "3"}, {"RANK": "3"}),
    "coordinator": ({gp.ANN_COORDINATOR: "10.0.0.7:29500"},
                    {"MASTER_ADDR": "10.0.0.7", "MASTER_PORT": "29500"}),
    "hostnames": ({gp.ANN_WORKER_HOSTNAMES: "a,b,c,d"}, {"WORLD_SIZE": "4"}),
}


@pytest.mark.parametrize("key", sorted(GPU_OVERRIDES))
def test_gpu_annotations_take_precedence_over_the_job_controllers(key):
    """Key by key: a gpu.ktpu.io key beside the Job controller's wins, and
    the other two still come from the Job controller's."""
    impl = gp.GPUDevicePlugin(devices=gp._fake_devices(f"{H100}:1:nv0:0"))
    gpu_ann, want = GPU_OVERRIDES[key]
    spec = impl.init_container({"device_ids": ["nv0-h0-gpu0"],
                                "pod_annotations": {**JOB_ANNOTATIONS, **gpu_ann}})
    job_env = {"RANK": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "bert-0.default",
               "MASTER_PORT": "8476", "WORLD_SIZE": "2"}
    assert spec.envs == {"CUDA_VISIBLE_DEVICES": "0", "NVIDIA_VISIBLE_DEVICES": "0",
                         "CUDA_DEVICE_ORDER": "PCI_BUS_ID", **job_env, **want}


def test_init_container_real_mode_names_cards_by_uuid_with_their_nodes(tmp_path, monkeypatch):
    nodes = {name: tmp_path / name for name in ("nvidia0", "nvidia1", "nvidiactl", "nvidia-uvm")}
    for n in nodes.values():
        n.write_text("")
    monkeypatch.setattr(gp, "CONTROL_NODES", (str(nodes["nvidiactl"]), str(nodes["nvidia-uvm"]),
                                              str(tmp_path / "nvidia-uvm-tools")))
    devices = [gp._device(f"host-nvidia{i}", i, H100, "81559", f"GPU-uuid-{i}", "host",
                          str(nodes[f"nvidia{i}"])) for i in range(2)]
    impl = gp.GPUDevicePlugin(devices=devices)
    spec = impl.init_container({"device_ids": ["host-nvidia1"], "pod_annotations": {}})
    assert spec.envs == {"CUDA_VISIBLE_DEVICES": "GPU-uuid-1",
                         "NVIDIA_VISIBLE_DEVICES": "GPU-uuid-1",
                         "CUDA_DEVICE_ORDER": "PCI_BUS_ID"}
    assert [(d.host_path, d.container_path, d.permissions) for d in spec.devices] == [
        (str(nodes["nvidia1"]), str(nodes["nvidia1"]), "rw"),
        (str(nodes["nvidiactl"]), str(nodes["nvidiactl"]), "rw"),
        (str(nodes["nvidia-uvm"]), str(nodes["nvidia-uvm"]), "rw")]  # uvm-tools is absent
    # the wire form the JAX kubelet decodes
    jspec = japi.ContainerSpec.from_dict(json.loads(json.dumps(spec.to_dict())))
    assert [d.host_path for d in jspec.devices] == [d.host_path for d in spec.devices]


# ---------------------------------------------------------------- discovery


def test_fake_inventory_spec_and_defaults(monkeypatch):
    monkeypatch.setenv("KTPU_FAKE_GPUS", "NVIDIA A100-SXM4-40GB:2:dom:3:40960")
    devices = gp.discover_gpu_devices()
    assert [d["id"] for d in devices] == ["dom-h3-gpu0", "dom-h3-gpu1"]
    assert devices[1]["attributes"] == {
        gp.ATTR_GPU_MODEL: "NVIDIA A100-SXM4-40GB", gp.ATTR_GPU_MEMORY: "40960",
        gp.ATTR_GPU_UUID: "GPU-fake-dom-h3-1", gp.ATTR_GPU_NVLINK_DOMAIN: "dom",
        gp.ATTR_GPU_MINOR: "1", gp.ATTR_SLICE: "dom", gp.ATTR_COORDS: "1",
        gp.ATTR_DEVICE_INDEX: "1"}
    default = gp._fake_devices("")
    assert len(default) == 1 and default[0]["attributes"][gp.ATTR_GPU_MODEL] == H100


def _smi_card(uuid, minor):
    """One <gpu> of ``nvidia-smi -q -x``, trimmed from an H100's."""
    return (f"<gpu id=\"\"><product_name>{H100}</product_name><uuid>{uuid}</uuid>"
            f"<minor_number>{minor}</minor_number><pci><pci_bus_id>N/A</pci_bus_id></pci>"
            "<fb_memory_usage><total>81559 MiB</total><used>0 MiB</used></fb_memory_usage>"
            "<bar1_memory_usage><total>131072 MiB</total></bar1_memory_usage></gpu>")


def topo_m(n, links, link="NV18"):
    """``nvidia-smi topo -m`` for n cards with NVLink between the index
    pairs ``links`` (every other pair over PCIe), as nvidia-smi prints it:
    the header underlined with escape codes, a NIC column, the affinity
    columns and the legends."""
    linked = {frozenset(p) for p in links}
    gpus = [f"GPU{i}" for i in range(n)]
    lines = ["\t\x1b[4m" + "\t".join(gpus + ["NIC0", "CPU Affinity", "NUMA Affinity",
                                             "GPU NUMA ID"]) + "\x1b[0m"]
    for i in range(n):
        cells = [" X " if i == j else (link if frozenset((i, j)) in linked else "SYS")
                 for j in range(n)]
        lines.append("\t".join([f"GPU{i}", *cells, "PXB", "0-47", "0", "", "N/A"]))
    lines.append("\t".join(["NIC0", *["PXB"] * n, " X "]))
    lines += ["", "Legend:", "", "  X    = Self",
              "  SYS  = Connection traversing PCIe as well as the SMP interconnect",
              "  NV#  = Connection traversing a bonded set of # NVLinks", "",
              "NIC Legend:", "", "  NIC0: mlx5_0", ""]
    return "\n".join(lines)


def stand_in_smi(tmp_path, monkeypatch, cards, topo=None):
    """A stand-in nvidia-smi first on PATH: ``-q -x`` prints ``cards``
    (``_smi_card`` elements), ``topo -m`` prints ``topo`` (or fails when it
    is None); each call's arguments are appended to tmp_path/args."""
    smi = tmp_path / "bin" / "nvidia-smi"
    smi.parent.mkdir()
    (tmp_path / "smi.xml").write_text('<?xml version="1.0" ?><nvidia_smi_log>'
                                      f"<attached_gpus>{len(cards)}</attached_gpus>"
                                      + "".join(cards) + "</nvidia_smi_log>")
    topo_case = "topo) echo 'topo: not supported' >&2; exit 3;;"
    if topo is not None:
        (tmp_path / "topo.txt").write_text(topo)
        topo_case = f"topo) cat {tmp_path / 'topo.txt'};;"
    smi.write_text("#!/bin/sh\n"
                   f"echo \"$@\" >> {tmp_path / 'args'}\n"
                   f"case \"$1\" in\n  {topo_case}\n  *) cat {tmp_path / 'smi.xml'};;\nesac\n")
    smi.chmod(0o755)
    monkeypatch.setenv("PATH", f"{smi.parent}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.delenv("KTPU_FAKE_GPUS", raising=False)


def test_real_discovery_walks_device_nodes_and_reads_nvidia_smi(tmp_path, monkeypatch):
    """The chip machine's sandbox shows more nodes than cards, and its one
    card is not the lowest-numbered node (/dev/nvidia0 and /dev/nvidia3,
    card minor 3): each card takes the node of its own minor number, and
    a card whose node is missing is not advertised.  A card with no
    NVLink peer is an NVLink domain of its own, named by its minor, not
    the host."""
    dev = tmp_path / "dev"
    dev.mkdir()
    for n in ("nvidia0", "nvidia3", "nvidiactl"):
        (dev / n).write_text("")
    monkeypatch.setattr(gp, "DEV_DIR", str(dev))
    monkeypatch.delenv("KTPU_DEV_DIR", raising=False)
    stand_in_smi(tmp_path, monkeypatch, [_smi_card("GPU-aaa", 3), _smi_card("GPU-bbb", 5)],
                 topo_m(2, []))
    devices = gp.discover_gpu_devices()
    host = os.uname().nodename
    assert [d["id"] for d in devices] == [f"{host}-nvidia3"]
    assert devices[0]["attributes"] == {
        gp.ATTR_GPU_MODEL: H100, gp.ATTR_GPU_MEMORY: "81559", gp.ATTR_GPU_UUID: "GPU-aaa",
        gp.ATTR_GPU_NVLINK_DOMAIN: f"{host}-nvl3", gp.ATTR_GPU_MINOR: "3",
        gp.ATTR_SLICE: f"{host}-nvl3", gp.ATTR_COORDS: "3", gp.ATTR_DEVICE_INDEX: "0",
        gp.ATTR_DEVICE_PATH: str(dev / "nvidia3")}
    assert (tmp_path / "args").read_text().splitlines() == ["-q -x", "topo -m"]
    # what the pod is handed is that card's node and UUID, not /dev/nvidia0
    spec = gp.GPUDevicePlugin(devices=devices).init_container(
        {"device_ids": [f"{host}-nvidia3"], "pod_annotations": {}})
    assert spec.envs["CUDA_VISIBLE_DEVICES"] == "GPU-aaa"
    assert spec.devices[0].host_path == str(dev / "nvidia3")


# Boards for the NVLink domain: (minors in nvidia-smi's order, NVLink pairs
# of indices, each card's domain by its minor).
BOARDS = {
    # HGX H100: 8 cards on one NVSwitch, every pair NV18
    "nvswitch-8": (list(range(8)), [(i, j) for i in range(8) for j in range(i + 1, 8)],
                   ["nvl0"] * 8),
    # PCIe cards bridged in pairs (0-1, 2-3); minors out of index order
    "bridged-pairs": ([4, 1, 2, 7], [(0, 1), (2, 3)], ["nvl1", "nvl1", "nvl2", "nvl2"]),
    # more than ten cards on one NVSwitch: minor 10 sorts before 2 as a string
    "nvswitch-12": (list(range(12)), [(i, j) for i in range(12) for j in range(i + 1, 12)],
                    ["nvl0"] * 12),
    # a chain 0-1-2 is one domain; the fourth card has no peer
    "chain-and-one-alone": ([0, 1, 2, 3], [(0, 1), (1, 2)], ["nvl0", "nvl0", "nvl0", "nvl3"]),
    "one-card": ([3], [], ["nvl3"]),
}


def board_devices(tmp_path, monkeypatch, board, topo=True):
    """The Python plugin's real-mode discovery of ``board`` behind a
    stand-in nvidia-smi, with KTPU_DEV_DIR holding every card's node."""
    minors, links, _ = BOARDS[board]
    dev = tmp_path / "dev"
    dev.mkdir()
    for m in minors:
        (dev / f"nvidia{m}").write_text("")
    monkeypatch.setenv("KTPU_DEV_DIR", str(dev))
    stand_in_smi(tmp_path, monkeypatch, [_smi_card(f"GPU-{m:04d}", m) for m in minors],
                 topo_m(len(minors), links) if topo else None)
    return gp.discover_gpu_devices()


@pytest.mark.parametrize("board", sorted(BOARDS))
def test_nvlink_domain_is_the_connected_component_of_the_links(tmp_path, monkeypatch, board):
    host = os.uname().nodename
    devices = board_devices(tmp_path, monkeypatch, board)
    assert [d["attributes"][gp.ATTR_GPU_NVLINK_DOMAIN] for d in devices] == [
        f"{host}-{name}" for name in BOARDS[board][2]]
    assert [d["attributes"][gp.ATTR_DEVICE_INDEX] for d in devices] == [
        str(i) for i in range(len(BOARDS[board][0]))]


def test_nvlink_domain_without_topo_is_a_card_of_its_own(tmp_path, monkeypatch):
    """``topo -m`` failing: no card takes the host name, each keeps a
    domain of its own."""
    host = os.uname().nodename
    devices = board_devices(tmp_path, monkeypatch, "nvswitch-8", topo=False)
    assert [d["attributes"][gp.ATTR_GPU_NVLINK_DOMAIN] for d in devices] == [
        f"{host}-nvl{m}" for m in range(8)]
    assert (tmp_path / "args").read_text().splitlines() == ["-q -x", "topo -m"]


def test_nvlink_domains_span_cards_whose_node_is_missing(tmp_path, monkeypatch):
    """The peer graph is every card's: a card bridged through one whose
    node is missing here stays in that card's domain."""
    host = os.uname().nodename
    dev = tmp_path / "dev"
    dev.mkdir()
    (dev / "nvidia5").write_text("")
    monkeypatch.setenv("KTPU_DEV_DIR", str(dev))
    stand_in_smi(tmp_path, monkeypatch, [_smi_card("GPU-a", 2), _smi_card("GPU-b", 5)],
                 topo_m(2, [(0, 1)], link="NV4"))
    (d,) = gp.discover_gpu_devices()
    assert d["attributes"][gp.ATTR_GPU_NVLINK_DOMAIN] == f"{host}-nvl2"
    assert d["attributes"][gp.ATTR_DEVICE_INDEX] == "1"


@pytest.mark.parametrize("board", sorted(BOARDS))
def test_every_card_carries_the_keys_the_scheduler_reads(tmp_path, monkeypatch, board):
    """The JAX scheduler's slice-aware pick reads google.com/tpu/slice and
    google.com/tpu/coords: the card's NVLink domain and its minor."""
    devices = board_devices(tmp_path, monkeypatch, board)
    assert [d["attributes"][gp.ATTR_SLICE] for d in devices] == [
        d["attributes"][gp.ATTR_GPU_NVLINK_DOMAIN] for d in devices]
    assert [d["attributes"][gp.ATTR_COORDS] for d in devices] == [
        str(m) for m in BOARDS[board][0]]


@pytest.mark.parametrize("board", sorted(BOARDS))
def test_every_card_carries_its_minor_for_the_ports_scheduler(tmp_path, monkeypatch, board):
    """The port's scheduler reads nvidia.com/gpu/nvlink-domain and
    nvidia.com/gpu/minor: the minor is the card's, the value the JAX
    scheduler's google.com/tpu/coords carries too."""
    devices = board_devices(tmp_path, monkeypatch, board)
    assert [d["attributes"][gp.ATTR_GPU_MINOR] for d in devices] == [
        str(m) for m in BOARDS[board][0]]
    assert [d["attributes"][gp.ATTR_GPU_MINOR] for d in devices] == [
        d["attributes"][gp.ATTR_COORDS] for d in devices]


def test_gpu_keys_are_the_ports_api_types():
    assert (gp.ATTR_GPU_NVLINK_DOMAIN, gp.ATTR_GPU_MINOR) == (
        torch_types.ATTR_GPU_NVLINK_DOMAIN, torch_types.ATTR_GPU_MINOR)


def test_slice_keys_are_the_jax_packages():
    assert (gp.ATTR_SLICE, gp.ATTR_COORDS) == (t.ATTR_TPU_SLICE, t.ATTR_TPU_CHIP_COORDS)


def test_fake_domain_list_gives_one_domain_a_card():
    """KTPU_FAKE_GPUS's domain field, comma-separated: one name a card,
    the last repeated past the list; the coords (and the minor) are the
    index."""
    devices = gp._fake_devices(f"{H100}:5:nvl-a,nvl-a,nvl-b:2")
    assert [d["id"] for d in devices] == ["nvl-a-h2-gpu0", "nvl-a-h2-gpu1", "nvl-b-h2-gpu2",
                                          "nvl-b-h2-gpu3", "nvl-b-h2-gpu4"]
    assert [(d["attributes"][gp.ATTR_GPU_NVLINK_DOMAIN], d["attributes"][gp.ATTR_SLICE],
             d["attributes"][gp.ATTR_COORDS]) for d in devices] == [
        ("nvl-a", "nvl-a", "0"), ("nvl-a", "nvl-a", "1"), ("nvl-b", "nvl-b", "2"),
        ("nvl-b", "nvl-b", "3"), ("nvl-b", "nvl-b", "4")]
    assert [d["attributes"][gp.ATTR_GPU_MINOR] for d in devices] == ["0", "1", "2", "3", "4"]
    assert [d["attributes"][gp.ATTR_GPU_UUID] for d in devices][2] == "GPU-fake-nvl-b-h2-2"


def node_info(devices) -> NodeInfo:
    """The JAX scheduler's NodeInfo for a node that advertises ``devices``
    (the plugin's dicts, decoded through the JAX scheme as the kubelet's
    status update is)."""
    node = t.Node()
    node.metadata.name = "gpu-node"
    node.status.capacity = {"cpu": "8", "memory": "32Gi", "pods": "110"}
    node.status.allocatable = dict(node.status.capacity)
    node.status.extended_resources = {
        GPU_RESOURCE: [from_dict(t.ExtendedResourceDevice, d) for d in devices]}
    return NodeInfo(node)


def place(info: NodeInfo, name: str, quantity: int) -> list:
    """The JAX scheduler's allocate_for_pod for a pod asking ``quantity``
    cards; the pod is then added to ``info`` with them, as a bind does."""
    pod = _gpu_pod(name, f"uid-{name}", [], quantity)
    assignments, reason = allocate_for_pod(pod, info)
    assert assignments is not None, reason
    pod.spec.extended_resources[0].assigned = assignments["gpu"]
    info.add_pod(pod)
    return assignments["gpu"]


def pair_picks(devices) -> tuple:
    """On the bridged-pairs board: a 2-card pod's cards on the fresh node,
    and on another, a 1-card pod's and then a 2-card pod's."""
    return (place(node_info(devices), "two", 2),
            *(lambda info: (place(info, "one", 1), place(info, "two-after", 2)))(
                node_info(devices)))


def test_scheduler_picks_one_nvlink_pair_on_bridged_pairs(tmp_path, monkeypatch):
    """nvl1 = {4, 1}, nvl2 = {2, 7}: a 2-card pod gets one pair, never a
    card of each (whose traffic would cross PCIe); after a 1-card pod took
    one card of nvl1, the next 2-card pod gets the intact pair nvl2."""
    host = os.uname().nodename
    two, one, two_after = pair_picks(board_devices(tmp_path, monkeypatch, "bridged-pairs"))
    assert two == [f"{host}-nvidia1", f"{host}-nvidia4"]
    assert one == [f"{host}-nvidia1"]
    assert two_after == [f"{host}-nvidia2", f"{host}-nvidia7"]


def test_scheduler_picks_cards_in_minor_order_past_ten(tmp_path, monkeypatch):
    """Twelve cards on one NVSwitch: a 4-card pod gets minors 0-3, in
    numeric order (the IDs' string order would give nvidia10 and
    nvidia11 before nvidia2)."""
    host = os.uname().nodename
    info = node_info(board_devices(tmp_path, monkeypatch, "nvswitch-12"))
    assert place(info, "four", 4) == [f"{host}-nvidia{m}" for m in range(4)]
    assert place(info, "four-more", 4) == [f"{host}-nvidia{m}" for m in range(4, 8)]


def test_pod_affinity_slice_topology_is_the_nvlink_domain(tmp_path, monkeypatch):
    """The pod-affinity topology key google.com/tpu-slice: a node whose
    cards share one NVLink domain has that domain as its value; a node of
    two domains has none."""
    host = os.uname().nodename
    assert node_topology_value(node_info(gp._fake_devices(f"{H100}:8:nvl-x:0")),
                               TOPOLOGY_TPU_SLICE) == "nvl-x"
    assert node_topology_value(node_info(gp._fake_devices(f"{H100}:4:a,a,b,b:0")),
                               TOPOLOGY_TPU_SLICE) is None
    (d,) = board_devices(tmp_path, monkeypatch, "one-card")
    assert node_topology_value(node_info([d]), TOPOLOGY_TPU_SLICE) == f"{host}-nvl3"


def test_real_discovery_without_a_card_advertises_none(monkeypatch, tmp_path):
    monkeypatch.delenv("KTPU_FAKE_GPUS", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))  # no nvidia-smi
    assert gp.discover_gpu_devices() == []
    assert gp.smi_cards() == []


def test_plugin_main_registers_and_removes_its_socket_on_sigterm(plugin_dir, tmp_path, manager):
    log = open(tmp_path / "plugin.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubernetes1_tpu_torch.deviceplugin",
         "--plugin-dir", plugin_dir],
        env={**os.environ, "KTPU_FAKE_GPUS": f"{H100}:2:nv0:0"}, stdout=log,
        stderr=subprocess.STDOUT)
    try:
        must_poll_until(lambda: len(_healths(manager)) == 2, timeout=30.0,
                        desc="the plugin process's cards in the store")
        sock = tapi.plugin_socket_path(plugin_dir, GPU_RESOURCE)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=15) == 0
        assert not os.path.exists(sock)
        must_poll_until(lambda: set(_healths(manager).values()) == {t.DEVICE_UNHEALTHY},
                        timeout=5.0, desc="cards unhealthy after the plugin exited")
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=5)
        log.close()
    said = (tmp_path / "plugin.log").read_text()
    assert "advertising 2 card(s)" in said and "nv0-h0-gpu1" in said
    assert "Warning" not in said  # the entry loads the plugin's module once


def test_the_plugin_imports_no_torch_and_no_jax():
    """The plugin never initialises CUDA: it does not even import torch
    (a context in its process would hold memory on the card a pod needs)."""
    code = ("import sys, kubernetes1_tpu_torch.deviceplugin.gpu_plugin; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('torch', 'jax', 'kubernetes1_tpu', 'numpy')))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "[]", res.stdout + res.stderr
