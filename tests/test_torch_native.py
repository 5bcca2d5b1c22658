"""The port's native node components against the Python plugin.

``ktpu-gpu-plugin`` (``kubernetes1_tpu_torch/native/gpu_plugin.cc``) must
speak the 4-RPC protocol to the port's ``PluginClient`` and give, in fake
mode, the inventory, admission and injection of the Python
``GPUDevicePlugin`` (plus the ``gpu.ktpu.io/plugin: native`` annotation);
SIGTERM or SIGINT must take its socket with it.  In real mode over a
stand-in ``libnvidia-ml.so.1`` (built here with g++), its inventory,
NVLink domains included (and the slice and coords keys the JAX
scheduler reads), must equal the Python plugin's over a stand-in
``nvidia-smi``, and the JAX scheduler must pick one NVLink pair from it.  Both binaries must refuse real mode on a host without NVML, and ``ktpu-gpu-metrics-exporter`` must
serve the GPU forms of the TPU exporter's metrics, with no reading in fake
mode.  The binaries are built once per test run, with make, into a
temporary directory of their own.
"""

import ctypes.util
import os
import re
import signal
import subprocess
import time
import urllib.error
import urllib.request
from contextlib import contextmanager

import pytest

from kubernetes1_tpu_torch import GPU_RESOURCE, native
from kubernetes1_tpu_torch.deviceplugin import gpu_plugin as gp
from kubernetes1_tpu_torch.deviceplugin.api import PluginClient, plugin_socket_path
from tests.test_torch_deviceplugin import BOARDS, board_devices, pair_picks

H100 = "NVIDIA H100 80GB HBM3"
NATIVE_ANNOTATION = "gpu.ktpu.io/plugin"
HAS_NVML = ctypes.util.find_library("nvidia-ml") is not None


@pytest.fixture(scope="session")
def native_bins(tmp_path_factory):
    bins = native.build(str(tmp_path_factory.mktemp("native-bin")))
    assert all(os.access(path, os.X_OK) for path in bins.values()), bins
    return bins


def _fake_env(fake):
    env = {k: v for k, v in os.environ.items() if k != "KTPU_FAKE_GPUS"}
    if fake is not None:
        env["KTPU_FAKE_GPUS"] = fake
    return env


@contextmanager
def native_plugin(binary, plugin_dir, fake):
    """The native plugin in fake mode, with a client on its socket."""
    proc = subprocess.Popen([binary, "--plugin-dir", str(plugin_dir)], env=_fake_env(fake),
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    sock = plugin_socket_path(str(plugin_dir), GPU_RESOURCE)
    client = PluginClient(sock)
    try:
        deadline = time.monotonic() + 10
        while not os.path.exists(sock):
            assert proc.poll() is None, f"the plugin exited {proc.returncode}"
            assert time.monotonic() < deadline, "the plugin's socket never appeared"
            time.sleep(0.02)
        yield client, proc
    finally:
        client.close()
        if proc.poll() is None:
            proc.terminate()
        proc.wait(timeout=10)


def first_inventory(client):
    stream = client.list_and_watch()
    try:
        return next(stream)
    finally:
        stream.close()


def test_four_rpcs_over_the_ports_plugin_client(native_bins, tmp_path):
    with native_plugin(native_bins[native.PLUGIN], tmp_path, f"{H100}:4:nvZ:1") as (client, _):
        assert client.call("GetPluginInfo") == {"name": GPU_RESOURCE, "version": "v1",
                                                "device_count": 4, "native": True}
        devices = first_inventory(client)
        assert [d["id"] for d in devices] == [f"nvZ-h1-gpu{i}" for i in range(4)]
        assert all(d["health"] == gp.DEVICE_HEALTHY for d in devices)
        ok = client.call("AdmitPod", {"pod_uid": "u1",
                                      "assignments": {"req": ["nvZ-h1-gpu0", "nvZ-h1-gpu3"]}})
        assert ok == {"allowed": True}
        spec = client.call("InitContainer", {"device_ids": ["nvZ-h1-gpu2", "nvZ-h1-gpu0"]})
        assert spec["envs"]["CUDA_VISIBLE_DEVICES"] == "2,0"
        assert spec["annotations"] == {gp.ANN_INJECTED: "true", NATIVE_ANNOTATION: "native"}
        with pytest.raises(RuntimeError, match="unknown method"):
            client.call("Bogus")


@pytest.mark.parametrize("fake", [
    "::::",                                   # every field at the Python default
    f"{H100}:1:nv0:0",
    "NVIDIA A100-SXM4-40GB:2:nva:3:40960",   # the memory field
    f"{H100}:8:nvlink-7:2",
    f"{H100}:4:nvl-a,nvl-a,nvl-b,nvl-b:0",   # a domain a card
    f"{H100}:3:nvl-x,nvl-y:1",               # the last domain past the list
], ids=["defaults", "one-card", "memory-field", "eight-cards", "domain-a-card",
        "domain-list-short"])
def test_fake_inventory_equals_the_python_plugins(native_bins, tmp_path, fake):
    with native_plugin(native_bins[native.PLUGIN], tmp_path, fake) as (client, _):
        devices = first_inventory(client)
        info = client.call("GetPluginInfo")
    want = gp.GPUDevicePlugin(devices=gp._fake_devices(fake))
    assert devices == want.list_devices()
    assert info == {**want.get_plugin_info(), "native": True}


INIT_PARAMS = {
    "no-annotations": {"device_ids": ["nv0-h0-gpu1", "nv0-h0-gpu0"]},
    "worker-coordinator-hostnames": {
        "device_ids": ["nv0-h0-gpu1"],
        "pod_annotations": {gp.ANN_WORKER_ID: "5", gp.ANN_COORDINATOR: "host0:29500",
                            gp.ANN_WORKER_HOSTNAMES: "host0,host1,,host2"}},
    "coordinator-without-port": {
        "device_ids": ["nv0-h0-gpu0"],
        "pod_annotations": {gp.ANN_COORDINATOR: "host0", gp.ANN_WORKER_HOSTNAMES: ""}},
    "unknown-id": {"device_ids": ["ghost", "nv0-h0-gpu1"]},
    # the keys the Job controller stamps on an Indexed Job's pod
    "job-controller-keys": {
        "device_ids": ["nv0-h0-gpu0", "nv0-h0-gpu1"],
        "pod_annotations": {"tpu.ktpu.io/worker-id": "1",
                            "tpu.ktpu.io/coordinator-address": "bert-0.default:8476",
                            "tpu.ktpu.io/worker-hostnames": "bert-0.default,bert-1.default"}},
    # a gpu.ktpu.io key beside the Job controller's wins, key by key
    "gpu-keys-over-job-keys": {
        "device_ids": ["nv0-h0-gpu1"],
        "pod_annotations": {"tpu.ktpu.io/worker-id": "1",
                            "tpu.ktpu.io/coordinator-address": "bert-0.default:8476",
                            "tpu.ktpu.io/worker-hostnames": "bert-0.default,bert-1.default",
                            gp.ANN_WORKER_ID: "3", gp.ANN_WORKER_HOSTNAMES: "a,b,c,d"}},
}


@pytest.mark.parametrize("params", INIT_PARAMS.values(), ids=INIT_PARAMS.keys())
def test_init_container_equals_the_python_plugins(native_bins, tmp_path, params):
    fake = f"{H100}:2:nv0:0"
    with native_plugin(native_bins[native.PLUGIN], tmp_path, fake) as (client, _):
        got = client.call("InitContainer", params)
    assert got["annotations"].pop(NATIVE_ANNOTATION) == "native"
    want = gp.GPUDevicePlugin(devices=gp._fake_devices(fake)).init_container(params).to_dict()
    assert got == want


def test_admit_pod_refuses_an_id_not_on_the_node(native_bins, tmp_path):
    fake = f"{H100}:2:nv0:0"
    params = {"pod_uid": "u2", "assignments": {"req": ["nv0-h0-gpu0", "ghost"]}}
    with native_plugin(native_bins[native.PLUGIN], tmp_path, fake) as (client, _):
        got = client.call("AdmitPod", params)
    assert got == {"allowed": False, "reason": "device ghost not on this node"}
    assert got == gp.GPUDevicePlugin(devices=gp._fake_devices(fake)).admit_pod(params)


@pytest.mark.parametrize("signum", [signal.SIGTERM, signal.SIGINT], ids=["SIGTERM", "SIGINT"])
def test_a_stop_signal_removes_the_socket_and_exits_0(native_bins, tmp_path, signum):
    sock = plugin_socket_path(str(tmp_path), GPU_RESOURCE)
    with native_plugin(native_bins[native.PLUGIN], tmp_path, f"{H100}:1:nv0:0") as (client,
                                                                                   proc):
        assert client.call("GetPluginInfo")["device_count"] == 1
        client.close()
        proc.send_signal(signum)
        assert proc.wait(timeout=10) == 0
        assert not os.path.exists(sock)


@pytest.mark.skipif(HAS_NVML, reason="this host has NVML: real mode would find its cards")
@pytest.mark.parametrize("binary", [native.PLUGIN, native.EXPORTER])
def test_real_mode_without_nvml_exits_non_zero_with_the_reason(native_bins, tmp_path, binary):
    res = subprocess.run([native_bins[binary], "--plugin-dir", str(tmp_path), "--port", "0"],
                         env=_fake_env(None), capture_output=True, text=True, timeout=30)
    assert res.returncode != 0
    assert "real mode needs NVML" in res.stderr and "libnvidia-ml.so.1" in res.stderr
    assert res.stdout == ""
    assert not os.path.exists(plugin_socket_path(str(tmp_path), GPU_RESOURCE))


SAMPLE = re.compile(r'^(\w+)\{((?:\w+="[^"]*",?)*)\} (\S+)$')
CARD_METRICS = {"ktpu_gpu_cards", "ktpu_gpu_card_healthy", "ktpu_gpu_cards_healthy"}


def _fetch(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
        return resp.read().decode()


def test_exporter_fake_mode_exposition(native_bins):
    fake = "NVIDIA A100-SXM4-40GB:3:nvq:2"
    proc = subprocess.Popen([native_bins[native.EXPORTER], "--port", "0"], env=_fake_env(fake),
                            stdout=subprocess.PIPE, text=True)
    try:
        port = int(proc.stdout.readline().strip().rsplit(":", 1)[1])
        text = _fetch(port, "/metrics")
        healthz = _fetch(port, "/healthz")
        with pytest.raises(urllib.error.HTTPError) as missing:
            _fetch(port, "/nowhere")
    finally:
        proc.terminate()
        proc.wait(timeout=10)
        proc.stdout.close()
    missing.value.close()
    assert healthz == "ok\n" and missing.value.code == 404
    samples, described = [], set()
    for line in text.splitlines():
        if line.startswith("# "):
            kind, name = line.split()[1:3]
            assert kind in ("HELP", "TYPE")
            described.add(name)
            continue
        m = SAMPLE.match(line)
        assert m, f"not a sample line: {line!r}"
        labels = dict(re.findall(r'(\w+)="([^"]*)"', m.group(2)))
        samples.append((m.group(1), labels, float(m.group(3))))
    assert described == CARD_METRICS  # no reading in fake mode, not even its HELP
    host = os.uname().nodename
    want_cards = gp._fake_devices(fake)
    assert samples == [
        ("ktpu_gpu_cards", {"host": host}, 3.0),
        *[("ktpu_gpu_card_healthy",
           {"host": host, "card": d["id"], "uuid": d["attributes"][gp.ATTR_GPU_UUID],
            "model": "NVIDIA A100-SXM4-40GB"}, 1.0) for d in want_cards],
        ("ktpu_gpu_cards_healthy", {"host": host}, 3.0),
    ]


# ------------------------------------------------ real mode over a stand-in NVML

# A stand-in libnvidia-ml.so.1: the thirteen calls the binaries resolve,
# over cards given by the environment (STANDIN_NVML_MINORS "4,1,2,7": the
# cards' minors in index order; STANDIN_NVML_LINKS "0-1,2-3": NVLink pairs
# of indices).  Built without nvmlDeviceGetP2PStatus under -DNO_P2P.
STANDIN_NVML = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <stdint.h>
struct Mem { unsigned long long total, free, used; };
struct Util { unsigned int gpu, memory; };
static unsigned minors(unsigned* out) {
  const char* s = getenv("STANDIN_NVML_MINORS");
  unsigned n = 0;
  while (s && *s) { out[n++] = strtoul(s, (char**)&s, 10); if (*s == ',') ++s; }
  return n;
}
static unsigned idx(void* h) { return (unsigned)(uintptr_t)h - 1; }
extern "C" {
int nvmlInit_v2() { return 0; }
int nvmlShutdown() { return 0; }
int nvmlDeviceGetCount_v2(unsigned* n) { unsigned m[64]; *n = minors(m); return 0; }
int nvmlDeviceGetHandleByIndex_v2(unsigned i, void** h) { *h = (void*)(uintptr_t)(i + 1); return 0; }
int nvmlDeviceGetMinorNumber(void* h, unsigned* minor) {
  unsigned m[64]; minors(m); *minor = m[idx(h)]; return 0;
}
int nvmlDeviceGetUUID(void* h, char* buf, unsigned len) {
  unsigned m[64]; minors(m); snprintf(buf, len, "GPU-%04u", m[idx(h)]); return 0;
}
int nvmlDeviceGetName(void*, char* buf, unsigned len) {
  snprintf(buf, len, "NVIDIA H100 80GB HBM3"); return 0;
}
int nvmlDeviceGetMemoryInfo(void*, Mem* mem) {
  mem->total = 81559ull << 20; mem->free = mem->total; mem->used = 0; return 0;
}
int nvmlDeviceGetUtilizationRates(void*, Util* u) { u->gpu = u->memory = 0; return 0; }
int nvmlDeviceGetPowerUsage(void*, unsigned* mw) { *mw = 70000; return 0; }
int nvmlDeviceGetEnforcedPowerLimit(void*, unsigned* mw) { *mw = 700000; return 0; }
int nvmlDeviceGetTemperature(void*, int, unsigned* c) { *c = 30; return 0; }
#ifndef NO_P2P
int nvmlDeviceGetP2PStatus(void* a, void* b, int caps, int* status) {
  unsigned i = idx(a), j = idx(b), x, y;
  const char* s = getenv("STANDIN_NVML_LINKS");
  *status = 5;  // NVML_P2P_STATUS_NOT_SUPPORTED
  while (caps == 2 && s && sscanf(s, "%u-%u", &x, &y) == 2) {
    if ((x == i && y == j) || (x == j && y == i)) *status = 0;
    s = strchr(s, ',');
    if (s) ++s;
  }
  return 0;
}
#endif
}
"""


@pytest.fixture(scope="module")
def standin_nvml(tmp_path_factory):
    """{"p2p": dir, "no-p2p": dir}, each holding a stand-in libnvidia-ml.so.1."""
    root = tmp_path_factory.mktemp("standin-nvml")
    src = root / "nvml.cc"
    src.write_text(STANDIN_NVML)
    dirs = {}
    for name, flags in (("p2p", []), ("no-p2p", ["-DNO_P2P"])):
        (root / name).mkdir()
        subprocess.run(["g++", "-shared", "-fPIC", "-O1", *flags, "-o",
                        str(root / name / "libnvidia-ml.so.1"), str(src)], check=True,
                       timeout=120)
        dirs[name] = str(root / name)
    return dirs


@pytest.mark.parametrize("board", sorted(BOARDS))
def test_real_mode_inventory_over_nvml_equals_the_python_plugins(
        native_bins, standin_nvml, tmp_path, monkeypatch, board):
    """The native plugin's real mode over a stand-in NVML (the cards'
    NVLink pairs from nvmlDeviceGetP2PStatus) and the Python plugin's over
    a stand-in nvidia-smi (``topo -m``) give the same inventory, NVLink
    domains included, for an NVSwitch board, bridged pairs, a chain
    beside a card alone, and one card."""
    minors, links, names = BOARDS[board]
    want = board_devices(tmp_path, monkeypatch, board)
    env = {**_fake_env(None), "KTPU_DEV_DIR": os.environ["KTPU_DEV_DIR"],
           "LD_LIBRARY_PATH": standin_nvml["p2p"],
           "STANDIN_NVML_MINORS": ",".join(map(str, minors)),
           "STANDIN_NVML_LINKS": ",".join(f"{i}-{j}" for i, j in links)}
    with native_real_plugin(native_bins[native.PLUGIN], tmp_path / "plugins", env) as client:
        devices = first_inventory(client)
    host = os.uname().nodename
    assert [d["attributes"][gp.ATTR_GPU_NVLINK_DOMAIN] for d in devices] == [
        f"{host}-{n}" for n in names]
    assert devices == want


@pytest.mark.parametrize("board", sorted(BOARDS))
def test_real_mode_minor_equals_the_python_plugins(
        native_bins, standin_nvml, tmp_path, monkeypatch, board):
    """nvidia.com/gpu/minor, the key the port's scheduler orders cards by,
    is each card's NVML minor in the native inventory and its nvidia-smi
    minor in the Python one."""
    minors, links, _ = BOARDS[board]
    want = board_devices(tmp_path, monkeypatch, board)
    env = {**_fake_env(None), "KTPU_DEV_DIR": os.environ["KTPU_DEV_DIR"],
           "LD_LIBRARY_PATH": standin_nvml["p2p"],
           "STANDIN_NVML_MINORS": ",".join(map(str, minors)),
           "STANDIN_NVML_LINKS": ",".join(f"{i}-{j}" for i, j in links)}
    with native_real_plugin(native_bins[native.PLUGIN], tmp_path / "plugins", env) as client:
        devices = first_inventory(client)
    got = [d["attributes"][gp.ATTR_GPU_MINOR] for d in devices]
    assert got == [d["attributes"][gp.ATTR_GPU_MINOR] for d in want] == [str(m) for m in minors]


def test_scheduler_picks_one_nvlink_pair_from_the_native_inventory(
        native_bins, standin_nvml, tmp_path, monkeypatch):
    """The bridged-pairs board through the native plugin's real mode: the
    JAX scheduler's allocate_for_pod gives a 2-card pod one pair, and
    after a 1-card pod the intact pair."""
    minors, links, _ = BOARDS["bridged-pairs"]
    board_devices(tmp_path, monkeypatch, "bridged-pairs")
    env = {**_fake_env(None), "KTPU_DEV_DIR": os.environ["KTPU_DEV_DIR"],
           "LD_LIBRARY_PATH": standin_nvml["p2p"],
           "STANDIN_NVML_MINORS": ",".join(map(str, minors)),
           "STANDIN_NVML_LINKS": ",".join(f"{i}-{j}" for i, j in links)}
    with native_real_plugin(native_bins[native.PLUGIN], tmp_path / "plugins", env) as client:
        devices = first_inventory(client)
    host = os.uname().nodename
    assert pair_picks(devices) == ([f"{host}-nvidia1", f"{host}-nvidia4"], [f"{host}-nvidia1"],
                                   [f"{host}-nvidia2", f"{host}-nvidia7"])


def test_real_mode_without_the_p2p_call_gives_each_card_its_own_domain(
        native_bins, standin_nvml, tmp_path, monkeypatch):
    minors, links, _ = BOARDS["nvswitch-8"]
    board_devices(tmp_path, monkeypatch, "nvswitch-8")
    env = {**_fake_env(None), "KTPU_DEV_DIR": os.environ["KTPU_DEV_DIR"],
           "LD_LIBRARY_PATH": standin_nvml["no-p2p"],
           "STANDIN_NVML_MINORS": ",".join(map(str, minors)),
           "STANDIN_NVML_LINKS": ",".join(f"{i}-{j}" for i, j in links)}
    with native_real_plugin(native_bins[native.PLUGIN], tmp_path / "plugins", env) as client:
        devices = first_inventory(client)
    host = os.uname().nodename
    assert [d["attributes"][gp.ATTR_GPU_NVLINK_DOMAIN] for d in devices] == [
        f"{host}-nvl{m}" for m in minors]


@contextmanager
def native_real_plugin(binary, plugin_dir, env):
    """The native plugin in real mode under ``env``, with a client on its socket."""
    proc = subprocess.Popen([binary, "--plugin-dir", str(plugin_dir)], env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    sock = plugin_socket_path(str(plugin_dir), GPU_RESOURCE)
    client = PluginClient(sock)
    try:
        deadline = time.monotonic() + 10
        while not os.path.exists(sock):
            assert proc.poll() is None, f"the plugin exited {proc.returncode}: " \
                                        f"{proc.stderr.read()}"
            assert time.monotonic() < deadline, "the plugin's socket never appeared"
            time.sleep(0.02)
        yield client
    finally:
        client.close()
        if proc.poll() is None:
            proc.terminate()
        proc.wait(timeout=10)
        proc.stderr.close()
