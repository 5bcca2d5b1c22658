"""NVIDIA GPU device plugin: advertises ``nvidia.com/gpu`` cards with their
model, memory and UUID, and hands a card to a container through
``CUDA_VISIBLE_DEVICES`` and its ``/dev/nvidia*`` nodes.

The port's counterpart of the JAX package's ``deviceplugin/tpu_plugin.py``,
served over the same 4-RPC socket protocol (``api.py``), so an unchanged
kubelet discovers it, admits pods against it and merges what it injects:

  CUDA_VISIBLE_DEVICES,    the cards this container owns: their UUIDs
  NVIDIA_VISIBLE_DEVICES   (a card with a node on this host), else their
                           indices (fake mode)
  CUDA_DEVICE_ORDER        PCI_BUS_ID
  RANK, LOCAL_RANK         a multi-host Job's worker index (the pod's
                           worker-id annotation); one process a pod, so
                           LOCAL_RANK is 0
  MASTER_ADDR, MASTER_PORT the coordinator (coordinator-address,
                           "host:port", split at the last colon)
  WORLD_SIZE               the number of worker-hostnames

from the annotations that the Job controller stamps on each pod of an
Indexed Job (tpu.ktpu.io/worker-id, /coordinator-address,
/worker-hostnames: the completion index, ``<job>-0.<ns>:8476`` and every
worker's name) or, taking precedence key by key, the gpu.ktpu.io/ keys of
the same names,

the variables ``torch.distributed``'s ``env://`` start reads (the port's
``sharding.init_from_env``), in place of the TPU plugin's TPU_WORKER_ID
and JAX_COORDINATOR_ADDRESS.

Discovery modes:
- real: one ``nvidia-smi -q -x`` call lists each card with its UUID,
  name, memory and minor number N, the N of its node /dev/nvidiaN (the
  legacy GPU manager's /dev/nvidia* walk, keyed by the card's own node); a
  card is advertised only when its node exists.  A container may show more
  nodes than cards, and the card need not be the lowest-numbered node.
  One ``nvidia-smi topo -m`` call gives the NVLink peer graph: a card's
  NVLink domain is the connected component that holds it, named
  ``<host>-nvl<lowest minor in it>`` (the 8 cards on one NVSwitch board
  are one domain; PCIe cards bridged in pairs are a domain a pair); a
  card with no NVLink peer, or with ``topo -m`` failing, is a domain of
  its own.  The plugin never initialises CUDA: a context in its process
  would hold memory on the card that the pod needs.
- fake: KTPU_FAKE_GPUS="<model>:<count>:<domain>:<host index>[:<memory MiB>]"
  makes an inventory without a card, for tests and hollow nodes.  The
  domain field is one name for every card, or one a card, comma-separated
  (``nvl-a,nvl-a,nvl-b,nvl-b``); cards past the list take its last name.

Every card carries its NVLink domain (nvidia.com/gpu/nvlink-domain) and
its minor (nvidia.com/gpu/minor; its index in fake mode), which the port's
scheduler reads: a pod's cards are picked best-fit within one domain, in
order of the minor, and a gang goes to one domain when one holds it.  The
same two also go under the keys the JAX scheduler's slice-aware
allocation reads (google.com/tpu/slice and google.com/tpu/coords, the JAX
package's strings, copied), for the clusters that still run it.

Run it as ``python -m kubernetes1_tpu_torch.deviceplugin --plugin-dir D``.
"""

from __future__ import annotations

import os
import re
import signal
import subprocess
import threading
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

from .. import GPU_RESOURCE
from ..utils import faultline
from .api import (
    DEFAULT_PLUGIN_DIR,
    ContainerSpec,
    DeviceSpec,
    PluginServer,
    plugin_socket_path,
)

DEVICE_HEALTHY = "Healthy"
DEVICE_UNHEALTHY = "Unhealthy"

ATTR_GPU_MODEL = "nvidia.com/gpu/model"            # e.g. "NVIDIA H100 80GB HBM3"
ATTR_GPU_MEMORY = "nvidia.com/gpu/memory"          # MiB
ATTR_GPU_UUID = "nvidia.com/gpu/uuid"
ATTR_GPU_NVLINK_DOMAIN = "nvidia.com/gpu/nvlink-domain"
ATTR_GPU_MINOR = "nvidia.com/gpu/minor"            # the minor; the index when fake
# The keys the JAX scheduler's slice-aware allocation reads (its devices.py
# pick_devices, priorities.py slice_packing, scheduler.py _place_gang): the
# interconnect domain, and the position within it as integers joined by
# commas.  The JAX package's strings (api/types.py), copied.
ATTR_SLICE = "google.com/tpu/slice"
ATTR_COORDS = "google.com/tpu/coords"
ATTR_DEVICE_INDEX = "ktpu.io/device-index"
ATTR_DEVICE_PATH = "ktpu.io/device-path"

# Pod annotations the plugin consumes: the gpu.ktpu.io keys (set by a
# Job's author), else the keys of the same names that the Job controller
# stamps on each pod of an Indexed Job (tpu.ktpu.io, the JAX package's
# strings, copied).
ANN_WORKER_ID = "gpu.ktpu.io/worker-id"
ANN_COORDINATOR = "gpu.ktpu.io/coordinator-address"
ANN_WORKER_HOSTNAMES = "gpu.ktpu.io/worker-hostnames"
JOB_ANN_WORKER_ID = "tpu.ktpu.io/worker-id"
JOB_ANN_COORDINATOR = "tpu.ktpu.io/coordinator-address"
JOB_ANN_WORKER_HOSTNAMES = "tpu.ktpu.io/worker-hostnames"
ANN_INJECTED = "gpu.ktpu.io/injected"

# The NVIDIA control nodes a CUDA process opens besides its card's.
CONTROL_NODES = ("/dev/nvidiactl", "/dev/nvidia-uvm", "/dev/nvidia-uvm-tools")
DEV_DIR = "/dev"  # the card nodes' directory; KTPU_DEV_DIR overrides it (tests)
FAKE_MODEL = "NVIDIA H100 80GB HBM3"
FAKE_MEMORY_MIB = "81559"


def discover_gpu_devices() -> List[dict]:
    """The node's cards as encoded ExtendedResourceDevice dicts: fake mode
    when KTPU_FAKE_GPUS is set, else the /dev/nvidia* walk."""
    fake = os.environ.get("KTPU_FAKE_GPUS", "")
    if fake:
        return _fake_devices(fake)
    return _real_devices()


def _device(dev_id: str, index: int, model: str, memory: str, uuid: str, domain: str,
            path: str = "", coord: Optional[int] = None) -> dict:
    """One card's dict; ``coord``, its position in its domain (the minor
    in real mode), defaults to its index."""
    position = str(index if coord is None else coord)
    attrs = {
        ATTR_GPU_MODEL: model,
        ATTR_GPU_MEMORY: memory,
        ATTR_GPU_UUID: uuid,
        ATTR_GPU_NVLINK_DOMAIN: domain,
        ATTR_GPU_MINOR: position,
        ATTR_SLICE: domain,
        ATTR_COORDS: position,
        ATTR_DEVICE_INDEX: str(index),
    }
    if path:
        attrs[ATTR_DEVICE_PATH] = path
    return {"id": dev_id, "health": DEVICE_HEALTHY, "attributes": attrs}


def _fake_devices(spec: str) -> List[dict]:
    parts = spec.split(":")

    def part(i, default):
        return parts[i] if len(parts) > i and parts[i] else default

    model, count = part(0, FAKE_MODEL), int(part(1, "1"))
    domains = part(2, "nvlink-0").split(",")
    host, memory = part(3, "0"), part(4, FAKE_MEMORY_MIB)
    devices = []
    for i in range(count):
        domain = domains[min(i, len(domains) - 1)]
        devices.append(_device(f"{domain}-h{host}-gpu{i}", i, model, memory,
                               f"GPU-fake-{domain}-h{host}-{i}", domain))
    return devices


def smi_cards() -> List[dict]:
    """One dict a card from ``nvidia-smi -q -x``, in nvidia-smi's index
    order: uuid, name, memory (MiB) and minor (the N of /dev/nvidiaN);
    [] when nvidia-smi is missing or fails."""
    try:
        out = subprocess.run(["nvidia-smi", "-q", "-x"], capture_output=True, text=True,
                             timeout=60, check=True).stdout
        root = ET.fromstring(out)
    except (OSError, subprocess.SubprocessError, ET.ParseError):
        return []
    return [{"uuid": gpu.findtext("uuid", "").strip(),
             "name": gpu.findtext("product_name", "").strip(),
             "memory": gpu.findtext("fb_memory_usage/total", "").replace("MiB", "").strip(),
             "minor": gpu.findtext("minor_number", "").strip()}
            for gpu in root.findall("gpu")]


_ANSI = re.compile(r"\x1b\[[0-9;]*m")


def smi_nvlinks() -> List[tuple]:
    """The NVLink peer pairs (i, j), i < j, in nvidia-smi's card indices,
    from one ``nvidia-smi topo -m`` call: an ``NV<n>`` cell (a bonded set
    of n links) between two cards; [] when nvidia-smi fails."""
    try:
        out = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True,
                             timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    rows = [_ANSI.sub("", line).split() for line in out.splitlines()]
    header = next((r for r in rows if r and r[0] == "GPU0"), [])
    cols = [int(c[3:]) for c in header if re.fullmatch(r"GPU\d+", c)]
    pairs = set()
    for r in rows:
        if r is header or not r or not re.fullmatch(r"GPU\d+", r[0]):
            continue
        i = int(r[0][3:])
        for j, cell in zip(cols, r[1:]):
            if re.fullmatch(r"NV\d+", cell) and i != j:
                pairs.add((min(i, j), max(i, j)))
    return sorted(pairs)


def nvlink_domains(minors: List[int], links: List[tuple], host: str) -> List[str]:
    """Each card's NVLink domain: the connected component of the peer
    graph (``links``, pairs of positions in ``minors``) that holds it,
    named ``<host>-nvl<lowest minor in it>``."""
    root = list(range(len(minors)))

    def find(i):
        while root[i] != i:
            root[i] = root[root[i]]
            i = root[i]
        return i

    for i, j in links:
        root[find(i)] = find(j)
    low: Dict[int, int] = {}
    for i, m in enumerate(minors):
        low[find(i)] = min(low.get(find(i), m), m)
    return [f"{host}-nvl{low[find(i)]}" for i in range(len(minors))]


def _real_devices() -> List[dict]:
    """Each card nvidia-smi reports, at its own node /dev/nvidia<minor>
    (ref pkg/kubelet/gpu/nvidia/nvidia_gpu_manager.go: the legacy GPU
    manager's /dev/nvidia* walk), in its NVLink domain; a card whose node
    is missing here is not advertised."""
    hostname = os.uname().nodename
    dev_dir = os.environ.get("KTPU_DEV_DIR") or DEV_DIR
    cards = [(index, card) for index, card in enumerate(smi_cards()) if card["minor"].isdigit()]
    if not cards:
        return []
    at = {index: k for k, (index, _) in enumerate(cards)}
    links = [(at[i], at[j]) for i, j in smi_nvlinks() if i in at and j in at]
    domains = nvlink_domains([int(card["minor"]) for _, card in cards], links, hostname)
    devices = []
    for (index, card), domain in zip(cards, domains):
        path = os.path.join(dev_dir, f"nvidia{card['minor']}")
        if os.path.exists(path):
            devices.append(_device(f"{hostname}-nvidia{card['minor']}", index, card["name"],
                                   card["memory"], card["uuid"], domain, path,
                                   int(card["minor"])))
    return devices


class GPUDevicePlugin:
    """Plugin implementation served over PluginServer, with the semantics
    of the JAX package's TPUDevicePlugin."""

    def __init__(self, devices: Optional[List[dict]] = None,
                 health_check_interval: float = 10.0):
        self.devices = devices if devices is not None else discover_gpu_devices()
        self._by_id = {d["id"]: d for d in self.devices}
        self.health_check_interval = health_check_interval
        self._lock = threading.Lock()
        # one wakeup Event per live ListAndWatch stream: a shared event could
        # be consumed by a dead stream and lose the update for the live one
        self._subscribers: List[threading.Event] = []

    # --------------------------------------------------------------- 4 RPCs

    def get_plugin_info(self) -> dict:
        return {"name": GPU_RESOURCE, "version": "v1", "device_count": len(self.devices)}

    def list_devices(self) -> List[dict]:
        with self._lock:
            return [{**d, "attributes": dict(d["attributes"])} for d in self.devices]

    def watch_devices(self, send, stop: threading.Event):
        """Push the inventory again whenever a card's health flips."""
        dirty = threading.Event()
        with self._lock:
            self._subscribers.append(dirty)
        try:
            while not stop.is_set():
                dirty.wait(self.health_check_interval)
                if stop.is_set():
                    return
                if self._inject_card_death():
                    send(self.list_devices())
                if dirty.is_set():
                    dirty.clear()
                    send(self.list_devices())
                else:
                    self._check_health(send)
        finally:
            with self._lock:
                try:
                    self._subscribers.remove(dirty)
                except ValueError:
                    pass

    def _inject_card_death(self) -> Optional[str]:
        """The ``device.health`` seam: a fault injected on a health pass is
        a card dying, one healthy card turns unhealthy as a vanished
        /dev/nvidiaN would.  Nothing happens when no injector is active."""
        if not faultline.active():
            return None
        try:
            faultline.check("device.health")
        except faultline.FaultInjected:
            with self._lock:
                for d in self.devices:
                    if d["health"] == DEVICE_HEALTHY:
                        d["health"] = DEVICE_UNHEALTHY
                        return d["id"]
        return None

    def _check_health(self, send):
        """Real mode: a vanished /dev/nvidiaN marks its card unhealthy."""
        changed = False
        with self._lock:
            for d in self.devices:
                path = d["attributes"].get(ATTR_DEVICE_PATH)
                if not path:
                    continue
                want = DEVICE_HEALTHY if os.path.exists(path) else DEVICE_UNHEALTHY
                if d["health"] != want:
                    d["health"] = want
                    changed = True
        if changed:
            send(self.list_devices())

    def set_health(self, device_id: str, health: str):
        """Test and operator hook: flip a card's health and push the update."""
        with self._lock:
            if device_id in self._by_id:
                self._by_id[device_id]["health"] = health
            subscribers = list(self._subscribers)
        for ev in subscribers:
            ev.set()

    def admit_pod(self, params: dict) -> dict:
        """Check the scheduler's assignment against this node's cards (the
        assignment itself lives in the pod spec)."""
        with self._lock:
            for ids in (params.get("assignments") or {}).values():
                for dev_id in ids:
                    dev = self._by_id.get(dev_id)
                    if dev is None:
                        return {"allowed": False, "reason": f"device {dev_id} not on this node"}
                    if dev["health"] != DEVICE_HEALTHY:
                        return {"allowed": False, "reason": f"device {dev_id} unhealthy"}
        return {"allowed": True}

    def init_container(self, params: dict) -> ContainerSpec:
        """What one container of the pod gets: its cards' env and nodes."""
        device_ids: List[str] = params.get("device_ids") or []
        annotations: Dict[str, str] = params.get("pod_annotations") or {}
        spec = ContainerSpec()
        visible = []
        with self._lock:
            for dev_id in device_ids:
                dev = self._by_id.get(dev_id)
                if dev is None:
                    continue
                attrs = dev["attributes"]
                path = attrs.get(ATTR_DEVICE_PATH)
                if path:
                    visible.append(attrs.get(ATTR_GPU_UUID) or attrs[ATTR_DEVICE_INDEX])
                    spec.devices.append(DeviceSpec(host_path=path, container_path=path))
                else:
                    visible.append(attrs[ATTR_DEVICE_INDEX])
        if spec.devices:
            spec.devices += [DeviceSpec(host_path=p, container_path=p)
                             for p in CONTROL_NODES if os.path.exists(p)]
        spec.envs["CUDA_VISIBLE_DEVICES"] = ",".join(visible)
        spec.envs["NVIDIA_VISIBLE_DEVICES"] = ",".join(visible)
        spec.envs["CUDA_DEVICE_ORDER"] = "PCI_BUS_ID"
        worker_id, coordinator, hostnames = (
            annotations.get(key, annotations.get(job_key)) for key, job_key in (
                (ANN_WORKER_ID, JOB_ANN_WORKER_ID), (ANN_COORDINATOR, JOB_ANN_COORDINATOR),
                (ANN_WORKER_HOSTNAMES, JOB_ANN_WORKER_HOSTNAMES)))
        if worker_id is not None:
            spec.envs["RANK"] = worker_id
            spec.envs["LOCAL_RANK"] = "0"
        if coordinator is not None:
            host, _, port = coordinator.rpartition(":")
            spec.envs["MASTER_ADDR"] = host
            spec.envs["MASTER_PORT"] = port
        if hostnames is not None:
            hosts = [h for h in hostnames.split(",") if h]
            spec.envs["WORLD_SIZE"] = str(len(hosts))
        spec.annotations[ANN_INJECTED] = "true"
        return spec


def run_plugin(plugin_dir: str) -> PluginServer:
    impl = GPUDevicePlugin()
    server = PluginServer(impl, plugin_socket_path(plugin_dir, GPU_RESOURCE))
    server.start()
    return server


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="ktpu NVIDIA GPU device plugin")
    ap.add_argument("--plugin-dir", default=os.environ.get("KTPU_PLUGIN_DIR", DEFAULT_PLUGIN_DIR))
    args = ap.parse_args(argv)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    server = run_plugin(args.plugin_dir)
    cards = [f"{d['id']} ({d['attributes'][ATTR_GPU_MODEL]}, {d['attributes'][ATTR_GPU_MEMORY]} "
             f"MiB, {d['attributes'][ATTR_GPU_UUID]})" for d in server.impl.devices]
    print(f"gpu device plugin: advertising {len(cards)} card(s) at {server.socket_path}: "
          f"{'; '.join(cards)}", flush=True)
    try:
        stop.wait()
    finally:
        server.stop()  # unlinks the socket: the kubelet marks the cards unhealthy
