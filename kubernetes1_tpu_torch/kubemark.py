"""Kubemark: hollow nodes at scale (ref: pkg/kubemark/hollow_kubelet.go).

The port's copy of the JAX package's ``kubemark.py``.  A hollow node is
the port's REAL kubelet loop (sync workers, PLEG, heartbeats, the status
writes, the device manager) over a ``FakeRuntime`` and a fake
``nvidia.com/gpu`` plugin, so control-plane scale runs exercise the node
agent's true code paths without containers or cards.  One worker process
hosts K hollow nodes against one apiserver:

    python -m kubernetes1_tpu_torch.kubemark --server http://... \\
        --count 50 --index-base 0 --gpus-per-node 8

It prints one line once its nodes are up and exits 0 on SIGTERM or
SIGINT, after stopping them.  The JAX worker's ``--tpu-type`` has no
counterpart: every hollow card is an H100.
"""

from __future__ import annotations

import argparse
import os
import signal
import tempfile
import threading

from . import GPU_RESOURCE
from .client.clientset import Clientset
from .deviceplugin.api import PluginServer, plugin_socket_path
from .deviceplugin.gpu_plugin import GPUDevicePlugin, _fake_devices
from .kubelet import FakeRuntime, Kubelet
from .localcluster import H100

HOSTS_PER_DOMAIN = 8  # hollow nodes a fake NVLink domain name spans


class HollowNode:
    """One hollow kubelet and its fake GPU plugin (hollow_kubelet.go:43)."""

    def __init__(self, server: str, name: str, root_dir: str,
                 gpus_per_node: int = 8,
                 domain: str = "", host_index: int = 0,
                 heartbeat_interval: float = 10.0,
                 sync_interval: float = 1.0):
        plugin_dir = os.path.join(root_dir, name, "plugins")  # a unix socket: keep it short
        devices = _fake_devices(
            f"{H100}:{gpus_per_node}:{domain or name}:{host_index}")
        self.plugin = PluginServer(
            GPUDevicePlugin(devices=devices),
            plugin_socket_path(plugin_dir, GPU_RESOURCE))
        self.plugin.start()
        self.cs = Clientset(server)
        self.kubelet = Kubelet(
            self.cs,
            node_name=name,
            runtime=FakeRuntime(),
            plugin_dir=plugin_dir,
            heartbeat_interval=heartbeat_interval,
            sync_interval=sync_interval,
            pleg_interval=sync_interval,
        )

    def start(self):
        self.kubelet.start()
        return self

    def stop(self):
        self.kubelet.stop()
        self.plugin.stop()
        self.cs.close()


def run_worker(server: str, count: int, index_base: int, gpus_per_node: int,
               root_dir: str, heartbeat_interval: float, sync_interval: float):
    """Start ``count`` hollow nodes ``hollow-<index_base>``...; each
    HOSTS_PER_DOMAIN consecutive nodes share an NVLink domain name."""
    nodes = []
    for i in range(count):
        idx = index_base + i
        nodes.append(HollowNode(
            server, f"hollow-{idx}", root_dir, gpus_per_node=gpus_per_node,
            domain=f"nvl-{idx // HOSTS_PER_DOMAIN}",
            host_index=idx % HOSTS_PER_DOMAIN,
            heartbeat_interval=heartbeat_interval,
            sync_interval=sync_interval).start())
    return nodes


def main(argv=None):
    ap = argparse.ArgumentParser(description="kubemark hollow-node worker")
    ap.add_argument("--server", required=True)
    ap.add_argument("--count", type=int, default=50)
    ap.add_argument("--index-base", type=int, default=0)
    ap.add_argument("--gpus-per-node", type=int, default=8)
    ap.add_argument("--root-dir", default="")
    ap.add_argument("--heartbeat-interval", type=float, default=10.0)
    ap.add_argument("--sync-interval", type=float, default=1.0)
    args = ap.parse_args(argv)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    root = args.root_dir or tempfile.mkdtemp(prefix="kubemark-")
    nodes = run_worker(args.server, args.count, args.index_base, args.gpus_per_node, root,
                       args.heartbeat_interval, args.sync_interval)
    print(f"kubemark worker: {len(nodes)} hollow nodes up "
          f"(hollow-{args.index_base}..hollow-{args.index_base + args.count - 1})",
          flush=True)
    stop.wait()
    for n in nodes:
        n.stop()


if __name__ == "__main__":
    main()
