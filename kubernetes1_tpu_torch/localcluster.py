"""LocalCluster: a whole one-machine cluster in one process.

The port's copy of the JAX package's ``localcluster.py`` (ref:
hack/local-up-cluster.sh and pkg/kubemark's hollow nodes), over the
port's own components: its apiserver (``apiserver.Master``), scheduler
(``metrics_port=0``), controller manager, the userspace Service proxy
(``proxy.Proxier``), the pod-startup SLI tracker (``utils/slo``) and N
kubelets, each with the port's ``nvidia.com/gpu`` device plugin behind a
``PluginServer``.  Nodes are hollow (``FakeRuntime``) for scale, but for
node 0 with ``real_gpu=True``, which runs the machine's cards: the plugin's
``discover_gpu_devices()`` and a ``ProcessRuntime`` that execs each
container as a host process with the card injected (``CUDA_VISIBLE_DEVICES``).
Every other node's cards are fake H100s: ``<H100>:<gpus_per_node>:nvl<i>:0``;
with ``hollow=False`` those nodes run a ``ProcessRuntime`` too (``ktpu
cluster-up``'s default).  ``port`` fixes the apiserver's port (0: any
free one).  ``stop()`` kills every process of every ProcessRuntime
container it leaves and returns the pids that survived: a torn-down
cluster leaves no pod process (the JAX cluster's stop leaves them).

Every component with an HTTP surface (the apiserver, the scheduler, the
SLI tracker, the kubelets) is registered with an ``ObsCollector``
(``cluster.obs``), which serves the fleet's /metrics, /debug/traces,
/debug/topology and /debug/flightrecorder.  ``obs=False`` leaves it out.

The JAX cluster's sharding options (``store_shards``, ``apiservers`` > 1
with its fail-over server lists, ``sched_shards``) are not here: the
port has no sharded store and no scheduler shards.  Nor are the options
no caller of the port sets: ``tpu_type`` (the fake cards' model, here
always H100), ``heartbeat_interval`` (``HEARTBEAT_INTERVAL``), and the controller
manager's ``endpoints_coalesce_window``, ``monitor_grace`` and
``eviction_timeout`` (its defaults).
"""

from __future__ import annotations

import os
import shutil
import tempfile
from dataclasses import dataclass
from typing import List, Optional

from . import GPU_RESOURCE
from .apiserver import Master
from .apiserver.registry import Registry
from .client.clientset import Clientset
from .controllers import ControllerManager
from .deviceplugin.api import PluginServer, plugin_socket_path
from .deviceplugin.gpu_plugin import GPUDevicePlugin, _fake_devices, discover_gpu_devices
from .kubelet import FakeRuntime, Kubelet, ProcessRuntime
from .obs import ObsCollector
from .proxy import Proxier
from .scheduler import Scheduler
from .utils.slo import StartupSLITracker

H100 = "NVIDIA H100 80GB HBM3"


def free_node_port(host: str = "127.0.0.1") -> int:
    """A port of the apiserver's NodePort range (30000-32767) that nothing
    on ``host`` listens on now, for a Service whose node port the Proxier
    must be able to bind; the scan starts at a random port."""
    import random
    import socket

    lo, hi = Registry.NODE_PORT_RANGE
    start = random.randrange(hi - lo + 1)
    for k in range(hi - lo + 1):
        port = lo + (start + k) % (hi - lo + 1)
        with socket.socket() as s:
            try:
                s.bind((host, port))
            except OSError:
                continue
            return port
    raise OSError(f"no free port in {lo}-{hi} on {host}")


@dataclass
class NodeHandle:
    kubelet: Kubelet
    plugin: Optional[PluginServer]
    clientset: Clientset


class LocalCluster:
    """start() brings everything up; stop() tears it down in order."""

    HEARTBEAT_INTERVAL = 2.0  # each kubelet's node status, s

    def __init__(
        self,
        nodes: int = 1,
        gpus_per_node: int = 8,
        hollow: bool = True,
        real_gpu: bool = False,
        port: int = 0,
        root_dir: str = "",
        sync_interval: float = 0.25,
        obs: bool = True,
        obs_interval: float = 1.0,
    ):
        self.n_nodes = nodes
        self.gpus_per_node = gpus_per_node
        self.hollow = hollow
        self.real_gpu = real_gpu
        self.port = port
        # a plugin's unix socket lives under it: the default stays short
        self._own_root = not root_dir
        self.root_dir = root_dir or tempfile.mkdtemp(prefix="ktpu-cluster-")
        self.sync_interval = sync_interval
        self.obs_enabled = obs
        self.obs_interval = obs_interval

        self.master: Optional[Master] = None
        self.cs: Optional[Clientset] = None
        self.scheduler: Optional[Scheduler] = None
        self.kcm: Optional[ControllerManager] = None
        self.proxier: Optional[Proxier] = None
        self.sli: Optional[StartupSLITracker] = None
        self.obs: Optional[ObsCollector] = None
        self.nodes: List[NodeHandle] = []
        self._scheduler_cs: Optional[Clientset] = None
        self._kcm_cs: Optional[Clientset] = None
        self._proxier_cs: Optional[Clientset] = None
        self._sli_cs: Optional[Clientset] = None

    @property
    def url(self) -> str:
        return self.master.url

    def start(self) -> "LocalCluster":
        try:
            self.master = Master(port=self.port).start()
            url = self.master.url
            self.cs = Clientset(url)
            # the scheduler's /metrics and /debug/traces on an ephemeral port:
            # the observability surface is part of the cluster
            self._scheduler_cs = Clientset(url)
            self.scheduler = Scheduler(self._scheduler_cs, metrics_port=0)
            self.scheduler.start()
            self._kcm_cs = Clientset(url)
            self.kcm = ControllerManager(self._kcm_cs)
            self.kcm.start()
            self._proxier_cs = Clientset(url)
            self.proxier = Proxier(self._proxier_cs).start()
            # pod-startup SLIs (utils/slo): per-phase histograms on /metrics
            self._sli_cs = Clientset(url)
            self.sli = StartupSLITracker(self._sli_cs, metrics_port=0).start()
            for i in range(self.n_nodes):
                self._add_node(i)
            if self.obs_enabled:
                self._start_obs()
        except BaseException:
            self.stop()
            raise
        return self

    def _start_obs(self):
        # Registration audit: every component with an HTTP surface is
        # listed here (the apiserver, the scheduler, the SLI tracker, the
        # kubelets).  The controller manager and the proxier serve no
        # endpoint of their own in process.  Anything started BESIDE the
        # cluster (workload servers, a scorecard) registers itself on
        # cluster.obs the same way.
        self.obs = ObsCollector(interval=self.obs_interval)
        self.obs.register("apiserver", self.master.url, instance="apiserver-0")
        if self.scheduler.metrics_server is not None:
            self.obs.register("scheduler", self.scheduler.metrics_server.url,
                              instance="sched-0")
        if self.sli is not None and self.sli.metrics_server is not None:
            self.obs.register("sli", self.sli.metrics_server.url, instance="sli-0")
        for h in self.nodes:
            srv = getattr(h.kubelet, "server", None)
            if srv is not None:
                self.obs.register("kubelet", srv.url, instance=h.kubelet.node_name)
        self.obs.start()

    def _add_node(self, i: int):
        name = f"node-{i}"
        plugin_dir = os.path.join(self.root_dir, name, "plugins")  # a unix socket: keep it short
        real = self.real_gpu and i == 0
        plugin = None
        devices = discover_gpu_devices() if real else \
            _fake_devices(f"{H100}:{self.gpus_per_node}:nvl{i}:0")
        if devices:
            plugin = PluginServer(GPUDevicePlugin(devices=devices),
                                  plugin_socket_path(plugin_dir, GPU_RESOURCE))
            plugin.start()
        runtime = ProcessRuntime(root_dir=os.path.join(self.root_dir, name, "run")) \
            if real or not self.hollow else FakeRuntime()
        kcs = Clientset(self.master.url)
        kubelet = Kubelet(
            kcs,
            node_name=name,
            runtime=runtime,
            plugin_dir=plugin_dir,
            heartbeat_interval=self.HEARTBEAT_INTERVAL,
            sync_interval=self.sync_interval,
            pleg_interval=self.sync_interval,
        )
        self.nodes.append(NodeHandle(kubelet=kubelet, plugin=plugin, clientset=kcs))
        kubelet.start()

    def wait_ready(self, timeout: float = 60.0):
        from .utils.waitutil import must_poll_until

        def all_ready():
            nodes, _ = self.cs.nodes.list()
            ready = [
                n for n in nodes
                if any(c.type == "Ready" and c.status == "True"
                       for c in n.status.conditions)
            ]
            return len(ready) >= self.n_nodes

        must_poll_until(all_ready, timeout=timeout, desc="all nodes Ready")
        return self

    def stop(self) -> List[int]:
        """Tear down in order; the pids of pod processes that survived."""
        survivors: List[int] = []
        if self.obs:
            self.obs.stop()
        for h in self.nodes:
            h.kubelet.stop()
            if isinstance(h.kubelet.runtime, ProcessRuntime):
                survivors += h.kubelet.runtime.kill_all()
            if h.plugin:
                h.plugin.stop()
            h.clientset.close()
        if self.sli:
            self.sli.stop()
        if self.proxier:
            self.proxier.stop()
        if self.kcm:
            self.kcm.stop()
        if self.scheduler:
            self.scheduler.stop()
        for cs in (self._sli_cs, self._proxier_cs, self._kcm_cs, self._scheduler_cs, self.cs):
            if cs is not None:
                cs.close()
        if self.master:
            self.master.stop()
        if self._own_root:
            shutil.rmtree(self.root_dir, ignore_errors=True)
        return sorted(survivors)
