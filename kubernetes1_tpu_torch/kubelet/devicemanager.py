"""Kubelet device manager: plugin discovery, device store, pod admission,
container init — the fork's rewritten device manager, the port's copy of
the JAX package's ``kubelet/devicemanager.py``, over the port's wire code
(``deviceplugin/api.py``), so it drives the port's Python plugin, the
native ``ktpu-gpu-plugin`` and any plugin of the JAX package alike.

Ref: pkg/kubelet/cm/devicemanager/{manager.go,endpoint.go,manager_store.go,
cache.go} + apis/pluginregistration/v1beta/plugin_watcher.go.  Semantics
preserved:
- socket discovery under <plugin_dir>/<domain>/<name>.sock (the PluginWatcher
  dir layout; polling stands in for fsnotify);
- per-plugin endpoint holds the connection and streams ListAndWatch device
  updates into the store; a dead endpoint marks its devices unhealthy;
- AdmitPod runs at kubelet pod admission, verifying the scheduler-assigned
  IDs against local healthy inventory and letting the plugin veto; the
  response is cached per pod uid with allocation latency recorded (the
  fork's DevicePluginAllocationLatency metric, manager.go:229-231);
- InitContainer runs before each container start and returns the injection
  spec (env/mounts/devices/annotations);
- NO local checkpoint file: assignment truth lives in
  pod.spec.extended_resources[].assigned in the API store, so kubelet
  restart-safety is free (manager.go:293-310 prunes the per-pod cache
  lazily).
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Dict, List, NamedTuple, Optional

from ..api import types as t
from ..deviceplugin.api import ContainerSpec, PluginClient, resource_from_socket
from ..machinery.scheme import from_dict
from ..utils.metrics import Histogram


class AdmitResult(NamedTuple):
    allowed: bool
    reason: str
    retriable: bool


class Endpoint:
    """One connected plugin (ref: endpoint.go)."""

    def __init__(self, manager: "DeviceManager", resource: str, socket_path: str):
        self.manager = manager
        self.resource = resource
        self.socket_path = socket_path
        self.client = PluginClient(socket_path)
        self.info: dict = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self.info = self.client.call("GetPluginInfo")
        self._thread = threading.Thread(
            target=self._watch_loop, daemon=True, name=f"dp-{self.resource}"
        )
        self._thread.start()

    def _watch_loop(self):
        failures = 0
        while not self._stop.is_set():
            got_stream = False
            try:
                for devices in self.client.list_and_watch():
                    if self._stop.is_set():
                        return
                    got_stream = True
                    failures = 0
                    self.manager.store_update(self.resource, devices)
            except (ConnectionError, OSError):
                pass
            if self._stop.is_set():
                return
            if not os.path.exists(self.socket_path):
                # plugin gone cleanly: inventory no longer trustworthy
                self.manager.store_mark_unhealthy(self.resource)
                return
            if not got_stream:
                # socket file present but nobody answering — a killed plugin
                # leaves its socket behind; after a couple of refused
                # connects the inventory is stale
                failures += 1
                if failures == 2:
                    self.manager.store_mark_unhealthy(self.resource)
            time.sleep(0.5)  # the two strikes above count probes at this fixed period

    def admit_pod(self, pod: t.Pod, assignments: Dict[str, List[str]]) -> dict:
        return self.client.call(
            "AdmitPod",
            {
                "pod_uid": pod.metadata.uid,
                "pod_name": pod.metadata.name,
                "pod_namespace": pod.metadata.namespace,
                "assignments": assignments,
            },
        )

    def init_container(
        self, pod: t.Pod, container_name: str, device_ids: List[str]
    ) -> ContainerSpec:
        result = self.client.call(
            "InitContainer",
            {
                "pod_uid": pod.metadata.uid,
                "container_name": container_name,
                "device_ids": device_ids,
                "pod_annotations": pod.metadata.annotations,
            },
        )
        return ContainerSpec.from_dict(result or {})

    def stop(self):
        self._stop.set()
        self.client.close()


class DeviceManager:
    POLL_INTERVAL = 0.5  # seconds between scans of the plugin dir

    def __init__(self, plugin_dir: str):
        self.plugin_dir = plugin_dir
        self._lock = threading.RLock()
        self._endpoints: Dict[str, Endpoint] = {}  # resource -> endpoint
        self._store: Dict[str, List[dict]] = {}  # resource -> device dicts
        self._admit_cache: Dict[str, dict] = {}  # pod uid -> admit result
        # device ids the PLUGIN ITSELF reported unhealthy (per resource).
        # Distinct from store_mark_unhealthy's synthetic staleness marking:
        # only an explicit ListAndWatch unhealthy report means the card is
        # actually dead — endpoint/socket death must never kill running
        # workloads (the kubelet-restart / plugin-restart contract).
        self._reported_unhealthy: Dict[str, set] = {}
        self._stop = threading.Event()
        self._watcher: Optional[threading.Thread] = None
        self.allocation_latency = Histogram(
            "ktpu_device_plugin_allocation_seconds",
            "AdmitPod RPC latency (the fork's DevicePluginAllocationLatency)",
        )
        self.on_capacity_change = None  # callback for node-status push
        # callback(resource, [device ids]) fired once per plugin-reported
        # healthy->unhealthy transition: the kubelet fails running pods
        # holding those devices so their controller/gang policy reacts —
        # without it a dead card only blocks FUTURE admits while the pod
        # that holds it spins on a dead card forever
        self.on_device_unhealthy = None

    # ------------------------------------------------------ plugin watching

    def start(self):
        os.makedirs(self.plugin_dir, exist_ok=True)
        self._watcher = threading.Thread(target=self._watch_sockets, daemon=True)
        self._watcher.start()
        return self

    def stop(self):
        self._stop.set()
        with self._lock:
            for ep in self._endpoints.values():
                ep.stop()
            self._endpoints.clear()

    def _scan(self) -> Dict[str, str]:
        found = {}
        try:
            for domain in os.listdir(self.plugin_dir):
                ddir = os.path.join(self.plugin_dir, domain)
                if not os.path.isdir(ddir):
                    continue
                for name in os.listdir(ddir):
                    path = os.path.join(ddir, name)
                    resource = resource_from_socket(self.plugin_dir, path)
                    if resource:
                        found[resource] = path
        except OSError:
            pass
        return found

    def _watch_sockets(self):
        while not self._stop.is_set():
            found = self._scan()
            to_start: List[tuple] = []
            with self._lock:
                for resource, path in found.items():
                    ep = self._endpoints.get(resource)
                    if ep is None or ep.socket_path != path or not ep._thread.is_alive():
                        to_start.append((resource, path, ep))
                removed = [r for r in self._endpoints if r not in found]
                for resource in removed:
                    self._endpoints.pop(resource).stop()
            for resource in removed:
                self.store_mark_unhealthy(resource)
            # Endpoint.start() does a blocking RPC — never under the manager
            # lock, or a wedged plugin freezes admission and heartbeats.
            for resource, path, old_ep in to_start:
                if old_ep is not None:
                    old_ep.stop()
                ep = Endpoint(self, resource, path)
                try:
                    ep.start()
                except (ConnectionError, OSError):
                    continue
                with self._lock:
                    cur = self._endpoints.get(resource)
                    if cur is not None and cur is not old_ep and cur._thread.is_alive():
                        ep.stop()  # raced with another registration
                    else:
                        self._endpoints[resource] = ep
            self._stop.wait(self.POLL_INTERVAL)

    # ----------------------------------------------------------- the store

    def store_update(self, resource: str, devices: List[dict]):
        lost: List[str] = []
        with self._lock:
            reported = self._reported_unhealthy.setdefault(resource, set())
            for d in devices:
                if d.get("health") == t.DEVICE_HEALTHY:
                    reported.discard(d["id"])
                elif d["id"] not in reported:
                    # a NEW plugin-reported death (first frame after a
                    # kubelet restart counts too: the card may have died
                    # while the kubelet was down)
                    reported.add(d["id"])
                    lost.append(d["id"])
            self._store[resource] = devices
        if lost and self.on_device_unhealthy:
            try:
                self.on_device_unhealthy(resource, lost)
            except Exception:  # noqa: BLE001
                traceback.print_exc()
        if self.on_capacity_change:
            try:
                self.on_capacity_change()
            except Exception:  # noqa: BLE001
                traceback.print_exc()

    def store_mark_unhealthy(self, resource: str):
        """Inventory no longer trustworthy (endpoint/socket gone): blocks
        FUTURE admits only.  Deliberately does NOT fire on_device_unhealthy
        — a restarting plugin must not kill the healthy workloads it was
        serving (their truth arrives with the next ListAndWatch frame)."""
        with self._lock:
            for d in self._store.get(resource, []):
                d["health"] = t.DEVICE_UNHEALTHY
        if self.on_capacity_change:
            try:
                self.on_capacity_change()
            except Exception:  # noqa: BLE001
                traceback.print_exc()

    def get_capacity(self) -> Dict[str, List[t.ExtendedResourceDevice]]:
        """ExtendedResourceMap for node status (ref: manager.go GetCapacity
        -> kubelet_node_status.go:552-621)."""
        with self._lock:
            return {
                resource: [from_dict(t.ExtendedResourceDevice, d) for d in devices]
                for resource, devices in self._store.items()
            }

    def has_plugin(self, resource: str) -> bool:
        with self._lock:
            return resource in self._endpoints

    # ------------------------------------------------------- pod admission

    def admit_pod(self, pod: t.Pod) -> "AdmitResult":
        """Verify assigned IDs + plugin AdmitPod RPC (manager.go:152-236).

        Infrastructure-not-ready conditions (plugin not yet discovered, first
        device frame not yet received, RPC transport failure) are RETRIABLE —
        a kubelet restart delivers bound pods before the 0.5s plugin scan
        completes, and failing them permanently would kill healthy workloads.
        Plugin vetoes and structural problems are permanent.
        """
        if not pod.spec.extended_resources:
            return AdmitResult(True, "", False)
        with self._lock:
            cached = self._admit_cache.get(pod.metadata.uid)
        if cached is not None:
            return AdmitResult(
                cached.get("allowed", False), cached.get("reason", ""), False
            )
        start = time.monotonic()
        by_resource: Dict[str, Dict[str, List[str]]] = {}
        for per in pod.spec.extended_resources:
            if not per.assigned:
                return AdmitResult(
                    False, f"extended resource {per.name} has no assignment", False
                )
            by_resource.setdefault(per.resource, {})[per.name] = per.assigned
        for resource, assignments in by_resource.items():
            with self._lock:
                ep = self._endpoints.get(resource)
                known = {d["id"]: d for d in self._store.get(resource, [])}
            if ep is None:
                return AdmitResult(False, f"no device plugin for {resource}", True)
            if not known:
                return AdmitResult(
                    False, f"no {resource} inventory received yet", True
                )
            for ids in assignments.values():
                for dev_id in ids:
                    dev = known.get(dev_id)
                    if dev is None:
                        return AdmitResult(
                            False,
                            f"assigned device {dev_id} not in local inventory",
                            False,
                        )
                    if dev.get("health") != t.DEVICE_HEALTHY:
                        return AdmitResult(
                            False, f"assigned device {dev_id} unhealthy", False
                        )
            try:
                result = ep.admit_pod(pod, assignments)
            except (ConnectionError, RuntimeError) as e:
                return AdmitResult(False, f"plugin AdmitPod failed: {e}", True)
            if not result.get("allowed", False):
                return AdmitResult(
                    False, result.get("reason", "plugin denied admission"), False
                )
        self.allocation_latency.observe(time.monotonic() - start)
        with self._lock:
            self._admit_cache[pod.metadata.uid] = {"allowed": True, "reason": ""}
        return AdmitResult(True, "", False)

    def init_container(self, pod: t.Pod, container: t.Container) -> ContainerSpec:
        """Merge plugin injections for every device request the container
        references (manager.go:245-291)."""
        merged = ContainerSpec()
        if not container.extended_resource_requests:
            return merged
        by_name = {per.name: per for per in pod.spec.extended_resources}
        for req_name in container.extended_resource_requests:
            per = by_name.get(req_name)
            if per is None or not per.assigned:
                continue
            with self._lock:
                ep = self._endpoints.get(per.resource)
            if ep is None:
                raise RuntimeError(f"no device plugin for {per.resource}")
            spec = ep.init_container(pod, container.name, per.assigned)
            merged.envs.update(spec.envs)
            merged.mounts.extend(spec.mounts)
            merged.devices.extend(spec.devices)
            merged.annotations.update(spec.annotations)
        return merged

    def forget_pod(self, pod_uid: str):
        """Lazy per-pod cache pruning (manager.go:293-310)."""
        with self._lock:
            self._admit_cache.pop(pod_uid, None)
