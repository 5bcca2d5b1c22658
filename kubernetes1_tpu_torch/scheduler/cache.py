"""Scheduler cache: per-node resource and device-ID accounting with
assume/confirm/forget.  The port's copy of the JAX package's
``scheduler/cache.py``, its per-slice counters kept per NVLink domain.

Ref: plugin/pkg/scheduler/schedulercache/{cache.go,node_info.go,
extended_resources.go} — NodeInfo tracks requested cpu/mem and, for each
extended resource, the allocatable device set (with attributes/health from
node.status.extended_resources) and the used device IDs (from the Assigned
lists of pods bound to the node).  `assume` deducts optimistically at
schedule time so the next pod in the queue sees the deduction before the
async bind lands (ref: scheduler.go:365 assume + cache AddPod).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ..api import types as t
from ..utils.quantity import parse_milli, parse_quantity
from .devices import domain_of

DEFAULT_NODE_PODS = 110

# Process-global monotonic generation source. Per-NodeInfo counters would
# restart at 1 when a node is deleted and re-added under the same name,
# letting stale EquivalenceCache entries falsely hit for the new node.
_generation_lock = threading.Lock()
_generation_counter = 0


def _next_generation() -> int:
    global _generation_counter
    with _generation_lock:
        _generation_counter += 1
        return _generation_counter


def pod_request_milli_cpu(pod: t.Pod) -> int:
    # memoized on the pod object: predicates+priorities call this per NODE,
    # and quantity parsing per call is the schedule() hot loop's biggest
    # constant factor at 1000 nodes (informer updates replace pod objects,
    # so staleness is impossible).  The _ktpu_ slot is derived, never
    # serialized, and dies with the object
    cached = getattr(pod, "_ktpu_mcpu", None)
    if cached is not None:
        return cached
    total = 0
    for c in pod.spec.containers:
        total += parse_milli(c.resources.requests.get("cpu") or c.resources.limits.get("cpu") or 0)
    pod._ktpu_mcpu = total
    return total


def pod_request_memory(pod: t.Pod) -> float:
    cached = getattr(pod, "_ktpu_mem", None)
    if cached is not None:
        return cached
    total = 0.0
    for c in pod.spec.containers:
        total += parse_quantity(
            c.resources.requests.get("memory") or c.resources.limits.get("memory") or 0
        )
    pod._ktpu_mem = total
    return total


class ExtendedResourceInfo:
    """Device accounting for one resource name on one node.  Per-domain
    availability counters are kept incrementally, so the scheduler's hot
    loops (fit counting, the domain-packing score) are O(domains), not
    O(devices)."""

    def __init__(self):
        self.devices: Dict[str, t.ExtendedResourceDevice] = {}
        # device id -> holder count.  A count, not a set: one cache can
        # briefly hold two pods on one device (an assumed pod whose bind
        # lost a race, and the winner arriving off the watch); a set would
        # free the device on the loser's forget while the winner holds it.
        # Count zero = available; membership tests read like a set.
        self.used: Dict[str, int] = {}
        self._avail_count = 0
        self._domain_avail: Dict[str, int] = {}

    def set_devices(self, devices: List[t.ExtendedResourceDevice]):
        self.devices = {d.id: d for d in devices}
        # used IDs for devices that disappeared stay; harmless (they can't
        # be re-allocated anyway)
        self._recount()

    def _recount(self):
        self._avail_count = 0
        self._domain_avail = {}
        for d in self.devices.values():
            if d.health == t.DEVICE_HEALTHY and d.id not in self.used:
                self._avail_count += 1
                s = domain_of(d)
                self._domain_avail[s] = self._domain_avail.get(s, 0) + 1

    def available(self) -> List[t.ExtendedResourceDevice]:
        return [
            d
            for d in self.devices.values()
            if d.health == t.DEVICE_HEALTHY and d.id not in self.used
        ]

    def available_count(self) -> int:
        return self._avail_count

    def domain_available(self) -> Dict[str, int]:
        """Available devices per NVLink domain: a live view, not to be changed."""
        return self._domain_avail

    def use(self, ids: List[str]):
        for i in ids:
            n = self.used.get(i, 0)
            self.used[i] = n + 1
            if n:
                continue  # already unavailable; just one more holder
            d = self.devices.get(i)
            if d is not None and d.health == t.DEVICE_HEALTHY:
                self._avail_count -= 1
                s = domain_of(d)
                self._domain_avail[s] = self._domain_avail.get(s, 1) - 1

    def release(self, ids: List[str]):
        for i in ids:
            n = self.used.get(i, 0)
            if n == 0:
                continue
            if n > 1:
                self.used[i] = n - 1
                continue  # another holder remains: still unavailable
            del self.used[i]
            d = self.devices.get(i)
            if d is not None and d.health == t.DEVICE_HEALTHY:
                self._avail_count += 1
                s = domain_of(d)
                self._domain_avail[s] = self._domain_avail.get(s, 0) + 1


class NodeInfo:
    def __init__(self, node: Optional[t.Node] = None):
        self.node: Optional[t.Node] = None
        self.pods: Dict[str, t.Pod] = {}  # "ns/name" -> pod
        self.requested_milli_cpu = 0
        self.requested_memory = 0.0
        self.allocatable_milli_cpu = 0
        self.allocatable_memory = 0.0
        self.allocatable_pods = DEFAULT_NODE_PODS
        self.extended: Dict[str, ExtendedResourceInfo] = {}
        # bumped whenever the node OBJECT changes — the equivalence cache
        # keys static-predicate results on (pod equiv hash, node, generation)
        # (ref: plugin/pkg/scheduler/core/equivalence_cache.go)
        self.generation = 0
        if node is not None:
            self.set_node(node)

    def set_node(self, node: t.Node):
        self.node = node
        self.generation = _next_generation()
        alloc = node.status.allocatable or node.status.capacity
        self.allocatable_milli_cpu = parse_milli(alloc.get("cpu", 0))
        self.allocatable_memory = parse_quantity(alloc.get("memory", 0))
        self.allocatable_pods = int(parse_quantity(alloc.get("pods", DEFAULT_NODE_PODS)))
        for res, devices in (node.status.extended_resources or {}).items():
            self.extended.setdefault(res, ExtendedResourceInfo()).set_devices(devices)
        # resource names no longer advertised drop out of allocatable
        for res in list(self.extended):
            if res not in (node.status.extended_resources or {}):
                self.extended[res].set_devices([])

    def add_pod(self, pod: t.Pod):
        key = pod.key()
        if key in self.pods:
            self.remove_pod(self.pods[key])
        self.pods[key] = pod
        self.requested_milli_cpu += pod_request_milli_cpu(pod)
        self.requested_memory += pod_request_memory(pod)
        for per in pod.spec.extended_resources:
            if per.assigned:
                self.extended.setdefault(per.resource, ExtendedResourceInfo()).use(
                    per.assigned
                )

    def remove_pod(self, pod: t.Pod):
        # Release what add_pod accounted: the stored object, never the
        # caller's.  The two differ when a delete races a bind: the cache
        # holds the scheduler's assumed pod (devices assigned) while the
        # watch's DELETED event carries the unbound version.  Releasing
        # the event's empty device list would leak the assumed counts, and
        # forget_pod cannot release them once _pod_node is popped here.
        stored = self.pods.pop(pod.key(), None)
        if stored is None:
            return
        self.requested_milli_cpu -= pod_request_milli_cpu(stored)
        self.requested_memory -= pod_request_memory(stored)
        for per in stored.spec.extended_resources:
            if per.assigned and per.resource in self.extended:
                self.extended[per.resource].release(per.assigned)

    def available_devices(self, resource: str) -> List[t.ExtendedResourceDevice]:
        info = self.extended.get(resource)
        return info.available() if info else []

    def clone(self) -> "NodeInfo":
        """Cheap copy for what-if simulation (gang placement, preemption):
        shares immutable node/pod objects, copies the accounting."""
        c = NodeInfo()
        c.node = self.node
        c.generation = self.generation
        c.pods = dict(self.pods)
        c.requested_milli_cpu = self.requested_milli_cpu
        c.requested_memory = self.requested_memory
        c.allocatable_milli_cpu = self.allocatable_milli_cpu
        c.allocatable_memory = self.allocatable_memory
        c.allocatable_pods = self.allocatable_pods
        for res, info in self.extended.items():
            ci = ExtendedResourceInfo()
            ci.devices = info.devices  # device descriptors are read-only here
            ci.used = dict(info.used)
            ci._avail_count = info._avail_count
            ci._domain_avail = dict(info._domain_avail)
            c.extended[res] = ci
        return c


class SchedulerCache:
    """Cluster state as the scheduler believes it, including assumed
    (scheduled-but-not-yet-confirmed-bound) pods with expiry."""

    ASSUME_EXPIRY_SECONDS = 30.0

    def __init__(self):
        self._lock = threading.RLock()
        self._nodes: Dict[str, NodeInfo] = {}
        self._assumed: Dict[str, float] = {}  # pod key -> deadline
        self._pod_node: Dict[str, str] = {}  # pod key -> node name

    # ----------------------------------------------------------------- nodes

    def update_node(self, node: t.Node):
        with self._lock:
            ni = self._nodes.get(node.metadata.name)
            if ni is None:
                ni = self._nodes[node.metadata.name] = NodeInfo()
            ni.set_node(node)

    def remove_node(self, name: str):
        with self._lock:
            self._nodes.pop(name, None)

    def snapshot(self) -> Dict[str, NodeInfo]:
        """Fresh dict over the LIVE NodeInfo objects; callers hold the
        scheduling lock (the scheduler is single-threaded over scheduling
        decisions).  The NodeInfos are shared accounting state: what-if
        simulation goes through NodeInfo.clone()."""
        with self._lock:
            return dict(self._nodes)

    # ------------------------------------------------------------------ pods

    def _pod_key(self, pod: t.Pod) -> str:
        return pod.key()

    def assume_pod(self, pod: t.Pod, node_name: str):
        """Optimistically account pod (with any device assignment already in
        pod.spec.extended_resources[].assigned) against node_name."""
        with self._lock:
            key = self._pod_key(pod)
            ni = self._nodes.get(node_name)
            if ni is None:
                ni = self._nodes[node_name] = NodeInfo()
            ni.add_pod(pod)
            self._pod_node[key] = node_name
            self._assumed[key] = time.monotonic() + self.ASSUME_EXPIRY_SECONDS

    def is_assumed(self, pod_key: str) -> bool:
        """True while the pod is assumed: placed, its bind not yet seen."""
        with self._lock:
            return pod_key in self._assumed

    def forget_pod(self, pod: t.Pod):
        """Bind failed: release the assumed resources."""
        with self._lock:
            key = self._pod_key(pod)
            node_name = self._pod_node.pop(key, None)
            self._assumed.pop(key, None)
            if node_name and node_name in self._nodes:
                self._nodes[node_name].remove_pod(pod)

    def add_pod(self, pod: t.Pod):
        """Confirmed (watch-observed) bound pod."""
        with self._lock:
            key = self._pod_key(pod)
            node_name = pod.spec.node_name
            if not node_name:
                return
            prev = self._pod_node.get(key)
            if prev and prev != node_name and prev in self._nodes:
                self._nodes[prev].remove_pod(pod)
            ni = self._nodes.get(node_name)
            if ni is None:
                ni = self._nodes[node_name] = NodeInfo()
            ni.add_pod(pod)
            self._pod_node[key] = node_name
            self._assumed.pop(key, None)  # no longer provisional

    def remove_pod(self, pod: t.Pod):
        with self._lock:
            key = self._pod_key(pod)
            node_name = self._pod_node.pop(key, None) or pod.spec.node_name
            self._assumed.pop(key, None)
            if node_name and node_name in self._nodes:
                self._nodes[node_name].remove_pod(pod)

    def cleanup_expired_assumes(self):
        """Assumed pods whose bind never confirmed release their resources."""
        now = time.monotonic()
        with self._lock:
            for key, deadline in list(self._assumed.items()):
                if deadline < now:
                    self._assumed.pop(key, None)
                    node_name = self._pod_node.pop(key, None)
                    ni = self._nodes.get(node_name) if node_name else None
                    if ni and key in ni.pods:
                        ni.remove_pod(ni.pods[key])
