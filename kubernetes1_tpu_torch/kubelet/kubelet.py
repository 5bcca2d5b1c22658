"""Kubelet: the per-node agent realizing bound pods into running containers.

Ref: pkg/kubelet/kubelet.go — Run (:1361) starts the status/heartbeat loops,
PLEG and syncLoop (:1772/:1839); per-pod workers (pod_workers.go); syncPod
(:1441) = admission -> sandbox -> containers -> status.  The card path
threads through the device manager exactly where the fork put it:
AdmitPod at pod admission (container_manager_linux.go:619-621) and
InitContainer before each container start (kubelet_pods.go:468 ->
GenerateRunContainerOptions), which injects CUDA_VISIBLE_DEVICES.

The port's copy of the JAX package's ``kubelet/kubelet.py``, over the
port's typed clientset.  Left out, as no caller of the port sets them:
static pods, dynamic kubelet config, the static CPU manager, the pod
/metrics scraper, a remote CRI runtime, serving TLS, system-reserved
resources and custom eviction thresholds.  The kubelet writes no pod
cgroup: the host's cgroups stay as they are, so a container's limits are
scheduling arithmetic, its stats the runtime's /proc sampling, and a
SIGKILLed container's reason is Error, never OOMKilled.

Structure here:
- pod source = apiserver informer filtered to spec.nodeName==<me>
  (ref: config/apiserver.go);
- a work queue of pod keys drives N sync workers; PLEG (1s relist) and a
  periodic ticker both enqueue;
- status truth flows one way: runtime state -> computed PodStatus -> status
  subresource PUT when changed (status_manager.go:131,399).
"""

from __future__ import annotations

import json
import os
import secrets
import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

from ..api import types as t
from ..client.clientset import Clientset
from ..client.errors import is_transient, retry_on_conflict
from ..client.events import EventRecorder
from ..deviceplugin.api import DEFAULT_PLUGIN_DIR
from ..machinery import ApiError, Conflict, NotFound, now_iso, to_dict
from ..utils.hostpath import is_under, normalize_abs
from ..utils.retry import call_with_retries
from ..utils.spans import SpanCollector
from ..utils.workqueue import WorkQueue
from .devicemanager import DeviceManager
from .eviction import EvictionManager, default_signals
from .prober import ProberManager
from .runtime import CONTAINER_EXITED, CONTAINER_RUNNING, ContainerConfig, RuntimeService
from .volumemanager import VolumeError, VolumeManager, VolumeNotReady


class Kubelet:
    SYNC_WORKERS = 4
    EVICTION_INTERVAL = 10.0  # seconds between eviction passes

    def __init__(
        self,
        clientset: Clientset,
        node_name: str,
        runtime: RuntimeService,
        plugin_dir: str = DEFAULT_PLUGIN_DIR,
        capacity: Optional[Dict[str, str]] = None,
        heartbeat_interval: float = 5.0,
        sync_interval: float = 1.0,
        pleg_interval: float = 1.0,
        restart_backoff_base: float = 1.0,
        eviction_signals_fn=None,
        server_port: Optional[int] = 0,  # 0 = ephemeral; None = no server
        volume_root: Optional[str] = None,
        server_tls_cert_file: str = "",  # the CSR-issued serving cert (:10250 TLS)
        server_tls_key_file: str = "",
    ):
        self.cs = clientset
        self.node_name = node_name
        self.runtime = runtime
        self.device_manager = DeviceManager(plugin_dir)
        self.device_manager.on_capacity_change = self._heartbeat_now
        self.device_manager.on_device_unhealthy = self._on_device_unhealthy
        self.capacity = capacity or self._default_capacity()
        self.heartbeat_interval = heartbeat_interval
        self.sync_interval = sync_interval
        self.pleg_interval = pleg_interval
        self.restart_backoff_base = restart_backoff_base
        self.recorder = EventRecorder(clientset, f"kubelet/{node_name}")
        # Volume roots must be node-unique: many hollow kubelets share one
        # process in scale tests, and two nodes' emptyDirs must not collide.
        runtime_root = getattr(runtime, "root", None)
        self.volume_manager = VolumeManager(
            clientset,
            volume_root or (
                os.path.join(runtime_root, "volumes") if runtime_root
                else os.path.join("/tmp/ktpu-volumes", node_name)
            ),
            node_name=node_name,
        )
        real_pids = bool(getattr(runtime, "real_pids", False))
        # node-local cluster DNS (ref --cluster-dns + kube-dns addon; see
        # dns/server.py): real-process runtimes only — hollow nodes must
        # not each open informers and a resolver socket.  Binding the
        # loopback alias needs root/port-53 rights; go without DNS
        # (env-injection still works) when the host refuses.
        self.cluster_dns = None
        self.cluster_dns_error = ""
        if real_pids:
            from ..dns import ClusterDNS

            try:
                self.cluster_dns = ClusterDNS(clientset)
            except OSError as e:
                self.cluster_dns_error = str(e)

        self.pods = clientset.informer("pods", field_selector=f"spec.nodeName={node_name}")
        self._queue = WorkQueue()
        self._sandboxes: Dict[str, str] = {}  # pod uid -> sandbox id
        self._containers: Dict[Tuple[str, str], str] = {}  # (uid, cname) -> cid
        self._restart_at: Dict[Tuple[str, str], float] = {}
        self._restarts: Dict[Tuple[str, str], int] = {}
        self._admitted: Dict[str, Tuple[str, str]] = {}
        self._admit_first_seen: Dict[str, float] = {}
        self._last_status: Dict[str, dict] = {}  # uid -> last PUT status dict
        self._pleg_state: Dict[str, str] = {}
        self._mount_warned: set = set()  # uids with a FailedMount event emitted
        self._heartbeat_event = threading.Event()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._lock = threading.RLock()
        self._metrics_rv: Dict[Tuple[str, str], str] = {}  # (kind, key) -> rv
        self._beats = 0
        # per-pod spans under the creating request's trace id (utils/spans),
        # served at the kubelet server's /debug/traces
        self.spans = SpanCollector(f"kubelet/{node_name}")

        self.server = None
        self.server_token = ""
        if server_port is not None:
            from .server import KubeletServer

            # the server's token is minted here and published ONLY in a
            # kube-system Secret the apiserver reads, so reading a pod's
            # logs is gated on apiserver authorization — the shape of the
            # reference's delegated nodes/proxy authz
            self.server_token = secrets.token_hex(16)
            self.server = KubeletServer(self, port=server_port, token=self.server_token,
                                        tls_cert_file=server_tls_cert_file,
                                        tls_key_file=server_tls_key_file)

        self.prober = ProberManager(
            exec_in_container=self._exec_in_container,
            container_running=self._container_running,
        )
        self.eviction = EvictionManager(
            signals_fn=eviction_signals_fn or default_signals,
            evict_fn=self._evict_pod,
            list_pods=self._my_pods,
        )

    # ---------------------------------------------------------------- start

    @staticmethod
    def _default_capacity() -> Dict[str, str]:
        cpus = os.cpu_count() or 4
        mem_kb = 8 * 1024 * 1024
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemTotal:"):
                        mem_kb = int(line.split()[1])
                        break
        except OSError:
            pass
        return {"cpu": str(cpus), "memory": f"{mem_kb}Ki", "pods": "110"}

    def start(self):
        self.device_manager.start()
        if self.server is not None:
            self.server.start()
        if self.cluster_dns is not None:
            self.cluster_dns.start()
        self._reconcile_runtime()
        self._register_node()
        self.pods.add_handler(
            on_add=lambda p: self._enqueue(p),
            on_update=lambda _o, p: self._enqueue(p),
            on_delete=self._enqueue,
        )
        self.pods.start()
        self.pods.wait_for_sync()
        for i in range(self.SYNC_WORKERS):
            th = threading.Thread(target=self._sync_worker, daemon=True, name=f"sync-{i}")
            th.start()
            self._threads.append(th)
        for fn, period_attr, name in (
            (self._heartbeat, "heartbeat_interval", "heartbeat"),
            (self._pleg_relist, "pleg_interval", "pleg"),
            (self._tick_all, "sync_interval", "sync-ticker"),
            (self._publish_metrics, "heartbeat_interval", "stats"),
            (self._eviction_pass, "EVICTION_INTERVAL", "eviction"),
        ):
            th = threading.Thread(
                target=self._loop, args=(fn, period_attr), daemon=True, name=name
            )
            th.start()
            self._threads.append(th)
        return self

    def stop(self):
        self._stop.set()
        self._queue.shut_down()
        self.pods.stop()
        self.device_manager.stop()
        self.prober.stop()
        if self.server is not None:
            self.server.stop()
        if self.cluster_dns is not None:
            self.cluster_dns.stop()

    def _loop(self, fn, period_attr: str):
        while not self._stop.is_set():
            try:
                fn()
            except Exception:  # noqa: BLE001
                traceback.print_exc()
            period = getattr(self, period_attr)
            if fn is self._heartbeat:
                # wake immediately on capacity change
                self._heartbeat_event.wait(period)
                self._heartbeat_event.clear()
            else:
                self._stop.wait(period)

    def _heartbeat_now(self):
        self._heartbeat_event.set()

    def _reconcile_runtime(self):
        """Adopt pre-existing runtime state after a kubelet restart: rebuild
        the sandbox/container maps from the runtime's own records so running
        workloads are NOT duplicated (the reference kubelet rebuilds from the
        CRI the same way; restart-safety e2e relies on this)."""
        sandbox_by_uid: Dict[str, str] = {}
        for sb in self.runtime.list_pod_sandboxes():
            uid = sb.labels.get("pod-uid") or sb.pod_uid
            if uid:
                sandbox_by_uid[uid] = sb.id
        sandbox_to_uid = {sid: uid for uid, sid in sandbox_by_uid.items()}
        containers: Dict[Tuple[str, str], str] = {}
        for c in self.runtime.list_containers():
            uid = sandbox_to_uid.get(c.sandbox_id)
            if uid is None:
                continue
            ckey = (uid, c.name)
            prev = containers.get(ckey)
            if prev is None:
                containers[ckey] = c.id
            else:
                # prefer the running record over exited leftovers
                prev_rec = self.runtime.container_status(prev)
                if prev_rec is None or prev_rec.state != CONTAINER_RUNNING:
                    containers[ckey] = c.id
        with self._lock:
            self._sandboxes.update(sandbox_by_uid)
            self._containers.update(containers)

    # ----------------------------------------------------------- node status

    KUBELET_SERVER_ANNOTATION = "kubelet.ktpu.io/server"
    # The per-kubelet bearer token lives in a kube-system Secret only the
    # apiserver (and this node, via the node authorizer) can read — NOT in a
    # Node annotation, which every kubelet can read (one compromised node
    # would then reach every other).
    TOKEN_SECRET_NS = "kube-system"

    @staticmethod
    def token_secret_name(node_name: str) -> str:
        return f"kubelet-token-{node_name}"

    def _node_object(self) -> t.Node:
        node = t.Node()
        node.metadata.name = self.node_name
        node.metadata.labels = {"kubernetes.io/hostname": self.node_name}
        if self.server is not None:
            # clients resolve the kubelet endpoint from this (the :10250
            # daemonEndpoints analog); the credential travels separately
            node.metadata.annotations[self.KUBELET_SERVER_ANNOTATION] = self.server.url
        self._fill_status(node)
        return node

    def _token_secret(self) -> t.Secret:
        sec = t.Secret(type="ktpu.io/kubelet-token",
                       data={"token": self.server_token})
        sec.metadata.name = self.token_secret_name(self.node_name)
        sec.metadata.namespace = self.TOKEN_SECRET_NS
        return sec

    def _publish_token_secret(self):
        if self.server is None:
            return
        sec = self._token_secret()
        try:
            self.cs.secrets.create(sec, self.TOKEN_SECRET_NS)
        except ApiError:
            try:
                self.cs.secrets.patch(
                    sec.metadata.name, {"data": {"token": self.server_token}},
                    namespace=self.TOKEN_SECRET_NS,
                )
            except ApiError:
                traceback.print_exc()

    def _fill_status(self, node: t.Node):
        node.status.capacity = dict(self.capacity)
        node.status.allocatable = dict(self.capacity)
        now = now_iso()
        node.status.conditions = [
            t.NodeCondition(
                type=t.NODE_READY,
                status="True",
                reason="KubeletReady",
                last_heartbeat_time=now,
            )
        ] + self.eviction.node_conditions()
        node.status.addresses = [t.NodeAddress(type="Hostname", address=self.node_name)]
        node.status.node_info = t.NodeSystemInfo(
            kubelet_version="ktpu-0.1",
            container_runtime_version=self.runtime.version(),
            architecture=os.uname().machine,
            os_image="linux",
        )
        node.status.extended_resources = self.device_manager.get_capacity()
        # image inventory feeds the scheduler's ImageLocality priority
        # (ref kubelet_node_status.go setNodeStatusImages)
        node.status.images = self.runtime.images.list_images()

    def _register_node(self):
        node = self._node_object()
        try:
            # Registration must survive a transport-level reset: the REST
            # layer refuses to re-send a mutation whose response was lost
            # (may-have-been-applied), but node create is safe to retry —
            # an applied first attempt surfaces as ApiError(exists) on the
            # next one, which the handler below already expects.  Without
            # this, a reset during boot kills the whole kubelet.
            call_with_retries(lambda: self.cs.nodes.create(node), is_transient,
                              reason="node_register")
        except ApiError:
            # exists: heartbeat will refresh status, but the server endpoint
            # lives in metadata (a restart may listen on a new port)
            if self.server is not None:
                try:
                    self.cs.nodes.patch(
                        self.node_name,
                        {"metadata": {"annotations": {
                            self.KUBELET_SERVER_ANNOTATION: self.server.url}}},
                        namespace="",
                    )
                except ApiError:
                    pass
        self._publish_token_secret()

    TOKEN_RECHECK_BEATS = 12  # verify the token secret every ~minute

    def _heartbeat(self):
        """10s-class syncNodeStatus (ref: kubelet_node_status.go:545-621)."""
        try:
            node = self.cs.nodes.get(self.node_name, "")
        except NotFound:
            self._register_node()
            return
        self._fill_status(node)
        try:
            self.cs.nodes.update_status(node)
        except Conflict:
            pass  # next beat wins
        # the token secret must outlive registration hiccups and admin
        # deletions — without it every apiserver-proxied log read 401s.  A
        # create answers AlreadyExists while it lives: the Node authorizer
        # lets a node write its token secret but never read a secret that
        # no pod of its mounts (the JAX kubelet GETs it, and is refused)
        self._beats += 1
        if self.server is not None and self._beats % self.TOKEN_RECHECK_BEATS == 0:
            try:
                self.cs.secrets.create(self._token_secret(), self.TOKEN_SECRET_NS)
            except ApiError:
                pass  # AlreadyExists: it lives

    # -------------------------------------------------- probes and eviction

    def _container_running(self, pod_uid: str, container_name: str) -> bool:
        with self._lock:
            cid = self._containers.get((pod_uid, container_name))
        if cid is None:
            return False
        record = self.runtime.container_status(cid)
        return record is not None and record.state == CONTAINER_RUNNING

    def _exec_in_container(self, pod_uid: str, container_name: str, command) -> int:
        with self._lock:
            cid = self._containers.get((pod_uid, container_name))
        if cid is None:
            return -1
        return self.runtime.exec_in_container(cid, command)

    def _my_pods(self) -> List[t.Pod]:
        return [p for p in self.pods.list() if p.spec.node_name == self.node_name]

    def _evict_pod(self, pod: t.Pod, reason: str):
        """Pressure eviction = fail the pod; its controller reschedules it
        elsewhere (ref: eviction_manager.go evictPod)."""
        self.recorder.event(pod, "Warning", "Evicted", reason)
        self._set_failed(pod, "Evicted", reason)
        self._heartbeat_now()  # surface the pressure condition promptly

    def _on_device_unhealthy(self, resource: str, dead_ids):
        """A plugin reported cards dead (ListAndWatch unhealthy): fail every
        pod holding one of them.  Admit-time checks only protect FUTURE
        pods; an already-running pod on a dead card makes no progress
        until its controller (the gang failure policy) replaces it — every
        second here is lost goodput.  Runs on the endpoint's watch thread;
        _set_failed is a plain status PUT, safe off-loop."""
        dead = set(dead_ids)
        for pod in self.pods.list():
            if (pod.status.phase in (t.POD_SUCCEEDED, t.POD_FAILED)
                    or pod.metadata.deletion_timestamp):
                continue
            held = {
                dev_id
                for per in pod.spec.extended_resources
                if per.resource == resource
                for dev_id in per.assigned
            }
            hit = held & dead
            if not hit:
                continue
            msg = (f"assigned device(s) {sorted(hit)} went unhealthy; "
                   f"failing pod so its controller can re-place it")
            self.recorder.event(pod, "Warning", "DeviceUnhealthy", msg)
            self._set_failed(pod, "DeviceUnhealthy", msg)

    def _eviction_pass(self):
        self.eviction.synchronize()

    # -------------------------------------------------------- stats pipeline

    @staticmethod
    def _fmt_usage(stats: Dict[str, float]) -> Dict[str, str]:
        return {
            "cpu": f"{int(round(stats.get('cpu', 0.0) * 1000))}m",
            "memory": str(int(stats.get("memory", 0.0))),
        }

    def _upsert_metrics(self, client, obj, namespace: str = ""):
        # Steady state is update (the object exists after the first cycle);
        # create only on the first publish or after a GC.
        cached = self._metrics_rv.get((type(obj).KIND, obj.key()))
        try:
            if cached is not None:
                obj.metadata.resource_version = cached
                updated = client.update(obj)
            else:
                updated = client.create(obj, namespace)
        except NotFound:
            try:
                updated = client.create(obj, namespace)
            except ApiError:
                return
        except ApiError:  # Conflict/AlreadyExists: refresh rv, next cycle wins
            try:
                cur = client.get(obj.metadata.name, obj.metadata.namespace)
                self._metrics_rv[(type(obj).KIND, obj.key())] = cur.metadata.resource_version
            except ApiError:
                self._metrics_rv.pop((type(obj).KIND, obj.key()), None)
            return
        self._metrics_rv[(type(obj).KIND, obj.key())] = updated.metadata.resource_version

    def stats_summary(self) -> dict:
        """Summary-API analog (ref: pkg/kubelet/server/stats/summary.go):
        node totals + per-pod per-container point-in-time usage, served at
        the kubelet server's /stats/summary."""
        pods_out = []
        node_cpu, node_mem = 0.0, 0.0
        for pod in self.pods.list():
            with self._lock:
                cids = {
                    name: cid
                    for (uid, name), cid in self._containers.items()
                    if uid == pod.metadata.uid
                }
            containers = []
            for cname, cid in sorted(cids.items()):
                stats = self.runtime.container_stats(cid)
                node_cpu += stats.get("cpu", 0.0)
                node_mem += stats.get("memory", 0.0)
                containers.append({
                    "name": cname,
                    "cpu_cores": round(stats.get("cpu", 0.0), 4),
                    "memory_bytes": int(stats.get("memory", 0.0)),
                })
            pods_out.append({"pod": pod.key(), "containers": containers})
        return {
            "node": {
                "nodeName": self.node_name,
                "capacity": dict(self.capacity),
                "cpu_cores": round(node_cpu, 4),
                "memory_bytes": int(node_mem),
            },
            "pods": pods_out,
        }

    def _publish_metrics(self):
        """Resource-metrics pipeline, one hop: runtime stats → PodMetrics /
        NodeMetrics objects (ref: cadvisor → /stats/summary
        (server/stats/summary.go) → metrics-server → metrics.k8s.io)."""
        now = now_iso()
        node_cpu, node_mem = 0.0, 0.0
        for pod in self._my_pods():
            with self._lock:
                cids = {
                    name: cid
                    for (uid, name), cid in self._containers.items()
                    if uid == pod.metadata.uid
                }
            if not cids:
                continue
            pm = t.PodMetrics(timestamp=now)
            pm.metadata.name = pod.metadata.name
            pm.metadata.namespace = pod.metadata.namespace
            for cname, cid in sorted(cids.items()):
                stats = self.runtime.container_stats(cid)
                node_cpu += stats.get("cpu", 0.0)
                node_mem += stats.get("memory", 0.0)
                pm.containers.append(
                    t.ContainerMetrics(name=cname, usage=self._fmt_usage(stats))
                )
            self._upsert_metrics(self.cs.podmetrics, pm, pod.metadata.namespace)
        nm = t.NodeMetrics(
            timestamp=now, usage=self._fmt_usage({"cpu": node_cpu, "memory": node_mem})
        )
        nm.metadata.name = self.node_name
        self._upsert_metrics(self.cs.nodemetrics, nm)

    # ------------------------------------------------------------ pod source

    def _enqueue(self, pod: t.Pod):
        self._queue.add(pod.key())

    def _tick_all(self):
        for pod in self.pods.list():
            self._queue.add(pod.key())

    # ----------------------------------------------------------------- PLEG

    def _pleg_relist(self):
        """1s relist-and-diff (ref: pleg/generic.go:182): container state
        changes enqueue their pod for sync."""
        current: Dict[str, str] = {}
        sandbox_pod: Dict[str, str] = {}
        for sb in self.runtime.list_pod_sandboxes():
            sandbox_pod[sb.id] = f"{sb.pod_namespace}/{sb.pod_name}"
        for c in self.runtime.list_containers():
            current[c.id] = c.state
            old = self._pleg_state.get(c.id)
            if old != c.state:
                pod_key = sandbox_pod.get(c.sandbox_id)
                if pod_key:
                    self._queue.add(pod_key)
        self._pleg_state = current

    # --------------------------------------------------------- sync workers

    def _sync_worker(self):
        while not self._stop.is_set():
            key = self._queue.get(timeout=0.5)
            if key is None:
                continue
            try:
                pod = self.pods.get(key)
                if pod is None:
                    self._cleanup_missing(key)
                else:
                    self.sync_pod(pod)
            except Exception:  # noqa: BLE001
                traceback.print_exc()
            finally:
                self._queue.done(key)

    def _cleanup_missing(self, key: str):
        """Pod vanished from the API: tear down any leftover runtime state."""
        ns, name = key.split("/", 1)
        for sb in self.runtime.list_pod_sandboxes():
            if sb.pod_namespace == ns and sb.pod_name == name:
                self.runtime.remove_pod_sandbox(sb.id)
                with self._lock:
                    self._sandboxes.pop(sb.pod_uid, None)
                    for k in [k for k in self._containers if k[0] == sb.pod_uid]:
                        self._containers.pop(k, None)
                self.device_manager.forget_pod(sb.pod_uid)
                self.volume_manager.teardown_pod(sb.pod_uid)
                self._prune_pod_state(sb.pod_uid)

    # -------------------------------------------------------------- syncPod

    def sync_pod(self, pod: t.Pod):
        """ref: kubelet.go:1441 syncPod."""
        uid = pod.metadata.uid
        if pod.metadata.deletion_timestamp:
            self._terminate_pod(pod)
            return
        if pod.status.phase in (t.POD_SUCCEEDED, t.POD_FAILED):
            self.prober.remove_pod(uid)  # finished pods are never probed
            self._ensure_stopped(pod)
            return

        verdict, reason = self._admit(pod)
        if verdict == "fail":
            self._set_failed(pod, "AdmissionError", reason)
            return
        if verdict == "wait":
            return  # infrastructure warming up; sync ticker retries

        # Volumes before containers (ref: syncPod order — WaitForAttachAndMount
        # precedes runtime SyncPod).  Unready sources wait; broken ones fail.
        try:
            self.volume_manager.mount_pod(pod)
            self.volume_manager.refresh_pod(pod)
        except VolumeNotReady as e:
            if uid not in self._mount_warned:
                self._mount_warned.add(uid)
                self.recorder.event(pod, "Warning", "FailedMount", str(e))
            return  # sync ticker retries
        except VolumeError as e:
            self._set_failed(pod, "FailedMount", str(e))
            return

        sandbox_id = self._ensure_sandbox(pod)
        # init containers run sequentially to completion BEFORE any app
        # container starts (ref kuberuntime_manager.go computePodActions:
        # next init container gates the whole pod)
        init_state = self._sync_init_containers(pod, sandbox_id)
        if init_state == "failed":
            return  # _set_failed already PUT the terminal status
        if init_state == "wait":
            self._sync_status(pod)
            return
        if self._sync_containers(pod, sandbox_id) == "failed":
            # _set_failed already PUT the terminal status: a computed
            # Pending over it would flip the pod Failed -> Pending -> Failed
            return
        self.prober.ensure_pod(pod)
        self._sync_status(pod)

    def _sync_init_containers(self, pod: t.Pod, sandbox_id: str) -> str:
        """Advance the init-container sequence one sync at a time.
        Returns "done" (all exited 0), "wait" (in progress / backoff), or
        "failed" (terminal status already written)."""
        uid = pod.metadata.uid
        for container in pod.spec.init_containers:
            ckey = (uid, container.name)
            with self._lock:
                cid = self._containers.get(ckey)
            record = self.runtime.container_status(cid) if cid else None
            if record is not None and record.state == CONTAINER_RUNNING:
                return "wait"  # wait for it; ticker re-syncs
            if record is not None and record.state not in (
                    CONTAINER_RUNNING, CONTAINER_EXITED):
                # CREATED (kubelet died between create and start, record
                # adopted on restart): start it — falling through here
                # would skip the init container entirely
                try:
                    self.runtime.start_container(record.id)
                except Exception as e:  # noqa: BLE001
                    self.recorder.event(pod, "Warning", "FailedStart",
                                        f"init {container.name}: {e}")
                return "wait"
            if record is not None and record.state == CONTAINER_EXITED:
                if record.exit_code == 0:
                    continue  # done; on to the next init container
                # failed init container: Never fails the pod; otherwise the
                # SAME instance restarts with crash backoff (ref: init
                # containers restart under OnFailure/Always alike)
                if pod.spec.restart_policy == "Never":
                    self._set_failed(
                        pod, "InitContainerError",
                        f"init container {container.name} exited "
                        f"{record.exit_code}")
                    return "failed"
                now = time.monotonic()
                with self._lock:
                    n = self._restarts.get(ckey, 0)
                    if now < self._restart_at.get(ckey, 0.0):
                        return "wait"  # backoff; ticker retries
                    self._restarts[ckey] = n + 1
                    self._restart_at[ckey] = now + min(
                        self.restart_backoff_base * (2**n), 300.0)
                self.runtime.remove_container(record.id)
                self.recorder.event(
                    pod, "Normal", "Restarting",
                    f"init container {container.name} exited "
                    f"{record.exit_code}; restarting")
                record = None
            if record is None:
                with self._lock:
                    if time.monotonic() < self._restart_at.get(ckey, 0.0):
                        return "wait"
                try:
                    config = self._container_config(pod, container)
                except VolumeNotReady:
                    return "wait"  # ticker retries once sources appear
                except VolumeError as e:
                    self._set_failed(pod, "CreateContainerConfigError", str(e))
                    return "failed"
                cid = None  # the looked-up id is stale past this point
                try:
                    self._pull_image(container)
                    cid = self.runtime.create_container(sandbox_id, config)
                    self.runtime.start_container(cid)
                    with self._lock:
                        self._containers[ckey] = cid
                    self.recorder.event(
                        pod, "Normal", "Started",
                        f"init container {container.name}")
                except Exception as e:  # noqa: BLE001
                    if cid is not None:
                        try:
                            self.runtime.remove_container(cid)
                        except (OSError, RuntimeError, KeyError):
                            pass  # cleanup of a half-created container is best-effort
                    if self._is_terminal_config_error(e):
                        self._set_failed(pod, "CreateContainerConfigError",
                                         f"init {container.name}: {e}")
                        return "failed"
                    now = time.monotonic()
                    with self._lock:
                        n = self._restarts.get(ckey, 0)
                        self._restarts[ckey] = n + 1
                        self._restart_at[ckey] = now + min(
                            self.restart_backoff_base * (2**n), 300.0)
                    self.recorder.event(pod, "Warning", "FailedStart",
                                        f"init {container.name}: {e}")
                return "wait"  # started (or failed to): wait for next sync
        return "done"

    @staticmethod
    def _is_terminal_config_error(e: Exception) -> bool:
        """Start failures that can NEVER succeed by retrying: an identity
        request the host cannot honor (non-root kubelet, missing setpriv —
        runtime.py _wrap_with_user).  These must fail the pod terminally,
        not back off forever."""
        return isinstance(e, PermissionError) or \
            "requires a root" in str(e)

    ADMISSION_GRACE_SECONDS = 30.0

    @staticmethod
    def _pod_trace_id(pod: t.Pod) -> str:
        return (pod.metadata.annotations or {}).get(t.TRACE_ID_ANNOTATION, "")

    def _stamp_admitted(self, pod: t.Pod):
        """Persist the device-admission instant for the pod-startup SLI
        decomposition (utils/slo).  Once per pod (a kubelet restart must
        not overwrite the original stamp); best-effort — SLI bookkeeping
        must never block a pod from starting."""
        if t.ADMITTED_AT_ANNOTATION in (pod.metadata.annotations or {}):
            return
        try:
            self.cs.pods.patch(
                pod.metadata.name,
                {"metadata": {"annotations": {
                    t.ADMITTED_AT_ANNOTATION: f"{time.time():.6f}"}}},
                namespace=pod.metadata.namespace,
            )
        except (ApiError, OSError):
            pass

    def _admit(self, pod: t.Pod) -> Tuple[str, str]:
        """Returns ('ok'|'wait'|'fail', reason).  Retriable denials (device
        manager warming up after kubelet/plugin restart) wait up to
        ADMISSION_GRACE_SECONDS before failing the pod."""
        uid = pod.metadata.uid
        with self._lock:
            cached = self._admitted.get(uid)
        if cached is not None:
            return cached
        # the card path's signature span: scheduler-assigned device IDs
        # verified against local inventory + the plugin's AdmitPod RPC
        span_name = ("kubelet.device_allocation"
                     if pod.spec.extended_resources else "kubelet.admit")
        with self.spans.start_span(span_name,
                                   trace_id=self._pod_trace_id(pod),
                                   pod=pod.key()) as sp:
            result = self.device_manager.admit_pod(pod)
            if result.allowed:
                with self._lock:
                    self._admitted[uid] = ("ok", "")
                self._stamp_admitted(pod)
                return "ok", ""
            sp.annotate(denied=result.reason, retriable=result.retriable)
        if result.retriable:
            with self._lock:
                first = self._admit_first_seen.setdefault(uid, time.monotonic())
            if time.monotonic() - first < self.ADMISSION_GRACE_SECONDS:
                return "wait", result.reason
        self.recorder.event(pod, "Warning", "AdmissionError", result.reason)
        with self._lock:
            self._admitted[uid] = ("fail", result.reason)
        return "fail", result.reason

    def _ensure_sandbox(self, pod: t.Pod) -> str:
        uid = pod.metadata.uid
        with self._lock:
            sid = self._sandboxes.get(uid)
        if sid is not None:
            return sid
        with self.spans.start_span("kubelet.create_sandbox",
                                   trace_id=self._pod_trace_id(pod),
                                   pod=pod.key()):
            sid = self.runtime.run_pod_sandbox(
                pod.metadata.name, pod.metadata.namespace, uid,
                labels={"pod-uid": uid},
            )
        with self._lock:
            self._sandboxes[uid] = sid
        return sid

    def _resolv_conf_path(self, namespace: str) -> str:
        """Per-namespace resolv.conf under the volume root (the search
        path differs per namespace), written once and reused."""
        d = os.path.join(self.volume_manager.root, "resolv")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{namespace}.conf")
        content = self.cluster_dns.resolv_conf(namespace)
        try:
            with open(path) as f:
                if f.read() == content:
                    return path
        except OSError:
            pass
        with open(path, "w") as f:
            f.write(content)
        return path

    def _container_config(self, pod: t.Pod, container: t.Container) -> ContainerConfig:
        """GenerateRunContainerOptions (ref kubelet_pods.go:468): pod env
        (incl. valueFrom/envFrom/downward API) + volume mounts +
        device-plugin injection merged into the CRI config."""
        env = self.volume_manager.make_environment(pod, container)
        # in-pod API access: the mounted SA token + this endpoint is the
        # KUBERNETES_SERVICE_HOST/PORT analog
        env.setdefault("KTPU_APISERVER", self.cs.client.url)
        dns_mount = None
        if self.cluster_dns is not None:
            # cluster DNS wiring (ref --cluster-dns): the resolver address
            # rides env for library clients, and the pod's resolv.conf
            # rides as a mount at /etc/resolv.conf (the process runtime,
            # which makes no mount namespace, hands its path over as
            # KTPU_VOLUME_CLUSTER_DNS_RESOLV)
            env.setdefault("KTPU_DNS_SERVER", self.cluster_dns.ip)
            ns = pod.metadata.namespace or "default"
            dns_mount = {"name": "cluster-dns-resolv",
                         "host_path": self._resolv_conf_path(ns),
                         "container_path": "/etc/resolv.conf",
                         "read_only": True}
        spec = self.device_manager.init_container(pod, container)
        env.update(spec.envs)
        devices = [vars(d) for d in spec.devices]
        mounts = self.volume_manager.mounts_for_container(pod, container)
        mounts += [vars(m) for m in spec.mounts]
        if dns_mount is not None:
            mounts.append(dns_mount)
        annotations = dict(spec.annotations)
        # securityContext (ref pkg/securitycontext + kuberuntime's
        # verifyRunAsNonRoot): resolve the effective identity, refuse a
        # runAsNonRoot container that would land on uid 0, and gate raw
        # /dev hostPath mounts on privileged — unprivileged pods get cards
        # ONLY through the device-plugin allocation path
        sc = t.effective_security_context(pod, container)
        if sc.run_as_non_root:
            uid = sc.run_as_user
            if uid is None:
                # No numeric uid anywhere in the spec: the container will
                # exec as the RUNTIME's identity — this framework's analog
                # of the image USER that upstream kuberuntime resolves for
                # verifyRunAsNonRoot.  Unknown identity fails CLOSED:
                # admitting would risk silently running as root.
                uid = self.runtime.default_uid
                if uid is None:
                    raise VolumeError(
                        f"container {container.name}: runAsNonRoot is "
                        f"set with no runAsUser and the runtime does "
                        f"not report its identity — refusing rather "
                        f"than risk root")
            if uid == 0:
                raise VolumeError(
                    f"container {container.name}: runAsNonRoot is set but "
                    f"the container would run as root"
                    f"{' (runtime identity)' if sc.run_as_user is None else ''}")
        if not sc.privileged:
            for m in mounts:
                host = normalize_abs(m.get("host_path") or "")
                if is_under(host, "/dev"):
                    raise VolumeError(
                        f"container {container.name}: hostPath {host!r} "
                        f"requires privileged: true (device access is "
                        f"granted via nvidia.com/gpu requests, not raw "
                        f"/dev mounts)")
        return ContainerConfig(
            name=container.name,
            image=container.image,
            command=list(container.command),
            args=list(container.args),
            env=env,
            working_dir=container.working_dir,
            devices=devices,
            mounts=mounts,
            annotations=annotations,
            run_as_user=sc.run_as_user,
            run_as_group=sc.run_as_group,
            privileged=bool(sc.privileged),
        )

    def _sync_containers(self, pod: t.Pod, sandbox_id: str) -> str:
        """Create, restart or leave each app container.  Returns "failed"
        when a config error wrote the pod's terminal status, else ""."""
        uid = pod.metadata.uid
        for container in pod.spec.containers:
            ckey = (uid, container.name)
            with self._lock:
                cid = self._containers.get(ckey)
            record = self.runtime.container_status(cid) if cid else None
            if record is not None and record.state == CONTAINER_RUNNING:
                if self.prober.liveness_failed(uid, container.name):
                    # failing liveness => kill; the restart path below brings
                    # it back with backoff (ref: prober result -> syncPod kill)
                    self.recorder.event(
                        pod, "Warning", "Unhealthy",
                        f"liveness probe failed for {container.name}; restarting",
                    )
                    self.runtime.stop_container(record.id, timeout=2.0)
                    self.prober.restart_container(uid, container.name)
                    record = self.runtime.container_status(record.id)
                    if record is None or record.state == CONTAINER_RUNNING:
                        continue
                else:
                    continue
            if record is not None and record.state == CONTAINER_EXITED:
                if not self._should_restart(pod, record.exit_code):
                    continue
                now = time.monotonic()
                with self._lock:
                    n = self._restarts.get(ckey, 0)
                    next_at = self._restart_at.get(ckey, 0.0)
                if now < next_at:
                    continue  # backoff; ticker retries
                with self._lock:
                    self._restarts[ckey] = n + 1
                    self._restart_at[ckey] = now + min(
                        self.restart_backoff_base * (2**n), 300.0
                    )
                self.runtime.remove_container(record.id)
                # probe state belongs to the dead instance — reset so stale
                # failures aren't charged to the replacement
                self.prober.restart_container(uid, container.name)
                self.recorder.event(
                    pod, "Normal", "Restarting",
                    f"container {container.name} exited {record.exit_code}; restarting",
                )
            # create + start (start failures back off like crash restarts and
            # must not leak the half-created container record)
            with self._lock:
                if time.monotonic() < self._restart_at.get(ckey, 0.0):
                    continue
            cid = None
            try:
                config = self._container_config(pod, container)
            except VolumeNotReady as e:
                # transient (envFrom source not yet visible): per-tick retry,
                # not the exponential FailedStart backoff
                if uid not in self._mount_warned:
                    self._mount_warned.add(uid)
                    self.recorder.event(pod, "Warning", "FailedMount", str(e))
                continue
            except VolumeError as e:
                # permanent config error (missing key): fail the pod like the
                # reference's CreateContainerConfigError terminal path
                self._set_failed(pod, "CreateContainerConfigError", str(e))
                return "failed"
            try:
                self._pull_image(container)
                # the span covers the card's injection spec landing in the
                # CRI create — the tail of the device_allocation path
                with self.spans.start_span(
                        "kubelet.start_container",
                        trace_id=self._pod_trace_id(pod), pod=pod.key(),
                        container=container.name,
                        devices=len(config.devices)):
                    cid = self.runtime.create_container(sandbox_id, config)
                    self.runtime.start_container(cid)
                with self._lock:
                    self._containers[ckey] = cid
                self.recorder.event(
                    pod, "Normal", "Started", f"container {container.name} started"
                )
            except Exception as e:  # noqa: BLE001
                if cid is not None:
                    try:
                        self.runtime.remove_container(cid)
                    except (OSError, RuntimeError, KeyError):
                        pass  # cleanup of a half-created container is best-effort
                if self._is_terminal_config_error(e):
                    self._set_failed(pod, "CreateContainerConfigError",
                                     f"container {container.name}: {e}")
                    return "failed"
                with self._lock:
                    n = self._restarts.get(ckey, 0)
                    self._restarts[ckey] = n + 1
                    self._restart_at[ckey] = time.monotonic() + min(
                        self.restart_backoff_base * (2**n), 300.0
                    )
                self.recorder.event(
                    pod, "Warning", "FailedStart",
                    f"container {container.name}: {e}",
                )
        return ""

    def _pull_image(self, container: t.Container):
        """imagePullPolicy (ref kuberuntime_container.go:88), init
        containers too: Always re-pulls; Never skips; the default pulls
        when the image is absent."""
        images = self.runtime.images
        policy = container.image_pull_policy or "IfNotPresent"
        if policy == "Always" or (policy != "Never" and not images.image_present(container.image)):
            images.pull_image(container.image)

    @staticmethod
    def _should_restart(pod: t.Pod, exit_code: Optional[int]) -> bool:
        policy = pod.spec.restart_policy
        if policy == "Always":
            return True
        if policy == "OnFailure":
            return exit_code not in (0, None)
        return False

    # ------------------------------------------------------------- teardown

    def _terminate_pod(self, pod: t.Pod):
        """Graceful deletion: stop containers, remove sandbox, then force
        delete so the API object goes away (the reference's kubelet sends
        the final grace-0 delete)."""
        uid = pod.metadata.uid
        with self._lock:
            sid = self._sandboxes.get(uid)
        if sid is not None:
            self.runtime.stop_pod_sandbox(sid)
            self.runtime.remove_pod_sandbox(sid)
            with self._lock:
                self._sandboxes.pop(uid, None)
                for k in [k for k in self._containers if k[0] == uid]:
                    self._containers.pop(k, None)
        self.device_manager.forget_pod(uid)
        self.volume_manager.teardown_pod(uid)
        self._prune_pod_state(uid)
        try:
            self.cs.pods.delete(
                pod.metadata.name, pod.metadata.namespace, grace_seconds=0
            )
        except ApiError:
            pass

    def _prune_pod_state(self, uid: str):
        """Drop every per-pod bookkeeping entry (unbounded growth otherwise
        under Job-style pod churn)."""
        self.prober.remove_pod(uid)
        self._mount_warned.discard(uid)
        with self._lock:
            self._admitted.pop(uid, None)
            self._admit_first_seen.pop(uid, None)
            self._last_status.pop(uid, None)
            for k in [k for k in self._restarts if k[0] == uid]:
                self._restarts.pop(k, None)
            for k in [k for k in self._restart_at if k[0] == uid]:
                self._restart_at.pop(k, None)

    def _ensure_stopped(self, pod: t.Pod):
        uid = pod.metadata.uid
        with self._lock:
            sid = self._sandboxes.get(uid)
        if sid is not None:
            self.runtime.stop_pod_sandbox(sid)

    def _set_failed(self, pod: t.Pod, reason: str, message: str):
        """PUT the pod's terminal status once, onto the pod as the apiserver
        holds it: this sync's own admitted-at stamp may have moved it past
        the informer snapshot, and a write refused for that would leave the
        next sync to write it again."""
        def put():
            fresh = self.cs.pods.get(pod.metadata.name, pod.metadata.namespace)
            if fresh.metadata.uid != pod.metadata.uid or \
                    fresh.status.phase in (t.POD_SUCCEEDED, t.POD_FAILED):
                return
            fresh.status.phase = t.POD_FAILED
            fresh.status.reason = reason
            fresh.status.message = message
            self.cs.pods.update_status(fresh)

        try:
            retry_on_conflict(put)
        except ApiError:
            pass

    # --------------------------------------------------------------- status

    def _compute_status(self, pod: t.Pod) -> t.PodStatus:
        uid = pod.metadata.uid
        status = t.PodStatus()
        status.host_ip = self.node_name
        status.pod_ip = "127.0.0.1"
        status.start_time = pod.status.start_time or now_iso()
        statuses: List[t.ContainerStatus] = []
        running = exited_ok = exited_bad = waiting = 0
        for container in pod.spec.containers:
            ckey = (uid, container.name)
            with self._lock:
                cid = self._containers.get(ckey)
                restarts = self._restarts.get(ckey, 0)
            record = self.runtime.container_status(cid) if cid else None
            cs = t.ContainerStatus(
                name=container.name, image=container.image, restart_count=restarts
            )
            if record is None:
                waiting += 1
                cs.state.waiting = t.ContainerStateWaiting(reason="ContainerCreating")
            elif record.state == CONTAINER_RUNNING:
                running += 1
                cs.ready = self.prober.is_ready(uid, container.name)
                cs.container_id = record.id
                cs.state.running = t.ContainerStateRunning(
                    started_at=_iso(record.started_at)
                )
            elif record.state == CONTAINER_EXITED:
                cs.container_id = record.id
                reason = "Completed" if record.exit_code == 0 else "Error"
                cs.state.terminated = t.ContainerStateTerminated(
                    exit_code=record.exit_code or 0,
                    reason=reason,
                    started_at=_iso(record.started_at),
                    finished_at=_iso(record.finished_at),
                )
                if record.exit_code == 0:
                    exited_ok += 1
                else:
                    exited_bad += 1
            else:
                waiting += 1
                cs.state.waiting = t.ContainerStateWaiting(reason="Created")
            statuses.append(cs)
        status.container_statuses = statuses
        total = len(pod.spec.containers)
        policy = pod.spec.restart_policy
        if running == total and total > 0:
            status.phase = t.POD_RUNNING
        elif exited_ok == total and policy != "Always":
            status.phase = t.POD_SUCCEEDED
        elif exited_bad > 0 and policy == "Never":
            status.phase = t.POD_FAILED
        elif running > 0:
            status.phase = t.POD_RUNNING
        else:
            status.phase = t.POD_PENDING
        ready = all(c.ready for c in statuses) and status.phase == t.POD_RUNNING
        status.conditions = [
            t.PodCondition(
                type="Ready",
                status="True" if ready else "False",
                last_transition_time=now_iso(),
            ),
            t.PodCondition(type="PodScheduled", status="True"),
        ]
        return status

    def _sync_status(self, pod: t.Pod):
        """statusManager syncBatch (ref status_manager.go:399): PUT only on
        change (conditions' timestamps excluded from the comparison)."""
        status = self._compute_status(pod)
        desired = to_dict(status)
        comparable = json.dumps(
            {k: v for k, v in desired.items() if k != "conditions"}, sort_keys=True
        )
        uid = pod.metadata.uid
        with self._lock:
            if self._last_status.get(uid) == comparable:
                return
        fresh = pod.clone()  # clone-before-mutate: pod is an informer snapshot
        fresh.status = status
        try:
            # unified retry policy (client/retry): transient failures —
            # overload sheds past the transport's own budget, 5xx, link
            # faults — back off with full jitter and retry in place;
            # terminal ones fall through to the handlers below
            call_with_retries(lambda: self.cs.pods.update_status(fresh), is_transient,
                              steps=3, reason="status_sync")
            with self._lock:
                self._last_status[uid] = comparable
        except NotFound:
            pass
        except Conflict:
            # stale informer copy (e.g. the SLI admitted-at patch just
            # bumped the rv): the next sync retries from the fresh object
            pass
        except (ConnectionError, TimeoutError):
            # transport still down after the retry budget: the next sync
            # tick retries from a fresh informer snapshot
            pass
        except ApiError:
            traceback.print_exc()


def _iso(ts: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(ts)) if ts else ""
