"""Kubelet volume manager + pod environment construction.

Ref: pkg/kubelet/volumemanager/volume_manager.go:149 (desired/actual world
reconciler feeding mounts into container start) and
pkg/kubelet/kubelet_pods.go:591 (makeEnvironmentVariables: valueFrom /
envFrom / downward API / service-account token automount).

The port's copy of the JAX package's ``kubelet/volumemanager.py``.

Node-local shape: there is no cloud attach/detach step — every supported
source materializes to a host directory which the runtime hands to the
container as KTPU_VOLUME_<NAME> (ProcessRuntime) or records (FakeRuntime):

- emptyDir                -> <root>/pods/<uid>/volumes/emptydir/<name>
                             (created on first mount, deleted with the pod —
                             pod-lifetime scratch, the checkpoint staging dir)
- hostPath                -> the host path itself (created if absent)
- configMap / secret      -> <root>/pods/<uid>/volumes/{configmap,secret}/<name>
                             one file per key, atomically refreshed when the
                             API object changes (the reference's AtomicWriter
                             ..data symlink dance collapsed to per-file
                             os.replace, which is atomic on one filesystem)
- persistentVolumeClaim   -> the bound PV's hostPath (local-storage model;
                             the PVC must be Bound — pods wait otherwise,
                             matching WaitForFirstConsumer behavior)
- downwardAPI             -> files rendered from pod fields
- service-account token   -> automounted at
                             /var/run/secrets/kubernetes.io/serviceaccount
                             {token, namespace} from the SA's token Secret
                             (ref: serviceaccount admission + token volume)

Secrets are written 0600 under a 0700 dir.  Refresh piggybacks on the
kubelet sync ticker: `refresh_pod` re-reads ConfigMap/Secret sources at most
once per `REFRESH_INTERVAL` per pod (the reference's cache-TTL analog).
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..api import types as t
from ..machinery import Forbidden, NotFound

SA_TOKEN_MOUNT_PATH = "/var/run/secrets/kubernetes.io/serviceaccount"
SA_TOKEN_VOLUME = "ktpu-sa-token"


class VolumeError(Exception):
    """Permanent volume failure (unknown source, missing required object)."""


class VolumeNotReady(Exception):
    """Transient: PVC unbound / object not yet visible; sync retries."""


@dataclass
class MountedVolume:
    name: str
    host_path: str
    read_only: bool = False  # source-level (secret/configmap dirs stay rw for refresh)
    kind: str = ""           # emptydir | hostpath | configmap | secret | pvc | downwardapi | satoken


class VolumeManager:
    """Materializes pod volumes into host directories and builds container
    environments.  One instance per kubelet; thread-safe (sync workers call
    concurrently for different pods)."""

    REFRESH_INTERVAL = 10.0  # seconds between re-reads of a pod's sources

    def __init__(self, clientset, root_dir: str, node_name: str = ""):
        self.cs = clientset
        self.root = root_dir
        self.node_name = node_name
        self._lock = threading.RLock()
        self._mounted: Dict[str, Dict[str, MountedVolume]] = {}  # uid -> name -> mv
        self._last_refresh: Dict[str, float] = {}

    # ------------------------------------------------------------- mounting

    def _pod_dir(self, uid: str) -> str:
        return os.path.join(self.root, "pods", uid, "volumes")

    def mount_pod(self, pod: t.Pod) -> Dict[str, MountedVolume]:
        """Ensure every volume in pod.spec.volumes (plus the automounted SA
        token) exists on disk; returns name -> MountedVolume.  Raises
        VolumeNotReady for unbound PVCs (caller treats as wait-and-retry)."""
        uid = pod.metadata.uid
        with self._lock:
            cached = self._mounted.get(uid)
        if cached is not None:
            # hot path: the sync ticker calls every second; content updates
            # are refresh_pod's job, so a mounted pod costs no API reads here
            return cached
        out: Dict[str, MountedVolume] = {}
        for vol in pod.spec.volumes:
            out[vol.name] = self._mount_volume(pod, vol)
        sa_mv = self._mount_sa_token(pod)
        if sa_mv is not None:
            out[SA_TOKEN_VOLUME] = sa_mv
        with self._lock:
            self._mounted[uid] = out
            # content is fresh as of now — refresh_pod must not re-fetch
            # everything again on the same sync pass
            self._last_refresh[uid] = time.monotonic()
        return out

    def _mount_volume(self, pod: t.Pod, vol: t.Volume) -> MountedVolume:
        uid = pod.metadata.uid
        ns = pod.metadata.namespace
        if vol.empty_dir is not None:
            path = os.path.join(self._pod_dir(uid), "emptydir", vol.name)
            os.makedirs(path, exist_ok=True)
            return MountedVolume(vol.name, path, kind="emptydir")
        if vol.host_path is not None:
            # an existing path is used as-is (file hostPaths are legal —
            # sockets, single config files); only a missing path becomes a dir
            if not os.path.exists(vol.host_path.path):
                os.makedirs(vol.host_path.path, exist_ok=True)
            return MountedVolume(vol.name, vol.host_path.path, kind="hostpath")
        if vol.config_map is not None:
            path = os.path.join(self._pod_dir(uid), "configmap", vol.name)
            try:
                cm = self.cs.configmaps.get(vol.config_map.name, ns)
            except NotFound:
                if vol.config_map.optional:
                    os.makedirs(path, exist_ok=True)
                    return MountedVolume(vol.name, path, True, kind="configmap")
                raise VolumeNotReady(f"configmap {ns}/{vol.config_map.name} not found")
            data = _select_items(cm.data, vol.config_map.items)
            _write_dir(path, data)
            return MountedVolume(vol.name, path, True, kind="configmap")
        if vol.secret is not None:
            path = os.path.join(self._pod_dir(uid), "secret", vol.name)
            try:
                sec = self.cs.secrets.get(vol.secret.secret_name, ns)
            except NotFound:
                if vol.secret.optional:
                    os.makedirs(path, exist_ok=True)
                    os.chmod(path, 0o700)
                    return MountedVolume(vol.name, path, True, kind="secret")
                raise VolumeNotReady(f"secret {ns}/{vol.secret.secret_name} not found")
            data = _select_items(sec.data, vol.secret.items)
            _write_dir(path, data, secret=True)
            return MountedVolume(vol.name, path, True, kind="secret")
        if vol.persistent_volume_claim is not None:
            claim = vol.persistent_volume_claim.claim_name
            try:
                pvc = self.cs.persistentvolumeclaims.get(claim, ns)
            except NotFound:
                raise VolumeNotReady(f"pvc {ns}/{claim} not found")
            if pvc.status.phase != "Bound" or not pvc.spec.volume_name:
                raise VolumeNotReady(f"pvc {ns}/{claim} is {pvc.status.phase or 'Pending'}, not Bound")
            try:
                pv = self.cs.persistentvolumes.get(pvc.spec.volume_name, "")
            except NotFound:
                raise VolumeNotReady(f"pv {pvc.spec.volume_name} not found")
            if pv.spec.host_path is None:
                raise VolumeError(
                    f"pv {pv.metadata.name}: only hostPath-backed PVs are "
                    f"mountable on this node (local-storage model)"
                )
            if not os.path.exists(pv.spec.host_path.path):
                os.makedirs(pv.spec.host_path.path, exist_ok=True)
            ro = bool(pvc.spec.access_modes) and set(pvc.spec.access_modes) == {"ReadOnlyMany"}
            return MountedVolume(vol.name, pv.spec.host_path.path, ro, kind="pvc")
        if vol.downward_api is not None:
            path = os.path.join(self._pod_dir(uid), "downwardapi", vol.name)
            data = {}
            for item in vol.downward_api.items:
                if item.field_ref is None or not item.path:
                    continue
                data[item.path] = resolve_field_ref(pod, item.field_ref.field_path,
                                                    self.node_name)
            _write_dir(path, data)
            return MountedVolume(vol.name, path, True, kind="downwardapi")
        raise VolumeError(f"volume {vol.name}: no supported source")

    def _mount_sa_token(self, pod: t.Pod) -> Optional[MountedVolume]:
        """Automount the ServiceAccount token (ref: serviceaccount admission
        plugin adds the token VolumeMount; here the volume manager does both
        halves node-side)."""
        sa_name = pod.spec.service_account_name or "default"
        ns = pod.metadata.namespace
        try:
            sa = self.cs.serviceaccounts.get(sa_name, ns)
        except NotFound:
            return None  # no SA machinery in this cluster (unit harnesses)
        except Forbidden:
            return None  # authz says this node may not read the SA: no automount
        if not sa.automount_service_account_token or not sa.secrets:
            return None
        try:
            sec = self.cs.secrets.get(sa.secrets[0].name, ns)
        except NotFound:
            return None
        token = sec.data.get("token", "")
        path = os.path.join(self._pod_dir(pod.metadata.uid), "satoken")
        _write_dir(path, {"token": token, "namespace": ns}, secret=True)
        return MountedVolume(SA_TOKEN_VOLUME, path, True, kind="satoken")

    # ------------------------------------------------------------- refresh

    def refresh_pod(self, pod: t.Pod):
        """Re-materialize configMap/secret/downwardAPI content if the
        refresh interval elapsed — mounted ConfigMap updates propagate to
        running pods (ref: the reference's configmap volume update)."""
        uid = pod.metadata.uid
        now = time.monotonic()
        with self._lock:
            if uid not in self._mounted:
                return
            if now - self._last_refresh.get(uid, 0.0) < self.REFRESH_INTERVAL:
                return
            self._last_refresh[uid] = now
        for vol in pod.spec.volumes:
            if vol.config_map is None and vol.secret is None and vol.downward_api is None:
                continue
            try:
                self._mount_volume(pod, vol)
            except (VolumeNotReady, VolumeError):
                pass  # keep serving the last-good content

    # ------------------------------------------------------------ teardown

    def teardown_pod(self, uid: str):
        """Delete pod-lifetime volume content (emptyDir, rendered
        configmap/secret/downward files).  hostPath and PV-backed data
        persists by design."""
        with self._lock:
            self._mounted.pop(uid, None)
            self._last_refresh.pop(uid, None)
        pod_root = os.path.join(self.root, "pods", uid)
        shutil.rmtree(pod_root, ignore_errors=True)

    def mounts_for_container(self, pod: t.Pod, container: t.Container) -> List[dict]:
        """Resolve container.volume_mounts against the pod's mounted volumes
        into the runtime mount dicts ({host_path, container_path, read_only}).
        The SA token mount is appended automatically."""
        with self._lock:
            mounted = dict(self._mounted.get(pod.metadata.uid, {}))
        out: List[dict] = []
        for vm in container.volume_mounts:
            mv = mounted.get(vm.name)
            if mv is None:
                raise VolumeError(
                    f"container {container.name}: volumeMount {vm.name!r} "
                    f"references no pod volume"
                )
            host = mv.host_path
            if vm.sub_path:
                sub = os.path.normpath(vm.sub_path)
                if sub.startswith("..") or os.path.isabs(sub):
                    raise VolumeError(f"volumeMount {vm.name}: invalid subPath {vm.sub_path!r}")
                host = os.path.join(host, sub)
                # a subPath may point at a rendered FILE (configmap key) —
                # only a missing subPath defaults to a directory
                if not os.path.exists(host):
                    os.makedirs(host, exist_ok=True)
            out.append({
                "name": vm.name,
                "host_path": host,
                "container_path": vm.mount_path,
                "read_only": vm.read_only or mv.read_only,
            })
        sa_mv = mounted.get(SA_TOKEN_VOLUME)
        if sa_mv is not None and not any(
            m["container_path"] == SA_TOKEN_MOUNT_PATH for m in out
        ):
            out.append({
                "name": SA_TOKEN_VOLUME,
                "host_path": sa_mv.host_path,
                "container_path": SA_TOKEN_MOUNT_PATH,
                "read_only": True,
            })
        return out

    # ---------------------------------------------------------- environment

    def make_environment(self, pod: t.Pod, container: t.Container) -> Dict[str, str]:
        """makeEnvironmentVariables (ref kubelet_pods.go:591): envFrom first
        (later sources win), then env, where explicit entries override
        envFrom and valueFrom resolves ConfigMap/Secret keys and downward
        fields."""
        ns = pod.metadata.namespace
        env: Dict[str, str] = {}
        for src in container.env_from:
            if src.config_map_ref is not None:
                try:
                    data = self.cs.configmaps.get(src.config_map_ref.name, ns).data
                except NotFound:
                    if src.config_map_ref.optional:
                        continue
                    raise VolumeNotReady(f"envFrom configmap {ns}/{src.config_map_ref.name} not found")
            elif src.secret_ref is not None:
                try:
                    data = self.cs.secrets.get(src.secret_ref.name, ns).data
                except NotFound:
                    if src.secret_ref.optional:
                        continue
                    raise VolumeNotReady(f"envFrom secret {ns}/{src.secret_ref.name} not found")
            else:
                continue
            for k, v in data.items():
                env[f"{src.prefix}{k}"] = str(v)
        for e in container.env:
            if e.value_from is None:
                env[e.name] = e.value
                continue
            vf = e.value_from
            if vf.config_map_key_ref is not None:
                ref = vf.config_map_key_ref
                try:
                    data = self.cs.configmaps.get(ref.name, ns).data
                except NotFound:
                    if ref.optional:
                        continue
                    raise VolumeNotReady(f"configmap {ns}/{ref.name} not found")
                if ref.key not in data:
                    if ref.optional:
                        continue
                    raise VolumeError(f"key {ref.key!r} not in configmap {ref.name}")
                env[e.name] = str(data[ref.key])
            elif vf.secret_key_ref is not None:
                ref = vf.secret_key_ref
                try:
                    data = self.cs.secrets.get(ref.name, ns).data
                except NotFound:
                    if ref.optional:
                        continue
                    raise VolumeNotReady(f"secret {ns}/{ref.name} not found")
                if ref.key not in data:
                    if ref.optional:
                        continue
                    raise VolumeError(f"key {ref.key!r} not in secret {ref.name}")
                env[e.name] = str(data[ref.key])
            elif vf.field_ref is not None:
                env[e.name] = resolve_field_ref(pod, vf.field_ref.field_path,
                                                self.node_name)
        return env


def resolve_field_ref(pod: t.Pod, field_path: str, node_name: str = "") -> str:
    """Downward-API field resolution (ref: pkg/fieldpath/fieldpath.go)."""
    simple = {
        "metadata.name": pod.metadata.name,
        "metadata.namespace": pod.metadata.namespace,
        "metadata.uid": pod.metadata.uid,
        "spec.nodeName": pod.spec.node_name or node_name,
        "spec.serviceAccountName": pod.spec.service_account_name,
        "status.podIP": pod.status.pod_ip,
        "status.hostIP": pod.status.host_ip or node_name,
    }
    if field_path in simple:
        return simple[field_path] or ""
    for prefix, mapping in (
        ("metadata.labels", pod.metadata.labels),
        ("metadata.annotations", pod.metadata.annotations),
    ):
        if field_path.startswith(prefix + "["):
            key = field_path[len(prefix) + 1:].rstrip("]").strip("'\"")
            return str(mapping.get(key, ""))
    return ""


def _select_items(data: Dict[str, str], items: List[t.KeyToPath]) -> Dict[str, str]:
    if not items:
        return {k: str(v) for k, v in data.items()}
    out = {}
    for kp in items:
        if kp.key in data:
            out[kp.path or kp.key] = str(data[kp.key])
    return out


def _write_dir(path: str, data: Dict[str, str], secret: bool = False):
    """Render {filename: content} into `path`, atomically per file, pruning
    files (including nested `items`-projected paths) whose keys are gone."""
    os.makedirs(path, exist_ok=True)
    if secret:
        os.chmod(path, 0o700)
    keep = set()
    for fname, content in data.items():
        safe = os.path.normpath(fname)
        if safe.startswith("..") or os.path.isabs(safe):
            continue  # a key must not escape the volume dir
        keep.add(safe)
        target = os.path.join(path, safe)
        os.makedirs(os.path.dirname(target), exist_ok=True)
        tmp = target + ".ktpu-tmp"
        with open(tmp, "w") as f:
            f.write(str(content))
        if secret:
            os.chmod(tmp, 0o600)
        os.replace(tmp, target)
    for dirpath, _dirs, files in os.walk(path):
        for fname in files:
            full = os.path.join(dirpath, fname)
            rel = os.path.relpath(full, path)
            if rel not in keep and not rel.endswith(".ktpu-tmp"):
                os.unlink(full)
