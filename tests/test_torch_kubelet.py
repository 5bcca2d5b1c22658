"""The port's kubelet (``kubernetes1_tpu_torch/kubelet``, ``dns``) held to
the JAX package's (``kubernetes1_tpu/kubelet``, ``dns``).

Each of ``N_PODS`` pods is made from a seed with numpy as a wire dict:
cards assigned, healthy, missing from the node, unhealthy, vetoed by the
plugin or of a resource no plugin serves; env and envFrom from ConfigMaps
and Secrets (present, missing, optional) and the downward API; each
volume kind (emptyDir, hostPath, configMap, secret, downwardAPI, a bound
and an unbound PVC, a service-account token); probes of each action;
init containers; each restartPolicy with planned exits
(``KTPU_FAKE_EXIT_AFTER``/``_CODE``); privileged and unprivileged /dev
hostPaths; runAsNonRoot with and without a uid.  Each pod goes into a
fresh in-process JAX ``Master``.  The JAX ``Kubelet`` and then the port's
run against it, each on a ``FakeRuntime`` with the port's GPU plugin in
fake mode in a plugin dir of its own, eviction signals off, no server
and no loops started: the device manager streams the plugin's inventory,
the kubelet registers its node, and ``sync_pod`` runs ``N_SYNCS`` times
on the pod as the apiserver holds it.  The ``ContainerConfig``s each
runtime received, each status the kubelet PUT, the registered Node and
the Node after a heartbeat, the events and the runtime's container
records (and, for every fourth pod, what is left after a graceful delete
and one more sync) must be the same, masking
only uids, resourceVersions, timestamps and container and sandbox IDs:
tolerance 0.

The deviations are cases of their own: the raw-device guard names
``nvidia.com/gpu`` requests in the port where JAX names
``google.com/tpu`` (the seeded pods compare it with the port's text
mapped to JAX's); and a container config error (a missing ConfigMap
key, runAsNonRoot as uid 0) that JAX's kubelet writes as Failed, then
Pending, then Failed again, the port's writes as Failed once and then
leaves alone (the seeded pods that reach it compare the statuses up to
the first Failed).

Besides: the device manager against JAX's over the same plugin socket
(admit, init, a health flip, a dead endpoint); ``ClusterDNS.resolve``,
``resolv_conf`` and a UDP query against JAX's on the same Services;
``qos_class`` against JAX's; ``ProcessRuntime`` starting, logging and
stopping a container's every process on the CPU, and sparing a process
that took a reaped container's pid; the port's kubelet
with the process runtime serving a pod's log through the apiserver, its
/metrics, /debug/traces and the token; and the process ``python -m
kubernetes1_tpu_torch kubelet --runtime fake`` registering its node,
serving /healthz and exiting 0 on SIGTERM.
"""

import copy
import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from kubernetes1_tpu.api import types as jt
from kubernetes1_tpu.apiserver import Master
from kubernetes1_tpu.client import Clientset as JaxClientset
from kubernetes1_tpu.dns import server as jdns
from kubernetes1_tpu.kubelet import devicemanager as jdm
from kubernetes1_tpu.kubelet import eviction as jeviction
from kubernetes1_tpu.kubelet import runtime as jruntime
from kubernetes1_tpu.kubelet.kubelet import Kubelet as JaxKubelet
from kubernetes1_tpu.machinery.scheme import from_dict as jax_from_dict
from kubernetes1_tpu.machinery.scheme import to_dict as jax_to_dict
from kubernetes1_tpu.utils.waitutil import must_poll_until
from kubernetes1_tpu_torch import GPU_RESOURCE
from kubernetes1_tpu_torch.api import types as tt
from kubernetes1_tpu_torch.client.clientset import Clientset as TorchClientset
from kubernetes1_tpu_torch.client.rest import Client
from kubernetes1_tpu_torch.deviceplugin import api as tapi
from kubernetes1_tpu_torch.deviceplugin import gpu_plugin as gp
from kubernetes1_tpu_torch.dns import server as tdns
from kubernetes1_tpu_torch.kubelet import devicemanager as tdm
from kubernetes1_tpu_torch.kubelet import eviction as teviction
from kubernetes1_tpu_torch.kubelet import runtime as truntime
from kubernetes1_tpu_torch.kubelet.kubelet import Kubelet as TorchKubelet
from kubernetes1_tpu_torch.machinery.scheme import from_dict as torch_from_dict
from kubernetes1_tpu_torch.machinery.scheme import to_dict as torch_to_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA H100 80GB HBM3"
NODE = "kl-node"
SEED = 2100
N_PODS = 84
N_SYNCS = 5
CAPACITY = {"cpu": "16", "memory": "64Gi", "pods": "110"}
CARDS = [f"nv0-h0-gpu{i}" for i in range(4)]
UNHEALTHY = "nv0-h0-gpu3"  # the card the "unhealthy" pods' plugin reports dead
JAX_GUARD = "device access is granted via google.com/tpu requests, not raw /dev mounts"
PORT_GUARD = "device access is granted via nvidia.com/gpu requests, not raw /dev mounts"
TS_KEYS = {"creationTimestamp", "startTime", "startedAt", "finishedAt", "lastTransitionTime",
           "lastHeartbeatTime", "deletionTimestamp", "started_at", "finished_at"}
IDS = re.compile(r"\b(ctr|sbx)-[0-9a-f]{12}\b")


# --------------------------------------------------------------- the pods


class VetoPlugin(gp.GPUDevicePlugin):
    """The port's plugin, vetoing every pod whose name starts with "veto"."""

    def admit_pod(self, params):
        if params.get("pod_name", "").startswith("veto"):
            return {"allowed": False, "reason": "the plugin vetoes this pod"}
        return super().admit_pod(params)


def _exit_env(after, code):
    return [{"name": "KTPU_FAKE_EXIT_AFTER", "value": str(after)},
            {"name": "KTPU_FAKE_EXIT_CODE", "value": str(code)}]


def _probe(rng):
    action = ["exec", "http", "tcp"][rng.integers(3)]
    probe = {"initialDelaySeconds": 3600, "periodSeconds": 1}
    if action == "exec":
        probe["execAction"] = {"command": ["true"]}
    elif action == "http":
        probe["httpGet"] = {"path": "/healthz", "port": 1}
    else:
        probe["tcpSocket"] = {"port": 1}
    return probe


FAULTS = ["missing", "unhealthy", "veto", "unserved", "cmKeyMissing", "secretMissing",
          "pvcPending", "configMapMissing", "devUnprivileged", "runAsRoot", "initFails"]


def _volume(kind, i, tmp, privileged):
    vol = {"name": f"v-{kind.lower()}"}
    if kind == "emptyDir":
        vol["emptyDir"] = {}
    elif kind == "hostPath":
        vol["hostPath"] = {"path": os.path.join(tmp, "host", f"h{i}")}
    elif kind == "configMap":
        vol["configMap"] = {"name": "cm-a"}
    elif kind == "configMapItems":
        vol["configMap"] = {"name": "cm-a", "items": [{"key": "k2", "path": "sub/two"}]}
    elif kind == "configMapOptional":
        vol["configMap"] = {"name": "cm-nope", "optional": True}
    elif kind == "configMapMissing":
        vol["configMap"] = {"name": "cm-nope"}
    elif kind == "secret":
        vol["secret"] = {"secretName": "sec-a"}
    elif kind == "downward":
        vol["downwardAPI"] = {"items": [
            {"path": "name", "fieldRef": {"fieldPath": "metadata.name"}},
            {"path": "app", "fieldRef": {"fieldPath": "metadata.labels['app']"}}]}
    elif kind == "pvc":
        vol["persistentVolumeClaim"] = {"claimName": "claim-bound"}
    elif kind == "pvcPending":
        vol["persistentVolumeClaim"] = {"claimName": "claim-pending"}
    elif kind == "dev":
        vol["hostPath"] = {"path": ["/dev/null", "//dev/zero", "/tmp/../dev/null"][i % 3]}
    return vol


def make_case(i: int, tmp: str) -> dict:
    """Pod ``i``'s wire dict and its plugin's kind: every third pod
    carries one fault of ``FAULTS`` in turn, the rest none."""
    rng = np.random.default_rng(SEED + i)
    fault = FAULTS[(i // 3) % len(FAULTS)] if i % 3 == 0 else ""
    devices = fault if fault in ("missing", "unhealthy", "veto", "unserved") else \
        ["none", "healthy", "healthy"][rng.integers(3)]
    policy = ["Always", "OnFailure", "Never"][rng.integers(3)]
    name = f"{'veto' if devices == 'veto' else 'pod'}-{i}"
    spec = {"restartPolicy": policy, "nodeName": NODE, "containers": [], "volumes": []}
    if devices != "none":
        n = int(rng.integers(1, 3))
        if devices == "unserved":
            spec["extendedResources"] = [{"name": "fpga", "resource": "example.com/fpga",
                                          "quantity": 1, "assigned": ["fpga0"]}]
        else:
            ids = [str(x) for x in rng.choice(CARDS[:3], size=n, replace=False)]
            if devices == "missing":
                ids[-1] = "nv0-h0-gpu9"
            elif devices == "unhealthy":
                ids[-1] = UNHEALTHY
            spec["extendedResources"] = [{"name": "cards", "resource": GPU_RESOURCE,
                                          "quantity": n, "assigned": ids}]
    privileged = fault != "devUnprivileged" and bool(rng.integers(2))
    kinds = list(rng.choice(["emptyDir", "hostPath", "configMap", "configMapItems",
                             "configMapOptional", "secret", "downward", "pvc", "dev"],
                            size=int(rng.integers(0, 4)), replace=False))
    if fault in ("pvcPending", "configMapMissing"):
        kinds.append(fault)
    if fault == "devUnprivileged" and "dev" not in kinds:
        kinds.append("dev")
    elif not privileged and "dev" in kinds:
        kinds.remove("dev")
    mounts = []
    for kind in kinds:
        vol = _volume(kind, i, tmp, privileged)
        spec["volumes"].append(vol)
        mount = {"name": vol["name"], "mountPath": f"/mnt/{vol['name']}",
                 "readOnly": bool(rng.integers(2))}
        if kind == "emptyDir" and rng.integers(2):
            mount["subPath"] = "inner"
        mounts.append(mount)
    if rng.integers(4) == 0:
        spec["serviceAccountName"] = "trainer"
    for c in range(int(rng.integers(1, 3))):
        env = [{"name": "PLAIN", "value": f"v{c}"}]
        for ref in rng.choice(["cmKey", "cmKeyOptional", "secKey", "field", "label", "hostIP"],
                              size=int(rng.integers(0, 3)), replace=False):
            env.append({
                "cmKey": {"name": "FROM_CM", "valueFrom": {"configMapKeyRef": {
                    "name": "cm-a", "key": "k1"}}},
                "cmKeyOptional": {"name": "OPT", "valueFrom": {"configMapKeyRef": {
                    "name": "cm-nope", "key": "k", "optional": True}}},
                "secKey": {"name": "FROM_SEC", "valueFrom": {"secretKeyRef": {
                    "name": "sec-a", "key": "password"}}},
                "field": {"name": "POD", "valueFrom": {"fieldRef": {
                    "fieldPath": "metadata.name"}}},
                "label": {"name": "APP", "valueFrom": {"fieldRef": {
                    "fieldPath": "metadata.labels['app']"}}},
                "hostIP": {"name": "HOST", "valueFrom": {"fieldRef": {
                    "fieldPath": "status.hostIP"}}}}[str(ref)])
        env_from = [{"prefix": "CM_", "configMapRef": {"name": "cm-a"}},
                    {"secretRef": {"name": "sec-a"}},
                    {"configMapRef": {"name": "cm-nope", "optional": True}}][
            :int(rng.integers(0, 4))]
        if c == 0 and fault == "cmKeyMissing":
            env.append({"name": "NO_KEY", "valueFrom": {"configMapKeyRef": {
                "name": "cm-a", "key": "absent"}}})
        if c == 0 and fault == "secretMissing":
            env_from.append({"secretRef": {"name": "sec-nope"}})
        if rng.integers(2) == 0:
            env += _exit_env(0, int(rng.choice([0, 0, 1, 3])))
        container = {"name": f"c{c}", "image": f"ktpu/img{int(rng.integers(3))}",
                     "command": ["run", str(c)], "env": env, "envFrom": env_from,
                     "volumeMounts": list(mounts),
                     "imagePullPolicy": ["", "Always", "Never", "IfNotPresent"][
                         rng.integers(4)]}
        if rng.integers(3) == 0:
            container["readinessProbe"] = _probe(rng)
        if rng.integers(4) == 0:
            container["livenessProbe"] = _probe(rng)
        if "extendedResources" in spec and rng.integers(4):
            container["extendedResourceRequests"] = [spec["extendedResources"][0]["name"]]
        sc = {"privileged": True} if privileged else {}
        if c == 0 and fault == "runAsRoot":
            sc.update(runAsNonRoot=True, runAsUser=0)
        elif rng.integers(4) == 0:
            sc.update(runAsNonRoot=True, **({"runAsUser": 1000} if rng.integers(2) else {}))
        if sc:
            container["securityContext"] = sc
        spec["containers"].append(container)
    n_init = int(rng.integers(1, 3)) if rng.integers(3) == 0 or fault == "initFails" else 0
    for k in range(n_init):
        code = 2 if fault == "initFails" and k == n_init - 1 else 0
        spec.setdefault("initContainers", []).append({
            "name": f"init{k}", "image": "ktpu/init", "command": ["prep"],
            "env": _exit_env(0, code),
            "extendedResourceRequests": [spec["extendedResources"][0]["name"]]
            if "extendedResources" in spec and rng.integers(2) else []})
    pod = {"metadata": {"name": name, "namespace": "default",
                        "labels": {"app": f"a{i % 5}"},
                        "annotations": {"note": str(i)}},
           "spec": spec}
    return {"pod": pod, "devices": devices, "fault": fault, "delete": i % 4 == 1}


def _setup(cs, tmp):
    """The objects the pods read, in a fresh Master."""
    for d in (
        {"kind": jt.ConfigMap, "plural": "configmaps", "obj": {
            "metadata": {"name": "cm-a", "namespace": "default"},
            "data": {"k1": "one", "k2": "two"}}},
        {"kind": jt.Secret, "plural": "secrets", "obj": {
            "metadata": {"name": "sec-a", "namespace": "default"},
            "data": {"password": "hunter2", "user": "ops"}}},
        {"kind": jt.Secret, "plural": "secrets", "obj": {
            "metadata": {"name": "sec-sa", "namespace": "default"},
            "data": {"token": "sa-token"}}},
        {"kind": jt.ServiceAccount, "plural": "serviceaccounts", "obj": {
            "metadata": {"name": "trainer", "namespace": "default"},
            "secrets": [{"name": "sec-sa"}]}},
        {"kind": jt.PersistentVolume, "plural": "persistentvolumes", "obj": {
            "metadata": {"name": "pv-a"},
            "spec": {"capacity": {"storage": "1Gi"},
                     "hostPath": {"path": os.path.join(tmp, "pv-a")}}}},
        {"kind": jt.PersistentVolumeClaim, "plural": "persistentvolumeclaims", "obj": {
            "metadata": {"name": "claim-bound", "namespace": "default"},
            "spec": {"volumeName": "pv-a", "accessModes": ["ReadWriteOnce"]}}},
        {"kind": jt.PersistentVolumeClaim, "plural": "persistentvolumeclaims", "obj": {
            "metadata": {"name": "claim-pending", "namespace": "default"},
            "spec": {"accessModes": ["ReadWriteOnce"]}}},
    ):
        cs.resource(d["plural"]).create(jax_from_dict(d["kind"], d["obj"]))
    claim = cs.persistentvolumeclaims.get("claim-bound", "default")
    claim.status.phase = "Bound"
    cs.persistentvolumeclaims.update_status(claim)


# ------------------------------------------------------------- masking


def _mask(obj, uid: str = ""):
    """The wire form with uids, resourceVersions, timestamps and container
    and sandbox IDs masked (the pod's uid wherever it appears in a string,
    a volume's path among them)."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k in TS_KEYS and v:
                out[k] = "<ts>"
            elif k == "uid" and v:
                out[k] = "<uid>"
            elif k == "resourceVersion":
                out[k] = "<rv>"
            elif k == "containerId" and v:
                out[k] = "<cid>"
            elif k in ("annotations",) and isinstance(v, dict):
                out[k] = {a: ("<ts>" if a.startswith("slo.ktpu.io/") else _mask(b, uid))
                          for a, b in v.items()}
            else:
                out[k] = _mask(v, uid)
        return out
    if isinstance(obj, list):
        return [_mask(v, uid) for v in obj]
    if isinstance(obj, str):
        if uid:
            obj = obj.replace(uid, "<uid>")
        return IDS.sub(lambda m: f"<{m.group(1)}>", obj)
    return obj


# ------------------------------------------------------------- the sides


SIDES = {
    "jax": dict(kubelet=JaxKubelet, clientset=JaxClientset, runtime=jruntime.FakeRuntime,
                to_dict=jax_to_dict),
    "torch": dict(kubelet=TorchKubelet, clientset=TorchClientset,
                  runtime=truntime.FakeRuntime, to_dict=torch_to_dict),
}


def _settle(runtime, timeout=3.0):
    """Wait until every container with a planned exit has exited."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with runtime._lock:
            pending = [cid for cid in runtime._exit_plans
                       if (runtime._containers.get(cid) is not None
                           and runtime._containers[cid].state != "EXITED")]
        if not pending:
            return
        time.sleep(0.005)
    raise AssertionError(f"planned exits did not happen: {pending}")


def run_side(side: str, master, wire, case: dict, plugin_dir: str, volume_root: str) -> dict:
    """Everything the ``side`` kubelet did with the pod: the configs it
    created, the statuses it PUT, the node it registered and the node
    after a heartbeat, the events it recorded."""
    s = SIDES[side]
    devices = gp._fake_devices(f"{H100}:4:nv0:0")
    if case["devices"] == "unhealthy":
        next(d for d in devices if d["id"] == UNHEALTHY)["health"] = gp.DEVICE_UNHEALTHY
    impl = (VetoPlugin if case["devices"] == "veto" else gp.GPUDevicePlugin)(
        devices=devices, health_check_interval=0.1)
    server = tapi.PluginServer(impl, tapi.plugin_socket_path(plugin_dir, GPU_RESOURCE)).start()
    cs = s["clientset"](master.url)
    runtime = s["runtime"]()
    kl = s["kubelet"](cs, NODE, runtime, plugin_dir=plugin_dir, server_port=None,
                      volume_root=volume_root, eviction_signals_fn=lambda: {},
                      restart_backoff_base=0.0, capacity=dict(CAPACITY))
    out = {"configs": [], "statuses": [], "events": []}
    create = runtime.create_container

    def record_create(sandbox_id, config):
        out["configs"].append(dataclasses.asdict(config))
        return create(sandbox_id, config)

    runtime.create_container = record_create
    update_status = cs.pods.update_status

    def record_status(obj):
        out["statuses"].append(s["to_dict"](obj.status))
        return update_status(obj)

    cs.pods.update_status = record_status
    kl.recorder.event = lambda obj, etype, reason, message: out["events"].append(
        [etype, reason, message])
    try:
        kl.device_manager.start()
        must_poll_until(lambda: kl.device_manager.get_capacity().get(GPU_RESOURCE),
                        timeout=10.0, desc=f"{side}: the plugin's inventory")
        kl._register_node()
        out["node"] = wire.nodes.get(NODE, "")
        created = wire.pods.create(copy.deepcopy(case["pod"]))
        uid = created["metadata"]["uid"]
        name = case["pod"]["metadata"]["name"]
        for _ in range(N_SYNCS):
            kl.sync_pod(cs.pods.get(name, "default"))
            _settle(runtime)
        out["runtime"] = _records(runtime)
        kl._heartbeat()
        out["node_after"] = wire.nodes.get(NODE, "")
        if case["delete"]:  # a graceful delete: the kubelet stops the pod and deletes it for good
            wire.pods.delete(name, "default", grace_seconds=30)
            if any(p["metadata"]["name"] == name for p in wire.pods.list("default")[0]):
                kl.sync_pod(cs.pods.get(name, "default"))  # else a finished pod went at once
            out["after_delete"] = [_records(runtime), [p["metadata"]["name"] for p in
                                                       wire.pods.list("default")[0]]]
    finally:
        kl.prober.stop()
        kl.device_manager.stop()
        server.stop()
        cs.close()
    out = _mask(out, uid)
    if not case["delete"]:
        wire.pods.delete(case["pod"]["metadata"]["name"], "default", grace_seconds=0)
    wire.nodes.delete(NODE, "")
    return out


def _records(runtime):
    """The runtime's container records, in the order they were made."""
    return [dataclasses.asdict(c) for c in runtime.list_containers()]


def _port_guard_as_jax(obj):
    """The port's record with its raw-device guard text in JAX's words."""
    return json.loads(json.dumps(obj).replace(PORT_GUARD, JAX_GUARD))


@pytest.fixture()
def master(tmp_path):
    m = Master().start()
    cs = JaxClientset(m.url)
    wire = Client(m.url)
    _setup(cs, str(tmp_path))
    yield m, wire
    wire.close()
    cs.close()
    m.stop()


def _both(master, tmp_path, case):
    m, wire = master
    vroot = str(tmp_path / "vol")
    jax = run_side("jax", m, wire, case, str(tmp_path / "pj"), vroot)
    torch = run_side("torch", m, wire, case, str(tmp_path / "pt"), vroot)
    return jax, torch


# The seeded pods whose first container start meets a config error: JAX's
# kubelet flips them Failed -> Pending -> Failed, the port's writes Failed once.
FLIP_PODS = (27, 45, 78)


def _until_failed(statuses):
    """The statuses up to and with the first Failed one."""
    for k, st in enumerate(statuses):
        if st.get("phase") == "Failed":
            return statuses[:k + 1]
    return statuses


@pytest.mark.parametrize("i", range(N_PODS))
def test_kubelet_syncs_the_pod_as_jax_does(i, master, tmp_path):
    case = make_case(i, str(tmp_path))
    jax, torch = _both(master, tmp_path, case)
    for cfg in jax["configs"]:
        assert cfg.pop("cpuset") == []  # the JAX CPU manager's none policy; the port has no other
        assert cfg.pop("cgroup_procs_files") == []  # no JAX pod cgroup on a FakeRuntime; no port one
    torch = _port_guard_as_jax(torch)
    assert torch["configs"] == jax["configs"]
    if i in FLIP_PODS:  # the deviation: test_config_error_is_written_failed_once
        assert torch["statuses"] == _until_failed(jax["statuses"])
    else:
        assert torch["statuses"] == jax["statuses"]
    assert torch["events"] == jax["events"]
    assert torch["node"] == jax["node"]
    assert torch["node_after"] == jax["node_after"]
    assert torch["runtime"] == jax["runtime"]
    assert torch.get("after_delete") == jax.get("after_delete")


@pytest.mark.parametrize("i", FLIP_PODS)
def test_config_error_is_written_failed_once(i, master, tmp_path):
    """A missing ConfigMap key or runAsNonRoot as uid 0 at a container's
    first start: JAX's kubelet PUTs Failed, then the computed Pending over
    it, then Failed again (a watcher counting failures sees two); the
    port's PUTs Failed once and never Pending after it."""
    case = make_case(i, str(tmp_path))
    assert case["fault"] in ("cmKeyMissing", "runAsRoot")
    jax, torch = _both(master, tmp_path, case)
    phases = {side: [st.get("phase") for st in rec["statuses"]]
              for side, rec in (("jax", jax), ("torch", torch))}
    assert phases["jax"][:3] == ["Failed", None, "Failed"]  # Pending: no phase on the wire
    assert jax["statuses"][1]["containerStatuses"][0]["state"] == {
        "waiting": {"reason": "ContainerCreating"}}
    assert phases["torch"] == ["Failed"]
    assert torch["statuses"][0]["reason"] == "CreateContainerConfigError"
    assert _port_guard_as_jax(torch)["statuses"][0] == jax["statuses"][0]


def test_the_seeded_pods_cover_every_path():
    """What the N_PODS pods reach between them, on both kubelets alike."""
    cases = [make_case(i, "/tmp/x") for i in range(N_PODS)]
    assert {c["devices"] for c in cases} == {"none", "healthy", "missing", "unhealthy", "veto",
                                             "unserved"}
    assert {c["fault"] for c in cases} == set(FAULTS) | {""}
    assert sum(not c["fault"] for c in cases) >= N_PODS // 2
    specs = [c["pod"]["spec"] for c in cases]
    vols = {k for s in specs for v in s["volumes"] for k in v if k != "name"}
    assert vols == {"emptyDir", "hostPath", "configMap", "secret", "downwardAPI",
                    "persistentVolumeClaim"}
    assert {s["restartPolicy"] for s in specs} == {"Always", "OnFailure", "Never"}
    assert sum(bool(s.get("initContainers")) for s in specs) >= 10
    containers = [c for s in specs for c in s["containers"]]
    assert {a for c in containers for p in ("readinessProbe", "livenessProbe")
            if p in c for a in ("execAction", "httpGet", "tcpSocket") if a in c[p]} == {
        "execAction", "httpGet", "tcpSocket"}
    dev = [s for s in specs for v in s["volumes"] if "/dev/" in v.get("hostPath", {}).get(
        "path", "")]
    assert {bool((s["containers"][0].get("securityContext") or {}).get("privileged"))
            for s in dev} == {True, False}
    assert any(c.get("envFrom") for c in containers)
    assert {c["env"][-1]["value"] for c in containers
            if c["env"][-1]["name"] == "KTPU_FAKE_EXIT_CODE"} >= {"0", "1", "3"}


def test_raw_device_guard_names_the_ports_resource(master, tmp_path):
    """An unprivileged /dev hostPath fails the pod on both kubelets, with
    the resource each hands cards out by in its message."""
    pod = {"metadata": {"name": "rawdev", "namespace": "default"},
           "spec": {"nodeName": NODE, "restartPolicy": "Never",
                    "volumes": [{"name": "d", "hostPath": {"path": "/dev/null"}}],
                    "containers": [{"name": "main", "image": "x", "command": ["run"],
                                    "volumeMounts": [{"name": "d", "mountPath": "/d"}]}]}}
    jax, torch = _both(master, tmp_path, {"pod": pod, "devices": "none", "delete": False})
    head = "container main: hostPath '/dev/null' requires privileged: true ("
    failed = {side: [st for st in rec["statuses"] if st.get("phase") == "Failed"]
              for side, rec in (("jax", jax), ("torch", torch))}
    assert len(failed["jax"]) >= 1
    assert len(failed["torch"]) == 1  # written once: no Pending over it to write it again
    assert torch["statuses"][-1]["phase"] == "Failed"
    for side, guard in (("jax", JAX_GUARD), ("torch", PORT_GUARD)):
        assert {(st["reason"], st["message"]) for st in failed[side]} == {
            ("CreateContainerConfigError", head + guard + ")")}
    assert failed["jax"][0] == _port_guard_as_jax(failed["torch"][0])
    assert not jax["configs"] and not torch["configs"]


# ------------------------------------------------------- the device manager


def _admit_pod(side, name, ids, uid="u"):
    t_ = jt if side == "jax" else tt
    fd = jax_from_dict if side == "jax" else torch_from_dict
    return fd(t_.Pod, {"metadata": {"name": name, "namespace": "default", "uid": uid},
                       "spec": {"extendedResources": [{"name": "cards",
                                                       "resource": GPU_RESOURCE,
                                                       "quantity": len(ids),
                                                       "assigned": ids}],
                                "containers": [{"name": "main", "image": "x",
                                                "extendedResourceRequests": ["cards"]}]}})


def test_device_manager_admits_inits_and_watches_as_jax_does(tmp_path):
    plugin_dir = str(tmp_path / "p")
    impl = VetoPlugin(devices=gp._fake_devices(f"{H100}:4:nv0:0"), health_check_interval=0.1)
    server = tapi.PluginServer(impl, tapi.plugin_socket_path(plugin_dir, GPU_RESOURCE)).start()
    managers = {"jax": jdm.DeviceManager(plugin_dir), "torch": tdm.DeviceManager(plugin_dir)}
    lost = {side: [] for side in managers}
    for side, dm in managers.items():
        dm.on_device_unhealthy = lambda res, ids, s=side: lost[s].append((res, sorted(ids)))
        dm.start()
    try:
        for side, dm in managers.items():
            must_poll_until(lambda d=dm: d.get_capacity().get(GPU_RESOURCE), timeout=10.0,
                            desc=f"{side}: inventory")
        caps = {side: [jax_to_dict(d) if side == "jax" else torch_to_dict(d)
                       for d in dm.get_capacity()[GPU_RESOURCE]]
                for side, dm in managers.items()}
        assert caps["torch"] == caps["jax"] and len(caps["jax"]) == 4
        for name, ids in (("ok", ["nv0-h0-gpu0", "nv0-h0-gpu2"]), ("gone", ["nv0-h0-gpu7"]),
                          ("veto-me", ["nv0-h0-gpu1"])):
            got = {side: tuple(dm.admit_pod(_admit_pod(side, name, ids, uid=name)))
                   for side, dm in managers.items()}
            assert got["torch"] == got["jax"], name
            specs = {side: dm.init_container(p, p.spec.containers[0]).to_dict()
                     for side, dm in managers.items()
                     for p in [_admit_pod(side, name, ids, uid=name)]}
            assert specs["torch"] == specs["jax"], name
        assert managers["torch"].allocation_latency.count == 1 == \
            managers["jax"].allocation_latency.count
        impl.set_health("nv0-h0-gpu2", gp.DEVICE_UNHEALTHY)
        must_poll_until(lambda: all(lost.values()), timeout=10.0, desc="the health flip")
        assert lost["torch"] == lost["jax"] == [(GPU_RESOURCE, ["nv0-h0-gpu2"])]
        got = {side: tuple(dm.admit_pod(_admit_pod(side, "late", ["nv0-h0-gpu2"], uid="late")))
               for side, dm in managers.items()}
        assert got["torch"] == got["jax"] == (False, "assigned device nv0-h0-gpu2 unhealthy",
                                              False)
        server.stop()  # a dead endpoint: the socket goes, the store turns unhealthy

        def all_unhealthy(dm):
            return all(d.health == tt.DEVICE_UNHEALTHY
                       for d in dm.get_capacity().get(GPU_RESOURCE, []))

        for side, dm in managers.items():
            must_poll_until(lambda d=dm: all_unhealthy(d), timeout=10.0,
                            desc=f"{side}: the dead endpoint")
        assert lost["torch"] == lost["jax"]  # a restarting plugin fails no running pod
        got = {side: tuple(dm.admit_pod(_admit_pod(side, "after", ["nv0-h0-gpu0"],
                                                   uid="after")))
               for side, dm in managers.items()}
        assert got["torch"] == got["jax"]
    finally:
        for dm in managers.values():
            dm.stop()
        server.stop()


# ------------------------------------------------------------ cluster DNS


NAMES = ["web.default", "web.default.svc", "web.default.svc.cluster.local", "WEB.Default.",
         "gang.ml", "gang.ml.svc.cluster.local", "empty.ml", "nope.default",
         "nope.default.svc.cluster.local", "a.b.c.svc.cluster.local", "example.com",
         "one", "x.y.z", "cluster.local"]


def test_cluster_dns_answers_as_jax_does(tmp_path):
    m = Master().start()
    jcs, tcs = JaxClientset(m.url), TorchClientset(m.url)
    wire = Client(m.url)
    servers = {}
    try:
        for svc in ({"metadata": {"name": "web", "namespace": "default"},
                     "spec": {"clusterIp": "10.96.0.7", "ports": [{"port": 80}]}},
                    {"metadata": {"name": "gang", "namespace": "ml"},
                     "spec": {"clusterIp": "None", "ports": [{"port": 8476}]}},
                    {"metadata": {"name": "empty", "namespace": "ml"},
                     "spec": {"clusterIp": "None", "ports": [{"port": 1}]}}):
            wire.resource("services").create(svc)
        wire.resource("endpoints").create({
            "metadata": {"name": "gang", "namespace": "ml"},
            "subsets": [{"addresses": [{"ip": "10.1.0.1"}, {"ip": "10.1.0.2"}]}]})
        servers = {"jax": jdns.ClusterDNS(jcs, bind_ip="127.0.0.1", port=0, upstream=""),
                   "torch": tdns.ClusterDNS(tcs, bind_ip="127.0.0.1", port=0, upstream="")}
        for srv in servers.values():
            srv.start()
            assert srv.services.wait_for_sync() and srv.endpoints.wait_for_sync()
        must_poll_until(lambda: all(s.resolve("gang.ml") for s in servers.values()),
                        timeout=10.0, desc="the endpoints in both caches")
        for name in NAMES:
            assert servers["torch"].resolve(name) == servers["jax"].resolve(name), name
        assert servers["torch"].resolve("gang.ml") == ["10.1.0.1", "10.1.0.2"]
        for ns in ("default", "ml"):
            assert servers["torch"].resolv_conf(ns).replace(
                str(servers["torch"].ip), "IP") == servers["jax"].resolv_conf(ns).replace(
                str(servers["jax"].ip), "IP")
        import socket

        udp = {}
        for name, qtype in (("web.default.svc.cluster.local", 1), ("gang.ml", 255),
                            ("web.default", 28), ("nope.default.svc.cluster.local", 1),
                            ("example.com", 1)):  # no upstream: SERVFAIL, nothing sent out
            answers = {}
            for side, srv in servers.items():
                with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as q:
                    q.settimeout(5.0)
                    q.sendto(tdns.encode_query(name, qtype=qtype), (srv.ip, srv.port))
                    answers[side] = tdns.parse_response(q.recvfrom(4096)[0])
            assert answers["torch"] == answers["jax"], name
            udp[name] = answers["torch"]
        assert udp["web.default.svc.cluster.local"] == (0, ["10.96.0.7"])
        assert udp["gang.ml"] == (0, ["10.1.0.1", "10.1.0.2"])
        assert udp["web.default"] == (0, [])  # the name exists, no AAAA record
        assert udp["nope.default.svc.cluster.local"] == (3, [])  # NXDOMAIN
        assert udp["example.com"] == (2, [])  # SERVFAIL
    finally:
        for srv in servers.values():
            srv.stop()
        jcs.close()
        tcs.close()
        wire.close()
        m.stop()


# ------------------------------------------------------------------- QoS


def test_qos_class_as_jax():
    for i in range(N_PODS):
        wire = make_case(i, "/tmp/x")["pod"]
        rng = np.random.default_rng(SEED + 1000 + i)
        for c in wire["spec"]["containers"]:
            res = {}
            for kind in ("requests", "limits"):
                if rng.integers(2):
                    res[kind] = {"cpu": str(rng.choice(["1", "500m", "2"])),
                                 "memory": str(rng.choice(["1Gi", "512Mi"]))}
            c["resources"] = res
        assert teviction.qos_class(torch_from_dict(tt.Pod, wire)) == \
            jeviction.qos_class(jax_from_dict(jt.Pod, wire)), i


# --------------------------------------------------------- process runtime


def _alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def test_process_runtime_stops_every_process_of_a_container(tmp_path):
    """A container's leader, a child in its group and a child that left
    for a session of its own (as torchrun's workers do) all go at stop;
    the log holds what the container printed."""
    rt = truntime.ProcessRuntime(root_dir=str(tmp_path / "rt"))
    sb = rt.run_pod_sandbox("p", "default", "uid-1")
    cid = rt.create_container(sb, truntime.ContainerConfig(
        name="main", command=["sh", "-c", "echo started; sleep 300 & setsid sleep 301 & wait"],
        env={"GREETING": "hi"}))
    rt.start_container(cid)
    must_poll_until(lambda: len(truntime._container_pids(cid)) == 3,
                    timeout=10.0, desc="the container's three processes")
    pids = truntime._container_pids(cid)
    must_poll_until(lambda: "started" in rt.read_log(cid), timeout=10.0, desc="the log")
    assert rt.container_status(cid).state == truntime.CONTAINER_RUNNING
    assert rt.exec_in_container(cid, ["sh", "-c", 'test "$GREETING" = hi']) == 0
    rt.stop_container(cid, timeout=2.0)
    assert not [p for p in pids if _alive(p)]
    rec = rt.container_status(cid)
    assert rec.state == truntime.CONTAINER_EXITED and rec.exit_code == -signal.SIGTERM
    assert rt.read_log(cid, tail=1) == "started\n"
    cid2 = rt.create_container(sb, truntime.ContainerConfig(
        name="stubborn", command=["sh", "-c", "trap '' TERM; setsid sleep 302 & sleep 303"]))
    rt.start_container(cid2)
    must_poll_until(lambda: len(truntime._container_pids(cid2)) == 3,
                    timeout=10.0, desc="the second container's processes")
    pids2 = truntime._container_pids(cid2)
    assert rt.kill_all() == []
    assert not [p for p in pids2 if _alive(p)]


def test_process_runtime_spares_a_process_that_took_a_reaped_containers_pid(tmp_path):
    """Once a container's leader is reaped, the kernel may give its pid to
    any process: stopping, removing or killing the container must leave
    that process and its children alone."""
    rt = truntime.ProcessRuntime(root_dir=str(tmp_path / "rt"))
    sb = rt.run_pod_sandbox("p", "default", "uid-3")
    cid = rt.create_container(sb, truntime.ContainerConfig(name="done", command=["true"]))
    rt.start_container(cid)
    must_poll_until(lambda: rt.container_status(cid).state == truntime.CONTAINER_EXITED,
                    timeout=10.0, desc="the container's exit")
    other = subprocess.Popen(["sh", "-c", "sleep 300 & wait"], start_new_session=True)
    try:
        must_poll_until(lambda: len(_children(other.pid)) == 1, timeout=10.0,
                        desc="the other process's child")
        bystanders = [other.pid, *_children(other.pid)]
        rt._procs[cid].pid = other.pid  # the reaped leader's pid, now somebody else's
        rt.stop_container(cid, timeout=1.0)
        assert rt.kill_all() == []
        rt.remove_container(cid)
        assert [p for p in bystanders if _alive(p)] == bystanders
    finally:
        os.killpg(other.pid, signal.SIGKILL)
        other.wait()


def test_process_runtime_stops_a_leader_whose_environment_it_cannot_read(tmp_path, monkeypatch):
    """A leader that is still our unreaped child is stopped by its pid even
    when no process shows the container's mark (its environment may be
    unreadable, as a setuid program's is)."""
    rt = truntime.ProcessRuntime(root_dir=str(tmp_path / "rt"))
    sb = rt.run_pod_sandbox("p", "default", "uid-4")
    cid = rt.create_container(sb, truntime.ContainerConfig(name="main",
                                                           command=["sleep", "300"]))
    rt.start_container(cid)
    monkeypatch.setattr(truntime, "_container_pids", lambda container_id: set())
    rt.stop_container(cid, timeout=1.0)
    rec = rt.container_status(cid)
    assert rec.state == truntime.CONTAINER_EXITED and rec.exit_code == -signal.SIGTERM


def _children(pid):
    out = []
    for name in os.listdir("/proc"):
        if name.isdigit():
            try:
                with open(f"/proc/{name}/stat") as f:
                    if int(f.read().rsplit(")", 1)[1].split()[1]) == pid:
                        out.append(int(name))
            except (OSError, IndexError, ValueError):
                continue
    return out


def test_process_runtime_exports_volumes_and_runs_the_command_as_given(tmp_path):
    rt = truntime.ProcessRuntime(root_dir=str(tmp_path / "rt"))
    sb = rt.run_pod_sandbox("p", "default", "uid-2")
    cid = rt.create_container(sb, truntime.ContainerConfig(
        name="main", command=[sys.executable, "-c"],
        args=["import os; print(os.environ['KTPU_VOLUME_CKPT_DIR'], os.getcwd())"],
        working_dir=str(tmp_path),
        mounts=[{"name": "ckpt-dir", "host_path": "/data/ckpt", "container_path": "/ckpt"}]))
    rt.start_container(cid)
    must_poll_until(lambda: rt.container_status(cid).state == truntime.CONTAINER_EXITED,
                    timeout=20.0, desc="the container's exit")
    assert rt.container_status(cid).exit_code == 0
    assert rt.read_log(cid) == f"/data/ckpt {tmp_path}\n"
    with pytest.raises(ValueError, match="command required"):
        rt.start_container(rt.create_container(sb, truntime.ContainerConfig(name="empty")))


# ------------------------------------------- the port's kubelet, end to end


def _get(url, token=""):
    req = urllib.request.Request(url, headers={"Authorization": f"Bearer {token}"}
                                 if token else {})
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status, r.read().decode()


def test_port_kubelet_serves_a_pods_log_through_the_apiserver(tmp_path):
    """The process runtime, the port's plugin in fake mode and the JAX
    apiserver's log proxy: a pod asking for a card gets it injected, and
    what it printed comes back through the apiserver, the kubelet's token
    and /containerLogs.  /metrics counts the allocation; /debug/traces
    holds the pod's device-allocation span; workload paths want the token."""
    m = Master().start()
    wire = Client(m.url)
    plugin_dir = str(tmp_path / "p")
    impl = gp.GPUDevicePlugin(devices=gp._fake_devices(f"{H100}:2:nv0:0"))
    server = tapi.PluginServer(impl, tapi.plugin_socket_path(plugin_dir, GPU_RESOURCE)).start()
    cs = TorchClientset(m.url)
    runtime = truntime.ProcessRuntime(root_dir=str(tmp_path / "rt"))
    kl = TorchKubelet(cs, NODE, runtime, plugin_dir=plugin_dir, heartbeat_interval=0.5,
                      sync_interval=0.3, pleg_interval=0.3, eviction_signals_fn=lambda: {},
                      capacity=dict(CAPACITY))
    try:
        kl.start()
        must_poll_until(lambda: (wire.nodes.get(NODE, "").get("status") or {}).get(
            "extendedResources"), timeout=20.0, desc="the node's cards")
        wire.pods.create({"metadata": {"name": "talker", "namespace": "default"}, "spec": {
            "nodeName": NODE, "restartPolicy": "Never",
            "extendedResources": [{"name": "g", "resource": GPU_RESOURCE, "quantity": 1,
                                   "assigned": ["nv0-h0-gpu1"]}],
            "containers": [{"name": "main", "image": "x", "extendedResourceRequests": ["g"],
                            "command": [sys.executable, "-c",
                                        "import os; print('talker says', "
                                        "os.environ['CUDA_VISIBLE_DEVICES'], "
                                        "os.environ['KTPU_APISERVER'])"]}]}})
        must_poll_until(lambda: (wire.pods.get("talker").get("status") or {}).get("phase")
                        == "Succeeded", timeout=30.0, desc="the pod's end")
        assert wire.pod_log("talker") == f"talker says 1 {m.url}\n"
        node = wire.nodes.get(NODE, "")
        url = node["metadata"]["annotations"]["kubelet.ktpu.io/server"]
        assert url == kl.server.url
        token = wire.resource("secrets").get(f"kubelet-token-{NODE}", "kube-system")["data"][
            "token"]
        assert token == kl.server_token
        assert _get(url + "/healthz") == (200, '{"status": "ok"}')
        assert _get(url + "/readyz")[0] == 200
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(url + "/pods")
        assert e.value.code == 401
        e.value.close()
        assert json.loads(_get(url + "/pods", token)[1]) == {"pods": ["default/talker"]}
        metrics = _get(url + "/metrics")[1]
        assert "kubelet_running_pods 1\n" in metrics
        assert "ktpu_device_plugin_allocation_seconds_count 1\n" in metrics
        trace = json.loads(_get(url + "/debug/traces", token)[1])
        assert "kubelet.device_allocation" in {s["name"] for s in trace["spans"]}
        summary = json.loads(_get(url + "/stats/summary", token)[1])
        assert summary["node"]["nodeName"] == NODE and summary["pods"][0]["pod"] == \
            "default/talker"
        assert _get(url + "/containerLogs/default/talker/main?tail=1", token)[1] == \
            f"talker says 1 {m.url}\n"
        wire.pods.delete("talker")
        must_poll_until(lambda: not wire.pods.list("default")[0], timeout=20.0,
                        desc="the kubelet's final delete")
    finally:
        kl.stop()
        runtime.kill_all()
        server.stop()
        cs.close()
        wire.close()
        m.stop()


def test_kubelet_process_registers_serves_healthz_and_exits_0_on_sigterm(tmp_path):
    m = Master().start()
    wire = Client(m.url)
    log = tmp_path / "kubelet.log"
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "kubernetes1_tpu_torch", "kubelet", "--server", m.url,
             "--node-name", "proc-node", "--runtime", "fake", "--plugin-dir",
             str(tmp_path / "p"), "--root-dir", str(tmp_path / "r")],
            cwd=REPO, stdout=out, stderr=subprocess.STDOUT)
    try:
        must_poll_until(lambda: proc.poll() is not None or
                        "kubelet proc-node running (fake runtime)" in log.read_text(),
                        timeout=30.0, desc="the kubelet's running line")
        assert proc.poll() is None, log.read_text()
        text = log.read_text()
        assert "kubelet proc-node: no cluster DNS (hollow runtime)" in text
        node = wire.nodes.get("proc-node", "")
        url = node["metadata"]["annotations"]["kubelet.ktpu.io/server"]
        assert f"kubelet proc-node server on {url}" in text
        assert node["status"]["nodeInfo"]["containerRuntimeVersion"] == "fake://0.1"
        assert _get(url + "/healthz") == (200, '{"status": "ok"}')
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=15)
        wire.close()
        m.stop()
    assert code == 0, log.read_text()
