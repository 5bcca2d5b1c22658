"""The port's controller manager (``kubernetes1_tpu_torch/controllers``)
held to the JAX package's (``kubernetes1_tpu/controllers``) on the same
cluster states.

Each state is made from a seed with numpy as wire dicts: Jobs
(non-indexed, Indexed, gangs whole, with a failed or a vanished member,
over their backoffLimit, complete), ReplicaSets above, at and below their
count with adoptable orphans and finished pods, Deployments fresh and
mid-rollout under maxSurge/maxUnavailable as numbers and as percentages,
Services over Ready, not-Ready, terminating and finished pods,
dependents of a deleted (or re-created) owner, PodDisruptionBudgets,
terminated pods over the pod GC's threshold and pods on missing nodes,
finished Jobs past and within their TTL, namespaces with and without
their default ServiceAccount, Terminating namespaces, and nodes past
their monitor grace.  Each state
goes into a fresh in-process JAX ``Master`` for each package; the JAX
controller there, and the port's in the other, runs ``setup()``, its
informers sync, and one sync of each key the state names (the node
lifecycle controller one monitor pass).  The stored objects must then be
the same, masking only uids, resourceVersions, timestamps, the wall-clock
and trace annotations the apiserver stamps, and the random suffix of a
generated name: tolerance 0.

The deviations are cases of their own: an Indexed pod's rank stamps are
``gpu.ktpu.io/*`` in the port and ``tpu.ktpu.io/*`` in JAX (same values);
from a cache that has not seen its own creates, the JAX ReplicaSet
controller creates the pods again where the port's creates none; and at a
scale-down of Ready pods, the JAX controller deletes the oldest where the
port's deletes the newest.  Besides: ``template_hash``, the service
account token and the work queue against JAX's, and the process
``python -m kubernetes1_tpu_torch controller-manager`` serving /metrics
and /healthz and exiting 0 on SIGTERM.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from kubernetes1_tpu.apiserver import Master
from kubernetes1_tpu.client import Clientset as JaxClientset
from kubernetes1_tpu.client import InformerFactory as JaxInformerFactory
from kubernetes1_tpu.controllers import deployment as jdeployment
from kubernetes1_tpu.controllers import disruption as jdisruption
from kubernetes1_tpu.controllers import endpoints as jendpoints
from kubernetes1_tpu.controllers import job as jjob
from kubernetes1_tpu.controllers import namespace as jnamespace
from kubernetes1_tpu.controllers import nodelifecycle as jnodelifecycle
from kubernetes1_tpu.controllers import podgc as jpodgc
from kubernetes1_tpu.controllers import replicaset as jreplicaset
from kubernetes1_tpu.controllers import serviceaccount as jserviceaccount
from kubernetes1_tpu.controllers import ttl as jttl
from kubernetes1_tpu.machinery.scheme import from_dict as jax_from_dict
from kubernetes1_tpu.api import types as jt
from kubernetes1_tpu.utils import workqueue as jworkqueue
from kubernetes1_tpu_torch.api import types as tt
from kubernetes1_tpu_torch.client.clientset import Clientset as TorchClientset
from kubernetes1_tpu_torch.client.rest import Client
from kubernetes1_tpu_torch.controllers import deployment as tdeployment
from kubernetes1_tpu_torch.controllers import disruption as tdisruption
from kubernetes1_tpu_torch.controllers import endpoints as tendpoints
from kubernetes1_tpu_torch.controllers import job as tjob
from kubernetes1_tpu_torch.controllers import namespace as tnamespace
from kubernetes1_tpu_torch.controllers import nodelifecycle as tnodelifecycle
from kubernetes1_tpu_torch.controllers import podgc as tpodgc
from kubernetes1_tpu_torch.controllers import replicaset as treplicaset
from kubernetes1_tpu_torch.controllers import serviceaccount as tserviceaccount
from kubernetes1_tpu_torch.controllers import ttl as tttl
from kubernetes1_tpu_torch.machinery.scheme import from_dict as torch_from_dict
from kubernetes1_tpu_torch.utils import workqueue as tworkqueue

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_STATES = 10  # a controller
STAMP_KEYS = ("worker-id", "coordinator-address", "worker-hostnames")
# the plurals whose stored objects are compared
PLURALS = ("pods", "jobs", "replicasets", "deployments", "services", "endpoints",
           "poddisruptionbudgets", "nodes", "namespaces", "serviceaccounts", "secrets",
           "configmaps", "events")
MASKED_KEYS = {"uid", "resourceVersion", "creationTimestamp", "deletionTimestamp", "startTime",
               "completionTime", "lastTransitionTime", "lastHeartbeatTime", "firstTimestamp",
               "lastTimestamp"}
MASKED_ANNOTATIONS = {jt.TRACE_ID_ANNOTATION, jt.CREATED_AT_ANNOTATION,
                      jt.BOUND_AT_ANNOTATION, jt.SCHEDULED_AT_ANNOTATION}
SA_KEY = "parity-sa-key"

JAX = dict(job=jjob, replicaset=jreplicaset, deployment=jdeployment, endpoints=jendpoints,
           namespace=jnamespace, disruption=jdisruption, podgc=jpodgc, ttl=jttl,
           serviceaccount=jserviceaccount, nodelifecycle=jnodelifecycle)
TORCH = dict(job=tjob, replicaset=treplicaset, deployment=tdeployment, endpoints=tendpoints,
             namespace=tnamespace, disruption=tdisruption, podgc=tpodgc, ttl=tttl,
             serviceaccount=tserviceaccount, nodelifecycle=tnodelifecycle)


def iso(seconds_ago: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(time.time() - seconds_ago))


# ----------------------------------------------------------- the harness


class State:
    """A cluster state as wire dicts, written in order: each step is
    ``(plural, object, status)``, the object a dict or a function of (the
    uids written so far, the client) for what needs the store's answers
    (an owner's uid, a stored template's hash).  ``keys`` are the sync
    keys; ``opts`` the controller's constructor arguments."""

    def __init__(self, controller, seed):
        self.controller, self.seed = controller, seed
        self.steps, self.keys, self.opts = [], [], {}
        self.deletes = []  # (plural, namespace, name, grace) after the writes
        self.not_ready_for = {}  # node -> s, the node lifecycle's clock
        self.rounds = 1  # syncs of each key

    def add(self, plural, obj, status=None):
        self.steps.append((plural, obj, status))
        return obj

    def set_phase(self, namespace, phase):
        """A namespace's phase, written through its status."""
        self.steps.append(("namespaces", NsPhase(namespace, phase), None))

    def __repr__(self):
        return f"{self.controller}-{self.seed}"


def meta(name, ns="default", labels=None, annotations=None, owners=None):
    m = {"name": name}
    if ns:
        m["namespace"] = ns
    if labels:
        m["labels"] = dict(labels)
    if annotations:
        m["annotations"] = dict(annotations)
    if owners:
        m["ownerReferences"] = owners
    return {"metadata": m}


class NsPhase:
    """A step that sets a namespace's phase."""

    def __init__(self, name, phase):
        self.name, self.phase = name, phase


def write_state(client: Client, state: State) -> dict:
    """Write the state; {(plural, ns/name): uid}."""
    uids = {}
    for plural, obj, status in state.steps:
        rc = client.resource(plural)
        if isinstance(obj, NsPhase):
            ns = rc.get(obj.name)
            ns["status"] = {"phase": obj.phase}
            rc.update_status(ns)
            continue
        if callable(obj):
            obj = obj(uids, client)
        m = obj["metadata"]
        made = rc.create(obj, m.get("namespace", ""))
        key = f"{m.get('namespace', '')}/{m['name']}" if m.get("namespace") else m["name"]
        uids[(plural, key)] = made["metadata"]["uid"]
        if status is not None:
            made["status"] = status
            rc.update_status(made)
    for plural, ns, name, grace in state.deletes:
        client.resource(plural).delete(name, ns, grace)
    return uids


def _build(pkg, mods, cs, factory, state: State):
    mod = mods[state.controller]
    name, opts = state.controller, state.opts
    if name == "job":
        return mod.JobController(cs, factory)
    if name == "replicaset":
        return mod.ReplicaSetController(cs, factory)
    if name == "deployment":
        return mod.DeploymentController(cs, factory)
    if name == "endpoints":
        return mod.EndpointsController(cs, factory,
                                       coalesce_window=opts.get("coalesce_window", 0.0))
    if name == "namespace":
        return (mod.GarbageCollector if opts.get("gc") else mod.NamespaceController)(cs, factory)
    if name == "disruption":
        return mod.DisruptionController(cs, factory)
    if name == "podgc":
        if pkg == "jax":
            return mod.PodGCController(cs, factory, terminated_pod_threshold=opts["threshold"],
                                       quarantine=0.0)
        ctl = mod.PodGCController(cs, factory)
        ctl.TERMINATED_POD_THRESHOLD, ctl.QUARANTINE = opts["threshold"], 0.0
        return ctl
    if name == "ttl":
        return mod.TTLAfterFinishedController(cs, factory)
    if name == "serviceaccount":
        return mod.ServiceAccountController(cs, factory, signing_key=SA_KEY)
    return mod.NodeLifecycleController(cs, factory, monitor_grace=40.0,
                                       eviction_timeout=opts.get("eviction_timeout", 300.0))


def run(pkg: str, state: State, before_sync=None) -> dict:
    """The state in a fresh Master, one controller of ``pkg`` synced once
    per key; the stored objects, masked (``canon``)."""
    master = Master().start()
    client = Client(master.url)
    ctl = factory = cs = None
    try:
        uids = write_state(client, state)
        if pkg == "jax":
            cs = JaxClientset(master.url)
            factory = JaxInformerFactory(cs)
        else:
            cs = TorchClientset(master.url)
            factory = cs.informers()
        ctl = _build(pkg, JAX if pkg == "jax" else TORCH, cs, factory, state)
        if state.controller != "nodelifecycle":
            ctl.setup()
        factory.start_all()
        assert factory.wait_for_sync(15)
        if before_sync is not None:
            before_sync(ctl, factory, client)
        if state.controller == "nodelifecycle":
            now = time.time()
            for node, ago in state.not_ready_for.items():
                ctl._not_ready_since[node] = now - ago
            ctl._monitor()
        else:
            for _ in range(state.rounds):
                for key in state.keys:
                    ctl.sync(key)
        ctl.recorder.flush()
        return dump(client)
    finally:
        if ctl is not None:
            ctl.stop()
        if factory is not None:
            factory.stop_all()
        if cs is not None:
            cs.close()
        client.close()
        master.stop()


def dump(client: Client) -> dict:
    """{plural: [object]} of the store's objects of PLURALS."""
    return {plural: client.resource(plural).list()[0] for plural in PLURALS}


def canon(stored: dict, jax_stamps: bool = False) -> dict:
    """The stored objects with uids, resourceVersions, timestamps and the
    apiserver's wall-clock and trace annotations masked, generated names
    cut to their generateName, and (``jax_stamps``) the JAX controller's
    tpu.ktpu.io rank stamps under the port's gpu.ktpu.io keys; each
    plural's objects as sorted JSON strings."""
    uids, generated = set(), {}
    for objs in stored.values():
        for o in objs:
            m = o["metadata"]
            uids.add(m.get("uid", ""))
            gen = m.get("generateName")
            if gen and m["name"].startswith(gen) and m["name"] != gen:
                generated[m["name"]] = gen + "*"
    uids.discard("")
    # the HMAC token names its ServiceAccount's uid: checked, then masked
    out = {}

    def walk(v, key=None):
        if isinstance(v, dict):
            res = {}
            for k, x in v.items():
                if k in MASKED_KEYS:
                    res[k] = "<masked>"
                elif k == "annotations":
                    res[k] = {_stamp_key(a, jax_stamps): ("<masked>" if a in MASKED_ANNOTATIONS
                                                         else walk(b))
                              for a, b in x.items()}
                else:
                    res[k] = walk(x, k)
            return res
        if isinstance(v, list):
            return [walk(x) for x in v]
        if isinstance(v, str):
            for uid in uids:
                v = v.replace(uid, "<uid>")
            for name, masked in generated.items():
                v = v.replace(name, masked)
            return v
        return v

    for plural, objs in stored.items():
        rows = []
        for o in objs:
            o = json.loads(json.dumps(o))
            if plural == "secrets" and o.get("type") == jserviceaccount.TOKEN_SECRET_TYPE:
                o["data"]["token"] = _token_subject(o, stored)
            rows.append(json.dumps(walk(o), sort_keys=True))
        out[plural] = sorted(rows)
    return out


def _stamp_key(key: str, jax_stamps: bool) -> str:
    if jax_stamps and key.startswith("tpu.ktpu.io/") and key.split("/", 1)[1] in STAMP_KEYS:
        return "gpu.ktpu.io/" + key.split("/", 1)[1]
    return key


def _token_subject(secret: dict, stored: dict) -> str:
    """The token's subject once its HMAC and its ServiceAccount's uid check."""
    ns = secret["metadata"]["namespace"]
    sa_name = secret["metadata"]["name"][:-len("-token")]
    sa = next(s for s in stored["serviceaccounts"]
              if s["metadata"]["namespace"] == ns and s["metadata"]["name"] == sa_name)
    token = secret["data"]["token"]
    subject = jserviceaccount.verify_token(SA_KEY, token)
    assert subject["uid"] == sa["metadata"]["uid"], (subject, sa)
    assert token == tserviceaccount.sign_token(SA_KEY, ns, sa_name, sa["metadata"]["uid"])
    return f"<token of {subject['sub']}>"


def assert_same(state: State, jax_stamps: bool = False):
    got = canon(run("torch", state))
    want = canon(run("jax", state), jax_stamps=jax_stamps)
    for plural in PLURALS:
        assert got[plural] == want[plural], (plural, state)
    return got


# -------------------------------------------------------------- the states


def _pick(rng, seq):
    return seq[int(rng.integers(len(seq)))]


def container(rng, name="main"):
    c = {"name": name, "image": _pick(rng, ["ktpu/a", "ktpu/b"])}
    if rng.random() < 0.5:
        c["resources"] = {"requests": {"cpu": _pick(rng, ["100m", "250m", "1"])}}
    if rng.random() < 0.3:
        c["env"] = [{"name": "K", "value": str(int(rng.integers(100)))}]
    return c


def pod_template(rng, labels, restart=None):
    spec = {"containers": [container(rng)]}
    if restart:
        spec["restartPolicy"] = restart
    if rng.random() < 0.3:
        spec["nodeSelector"] = {"pool": _pick(rng, ["a", "b"])}
    return {"metadata": {"labels": dict(labels)}, "spec": spec}


def pod_status(rng, phase=None, ready=None, ip=None):
    phase = phase or _pick(rng, ["Pending", "Running", "Running", "Succeeded", "Failed"])
    st = {"phase": phase}
    if phase == "Running":
        ready = bool(rng.random() < 0.7) if ready is None else ready
        st["conditions"] = [{"type": "Ready", "status": "True" if ready else "False"}]
        st["podIP"] = ip or f"10.0.{int(rng.integers(255))}.{int(rng.integers(1, 255))}"
    if phase == "Failed":
        st["reason"] = _pick(rng, ["Evicted", "Error"])
    return st


def pod(name, labels=None, annotations=None, owners=None, node="", tmpl=None, ns="default"):
    obj = meta(name, ns, labels, annotations, owners)
    obj["spec"] = dict((tmpl or {}).get("spec") or {"containers": [{"name": "m", "image": "x"}]})
    if node:
        obj["spec"]["nodeName"] = node
    return obj


def owner(kind, name, plural, api_version, uids, ns="default", uid=None):
    return [{"apiVersion": api_version, "kind": kind, "name": name,
             "uid": uid or uids[(plural, f"{ns}/{name}")], "controller": True}]


def job_state(seed) -> State:
    rng = np.random.default_rng(1000 + seed)
    st = State("job", seed)
    name = f"train-{seed}"
    mode = ["plain", "plain-completions", "indexed", "gang-indexed", "gang-plain",
            "gang-failed", "gang-vanished", "gang-exhausted", "complete", "over-backoff"][seed % 10]
    indexed = mode in ("indexed", "gang-indexed", "gang-failed", "gang-vanished",
                       "gang-exhausted")
    gang = mode.startswith("gang")
    size = int(rng.integers(2, 5))
    spec = {"parallelism": size, "backoffLimit": int(rng.integers(0, 3)),
            "template": pod_template(rng, {"app": name}, restart="Never")}
    if indexed:
        spec["completionMode"] = "Indexed"
        spec["completions"] = size
    elif mode in ("plain-completions", "complete", "over-backoff"):
        spec["completions"] = size + int(rng.integers(0, 3))
    if gang:
        spec["gangScheduling"] = True
    if mode == "gang-exhausted":
        spec["backoffLimit"] = 0
    if mode == "gang-failed":
        spec["backoffLimit"] = 2
    annotations = {}
    attempt = 0
    if gang and rng.random() < 0.5 and mode != "gang-exhausted":
        attempt = 1
        annotations[jt.GANG_ATTEMPT_LABEL] = "1"
    st.add("jobs", {**meta(name, annotations=annotations), "spec": spec})
    labels = {"app": name, jt.JOB_NAME_LABEL: name}
    existing = {"plain": int(rng.integers(0, size)), "plain-completions": int(rng.integers(0, 3)),
                "indexed": int(rng.integers(0, size)), "gang-indexed": 0, "gang-plain": 0,
                "gang-failed": size, "gang-vanished": size - 1, "gang-exhausted": size,
                "complete": spec.get("completions", size),
                "over-backoff": spec["backoffLimit"] + 1}[mode]
    for i in range(existing):
        pl = dict(labels)
        ann = {}
        pname = f"{name}-{'x' if not indexed else ''}{i}"
        if indexed:
            ann[jt.COMPLETION_INDEX_ANNOTATION] = str(i)
        if gang:
            pl[jt.GANG_ATTEMPT_LABEL] = str(attempt)
        phase = None
        if mode in ("gang-failed", "gang-exhausted"):
            phase = "Failed" if i == 0 else "Running"
        elif mode == "gang-vanished":
            phase = "Running"
        elif mode == "complete":
            phase = "Succeeded"
        elif mode == "over-backoff":
            phase = "Failed"
        node = "node-a" if phase in ("Running", "Failed", "Succeeded") or rng.random() < 0.5 \
            else ""
        st.add("pods", pod(pname, pl, ann, node=node,
                           tmpl={"spec": {**spec["template"]["spec"]}}),
               pod_status(rng, phase))
    if gang and attempt == 1 and rng.random() < 0.5:
        # a straggler of the previous attempt
        pl = {**labels, jt.GANG_ATTEMPT_LABEL: "0"}
        st.add("pods", pod(f"{name}-old", pl, node="node-b"), pod_status(rng, "Running"))
    st.keys = [f"default/{name}"]
    return st


def replicaset_state(seed) -> State:
    rng = np.random.default_rng(2000 + seed)
    st = State("replicaset", seed)
    name = f"rs-{seed}"
    labels = {"app": name, "tier": _pick(rng, ["web", "db"])}
    have = int(rng.integers(0, 5))
    unscheduled = int(rng.integers(0, have + 1))
    kind = seed % 3  # 0: scale up, 1: scale down by the unscheduled, 2: to zero
    if kind == 0:
        want = have + 1 + int(rng.integers(0, 3))
    elif kind == 1:
        want = have - unscheduled
    else:
        want = 0
    st.add("replicasets", {**meta(name), "spec": {
        "replicas": want, "selector": {"matchLabels": labels},
        "template": pod_template(rng, labels)}})

    def owned(uids):
        return owner("ReplicaSet", name, "replicasets", "apps/v1", uids)


    for i in range(have):
        node = "" if i < unscheduled else _pick(rng, ["node-a", "node-b"])
        adopt = i >= unscheduled and rng.random() < 0.3
        phase = "Pending" if not node else "Running"
        st.add("pods", (lambda uids, _c, i=i, node=node, adopt=adopt: pod(
            f"{name}-p{i}", labels, owners=None if adopt else owned(uids), node=node)),
            pod_status(rng, phase))
    for i in range(int(rng.integers(0, 3))):  # finished pods count for nothing
        st.add("pods", (lambda uids, _c, i=i: pod(f"{name}-done{i}", labels, owners=owned(uids),
                                              node="node-a")),
               pod_status(rng, _pick(rng, ["Succeeded", "Failed"])))
    other = {"app": "other"}
    st.add("pods", pod(f"{name}-stranger", other, node="node-a"), pod_status(rng, "Running"))
    st.keys = [f"default/{name}"]
    return st


def deployment_state(seed) -> State:
    rng = np.random.default_rng(3000 + seed)
    st = State("deployment", seed)
    name = f"dep-{seed}"
    labels = {"app": name}
    replicas = int(rng.integers(1, 6))
    surge = _pick(rng, [0, 1, 2, "25%", "50%"])
    unavail = _pick(rng, [0, 1, "25%", "34%"])
    strategy = {"type": "Recreate"} if seed % 5 == 4 else {
        "type": "RollingUpdate", "rollingUpdate": {"maxSurge": surge, "maxUnavailable": unavail}}
    tmpl = pod_template(rng, labels)
    st.add("deployments", {**meta(name), "spec": {
        "replicas": replicas, "selector": {"matchLabels": labels}, "template": tmpl,
        "strategy": strategy, "revisionHistoryLimit": int(rng.integers(0, 3))}})
    stage = seed % 4  # 0: fresh; 1-3: old ReplicaSets, some with a new one

    def rs(uids, rname, rhash, n, revision):
        dep_uid = uids[("deployments", f"default/{name}")]
        lab = {**labels, jdeployment.HASH_LABEL: rhash}
        return {**meta(rname, labels=lab, annotations={
            jdeployment.REVISION_ANNOTATION: str(revision)}, owners=[{
                "apiVersion": "apps/v1", "kind": "Deployment", "name": name, "uid": dep_uid,
                "controller": True}]),
            "spec": {"replicas": n, "selector": {"matchLabels": lab},
                     "template": {"metadata": {"labels": lab}, "spec": tmpl["spec"]}}}

    if stage:
        for j in range(1 + (stage == 3)):
            n = int(rng.integers(0, replicas + 1))
            ready = int(rng.integers(0, n + 1))
            h = f"old{j}{seed}"
            st.add("replicasets", (lambda uids, _c, h=h, n=n, j=j: rs(
                uids, f"{name}-{h}", h, n, j + 1)),
                {"replicas": n, "readyReplicas": ready, "availableReplicas": ready})
    if stage >= 2:
        n = int(rng.integers(0, replicas + 1))
        ready = int(rng.integers(0, n + 1))

        def new_rs(uids, client, n=n):
            # the ReplicaSet of the Deployment's own template: its hash
            # read off the stored Deployment
            stored = client.deployments.get(name)["spec"]["template"]
            h = jdeployment.template_hash(jax_from_dict(jt.PodTemplateSpec, stored))
            return rs(uids, f"{name}-{h}", h, n, stage)
        st.add("replicasets", new_rs,
               {"replicas": n, "readyReplicas": ready, "availableReplicas": ready})
    st.keys = [f"default/{name}"]
    return st


def endpoints_state(seed) -> State:
    rng = np.random.default_rng(4000 + seed)
    st = State("endpoints", seed)
    name = f"svc-{seed}"
    labels = {"app": name}
    ports = [{"name": "http", "port": 80, "targetPort": int(rng.integers(8000, 9000))}]
    if rng.random() < 0.5:
        ports.append({"name": "metrics", "port": 9090, "protocol": "TCP"})
    selector = labels if seed % 5 else {}
    st.add("services", {**meta(name), "spec": {"selector": selector, "ports": ports}})
    if seed % 4 == 3:  # a stale Endpoints object to be rewritten
        st.add("endpoints", {**meta(name), "subsets": [{"addresses": [{"ip": "1.2.3.4"}]}]})
    for i in range(int(rng.integers(0, 6))):
        ready = bool(rng.random() < 0.6)
        phase = _pick(rng, ["Running", "Running", "Running", "Pending", "Succeeded"])
        st.add("pods", pod(f"{name}-p{i}", labels, node=_pick(rng, ["node-a", "node-b"])),
               pod_status(rng, phase, ready, ip=f"10.1.{seed}.{i + 1}"))
        if phase == "Running" and rng.random() < 0.2:
            st.deletes.append(("pods", "default", f"{name}-p{i}", 30))  # terminating
    st.add("pods", pod(f"{name}-other", {"app": "x"}, node="node-a"),
           pod_status(rng, "Running", True, ip="10.9.9.9"))
    st.keys = [f"default/{name}"]
    return st


def gc_state(seed) -> State:
    rng = np.random.default_rng(5000 + seed)
    st = State("namespace", seed)
    st.opts["gc"] = True
    job = f"owner-{seed}"
    st.add("jobs", {**meta(job), "spec": {"template": pod_template(rng, {"app": job},
                                                                     "Never")}})
    keys = []
    owners = {"live": lambda uids: owner("Job", job, "jobs", "batch/v1", uids),
              "gone": lambda uids: owner("Job", "deleted-job", "jobs", "batch/v1", uids,
                                         uid="0f0f0f0f-dead-beef-0000-000000000000"),
              "uid-changed": lambda uids: owner("Job", job, "jobs", "batch/v1", uids,
                                                uid="0f0f0f0f-dead-beef-0000-111111111111"),
              "rs-gone": lambda uids: owner("ReplicaSet", "gone-rs", "replicasets", "apps/v1",
                                            uids, uid="0f0f0f0f-dead-beef-0000-222222222222"),
              "unknown-kind": lambda uids: owner("Widget", "w", "widgets", "x/v1", uids,
                                                 uid="0f0f0f0f-dead-beef-0000-333333333333")}
    for i in range(int(rng.integers(2, 6))):
        which = _pick(rng, sorted(owners))
        plural = _pick(rng, ["pods", "configmaps", "secrets", "services"])
        oname = f"dep-{i}"

        def obj(uids, _c, which=which, plural=plural, oname=oname):
            o = meta(oname, labels={"owner": which}, owners=owners[which](uids))
            if plural == "pods":
                o["spec"] = {"containers": [{"name": "m", "image": "x"}]}
            elif plural == "services":
                o["spec"] = {"ports": [{"port": 80}]}
            elif plural == "configmaps":
                o["data"] = {"k": which}
            return o
        st.add(plural, obj)
        keys.append(f"{plural}|default/{oname}")
    st.keys = keys
    return st


def namespace_state(seed) -> State:
    rng = np.random.default_rng(6000 + seed)
    st = State("namespace", seed)
    ns = f"team-{seed}"
    st.add("namespaces", {"metadata": {"name": ns}})
    for i in range(int(rng.integers(0, 4))):
        plural = _pick(rng, ["pods", "configmaps", "services", "jobs", "secrets"])
        o = meta(f"{plural}-{i}", ns)
        if plural == "pods":
            o["spec"] = {"containers": [{"name": "m", "image": "x"}]}
        elif plural == "services":
            o["spec"] = {"ports": [{"port": 80}]}
        elif plural == "jobs":
            o["spec"] = {"template": pod_template(rng, {"app": "j"}, "Never")}
        st.add(plural, o)
    terminating = seed % 3 != 2
    st.set_phase(ns, "Terminating" if terminating else "Active")
    st.keys = [ns]
    return st


def disruption_state(seed) -> State:
    rng = np.random.default_rng(7000 + seed)
    st = State("disruption", seed)
    name = f"pdb-{seed}"
    labels = {"app": name}
    spec = {"selector": {"matchLabels": labels}}
    which = seed % 4
    if which == 0:
        spec["minAvailable"] = int(rng.integers(0, 4))
    elif which == 1:
        spec["maxUnavailable"] = int(rng.integers(0, 3))
    elif which == 3 and rng.random() < 0.5:
        spec = {}  # no selector: no status
    st.add("poddisruptionbudgets", {**meta(name), "spec": spec})
    for i in range(int(rng.integers(0, 6))):
        st.add("pods", pod(f"{name}-p{i}", labels, node="node-a"), pod_status(rng))
        if rng.random() < 0.15:
            st.deletes.append(("pods", "default", f"{name}-p{i}", 30))
    st.keys = [f"default/{name}"]
    return st


def podgc_state(seed) -> State:
    rng = np.random.default_rng(8000 + seed)
    st = State("podgc", seed)
    st.opts["threshold"] = int(rng.integers(0, 4))
    st.add("nodes", {"metadata": {"name": "node-live"}})
    for i in range(int(rng.integers(1, 8))):
        phase = _pick(rng, ["Succeeded", "Failed", "Running", "Pending"])
        node = _pick(rng, ["node-live", "node-gone", ""])
        owners = None
        if rng.random() < 0.25:
            owners = [{"apiVersion": "batch/v1", "kind": "Job", "name": "j",
                       "uid": "0f0f0f0f-dead-beef-0000-444444444444", "controller": True}]
        st.add("pods", pod(f"gc-{seed}-{i}", {"app": "gc"}, owners=owners, node=node),
               pod_status(rng, phase))
    st.keys = ["podgc/tick"]
    return st


def ttl_state(seed) -> State:
    rng = np.random.default_rng(9000 + seed)
    st = State("ttl", seed)
    for i in range(int(rng.integers(1, 4))):
        name = f"done-{seed}-{i}"
        spec = {"template": pod_template(rng, {"app": name}, "Never")}
        if rng.random() < 0.8:
            spec["ttlSecondsAfterFinished"] = _pick(rng, [0, 5, 3600, 86400])
        status = {}
        if rng.random() < 0.75:
            status = {"succeeded": 1, "conditions": [{
                "type": _pick(rng, ["Complete", "Failed"]), "status": "True",
                "lastTransitionTime": iso(_pick(rng, [10, 600, 7200, 200000]))}]}
        st.add("jobs", {**meta(name), "spec": spec}, status or None)
        st.keys.append(f"default/{name}")
    return st


def serviceaccount_state(seed) -> State:
    rng = np.random.default_rng(10000 + seed)
    st = State("serviceaccount", seed)
    ns = f"tenant-{seed}"
    st.add("namespaces", {"metadata": {"name": ns}})
    if rng.random() < 0.4:
        st.add("serviceaccounts", meta("default", ns))
    for i in range(int(rng.integers(0, 3))):
        st.add("serviceaccounts", meta(f"robot-{i}", ns))
    if seed % 5 == 4:
        st.set_phase(ns, "Terminating")
    st.keys = [ns]
    return st


def nodelifecycle_state(seed) -> State:
    rng = np.random.default_rng(11000 + seed)
    st = State("nodelifecycle", seed)
    for n in range(int(rng.integers(1, 4))):
        node = f"node-{seed}-{n}"
        kind = _pick(rng, ["fresh", "stale", "stale", "unknown", "tainted-fresh"])
        cond = {"type": "Ready", "status": "Unknown" if kind == "unknown" else "True",
                "lastHeartbeatTime": iso(5 if kind.endswith("fresh") else 500)}
        spec = {}
        if kind == "tainted-fresh":
            spec["taints"] = [{"key": tnodelifecycle.NodeLifecycleController.NOT_READY_TAINT,
                               "effect": "NoExecute"}]
        st.add("nodes", {"metadata": {"name": node}, "spec": spec},
               {"conditions": [cond]})
        if kind in ("stale", "unknown"):
            st.not_ready_for[node] = _pick(rng, [10, 1000])
        for i in range(int(rng.integers(0, 4))):
            p = pod(f"{node}-p{i}", {"app": "n"}, node=node)
            if rng.random() < 0.5:
                p["spec"]["tolerations"] = [{
                    "key": tnodelifecycle.NodeLifecycleController.NOT_READY_TAINT,
                    "operator": "Exists", "effect": "NoExecute",
                    **({"tolerationSeconds": _pick(rng, [5, 300])}
                       if rng.random() < 0.7 else {})}]
            st.add("pods", p, pod_status(rng, _pick(rng, ["Running", "Running", "Succeeded"])))
            if rng.random() < 0.2:
                st.deletes.append(("pods", "default", p["metadata"]["name"], 30))
    return st


MAKERS = {"job": job_state, "replicaset": replicaset_state,
            "deployment": deployment_state, "endpoints": endpoints_state, "gc": gc_state,
            "namespace": namespace_state, "disruption": disruption_state,
            "podgc": podgc_state, "ttl": ttl_state, "serviceaccount": serviceaccount_state,
            "nodelifecycle": nodelifecycle_state}
CASES = [(name, seed) for name in MAKERS for seed in range(N_STATES)]


@pytest.mark.parametrize("name,seed", CASES, ids=[f"{n}-{s}" for n, s in CASES])
def test_controller_matches_jax(name, seed):
    state = MAKERS[name](seed)
    got = assert_same(state, jax_stamps=name == "job")
    assert any(got[p] for p in PLURALS)


# ------------------------------------------------------------ deviations


def _pods(stored):
    return {p["metadata"]["name"]: p for p in stored["pods"]}


@pytest.mark.parametrize("seed", [2, 3, 12, 13])
def test_indexed_pods_carry_gpu_stamps_where_jax_writes_tpu_stamps(seed):
    """The same Indexed Job: the JAX controller stamps each pod's rank under
    tpu.ktpu.io, the port's under gpu.ktpu.io (the keys both GPU plugins
    read first), with the same values and no key of the other."""
    state = job_state(seed)
    got, want = _pods(run("torch", state)), _pods(run("jax", state))
    indexed = sorted(n for n, p in got.items()
                     if tt.COMPLETION_INDEX_ANNOTATION in p["metadata"].get("annotations", {}))
    assert indexed and indexed == sorted(
        n for n, p in want.items()
        if jt.COMPLETION_INDEX_ANNOTATION in p["metadata"].get("annotations", {}))
    job = state.keys[0].split("/")[1]
    for name in indexed:
        ours, theirs = got[name]["metadata"]["annotations"], want[name]["metadata"]["annotations"]
        if "gpu.ktpu.io/worker-id" not in ours:
            continue  # written by the state itself, not a controller
        assert not [k for k in ours if k.startswith("tpu.ktpu.io/")], ours
        assert not [k for k in theirs if k.startswith("gpu.ktpu.io/")], theirs
        for key in STAMP_KEYS:
            assert ours[f"gpu.ktpu.io/{key}"] == theirs[f"tpu.ktpu.io/{key}"]
        index = ours[tt.COMPLETION_INDEX_ANNOTATION]
        assert ours["gpu.ktpu.io/worker-id"] == index
        assert ours["gpu.ktpu.io/coordinator-address"] == f"{job}-0.default:{tjob.COORDINATOR_PORT}"
        assert tjob.COORDINATOR_PORT == jjob.COORDINATOR_PORT == 8476


def _stop_pods_informer(ctl, factory, _client):
    """The pods cache lags from here on: no event reaches it."""
    factory.informer("pods").stop()


CHURN = 3  # updates of each live pod in a coalescing window


def _churn(state: State, counter, absorbed: list):
    """A sync (no flush armed after it), then CHURN updates of each live
    pod and a pod no selector names; once the pods cache holds that pod,
    every earlier event has been handled, since one informer thread hands
    them out in order.  ``absorbed`` gets the coalesced events."""

    def hook(ctl, _factory, client):
        for key in state.keys:
            ctl.sync(key)
        base = counter.value
        for p in client.pods.list("default")[0]:
            if p["metadata"].get("deletionTimestamp"):
                continue
            for i in range(CHURN):
                p = client.pods.get(p["metadata"]["name"], "default")
                p["metadata"].setdefault("annotations", {})["churn"] = str(i)
                client.pods.update(p)
        sentinel = f"sentinel-{state.seed}"
        client.pods.create(pod(sentinel, {"role": "sentinel"}, node="node-a"), "default")
        _wait(lambda: ctl.pods.get(f"default/{sentinel}") is not None, 10)
        absorbed.append(counter.value - base)

    return hook


@pytest.mark.parametrize("seed", range(N_STATES))
def test_endpoints_coalescing_matches_jax(seed):
    """Both packages' EndpointsController with a coalescing window (longer
    than the test, so no delayed flush fires) absorb the same pod events
    into one armed flush per Service, and the sync after them writes the
    same Endpoints as each other."""
    st = endpoints_state(seed)
    st.opts["coalesce_window"] = 30.0
    ours, theirs = [], []
    got = canon(run("torch", st, before_sync=_churn(st, tendpoints.endpoints_coalesced_total,
                                                    ours)))
    want = canon(run("jax", st, before_sync=_churn(st, jendpoints.endpoints_coalesced_total,
                                                   theirs)))
    for plural in PLURALS:
        assert got[plural] == want[plural], (plural, st)
    assert ours == theirs
    live = sum(1 for plural, obj, _ in st.steps if plural == "pods"
               and obj["metadata"]["labels"] == {"app": f"svc-{seed}"}
               and ("pods", "default", obj["metadata"]["name"], 30) not in st.deletes)
    if seed % 5:  # the Service selects its pods: the first event arms, the rest ride it
        assert ours == [max(0, live * CHURN - 1)]


def test_replicaset_from_a_lagging_cache_jax_creates_again_the_port_does_not():
    """Two syncs of a ReplicaSet of 3 whose pods cache sees none of its own
    creates: the JAX controller creates 3 pods a sync (6); the port's, its
    creates not yet observed, creates none in the second."""
    st = State("replicaset", 0)
    labels = {"app": "lag"}
    st.add("replicasets", {**meta("lag"), "spec": {
        "replicas": 3, "selector": {"matchLabels": labels},
        "template": {"metadata": {"labels": labels},
                     "spec": {"containers": [{"name": "m", "image": "x"}]}}}})
    st.keys, st.rounds = ["default/lag"], 2
    ours = run("torch", st, before_sync=_stop_pods_informer)
    theirs = run("jax", st, before_sync=_stop_pods_informer)
    assert len(ours["pods"]) == 3
    assert len(theirs["pods"]) == 6
    st.rounds = 1  # one sync: the two agree
    assert canon(run("torch", st, before_sync=_stop_pods_informer))["pods"] == \
        canon(run("jax", st, before_sync=_stop_pods_informer))["pods"]


def _older_then_newer(uids, client, name):
    time.sleep(1.05)  # creationTimestamp has second resolution
    return pod(name, {"app": "order"}, owners=owner("ReplicaSet", "order", "replicasets",
                                                     "apps/v1", uids), node="node-a")


def test_replicaset_scale_down_jax_deletes_the_oldest_ready_pod_the_port_the_newest():
    """A ReplicaSet of 1 over two Ready, Running, scheduled pods made a
    second apart: the JAX controller deletes the older, the port's the
    newer (the reference's ActivePods: newest first); and over a Ready pod
    and a newer not-Ready one the port deletes the not-Ready."""
    labels = {"app": "order"}
    ready = {"phase": "Running", "conditions": [{"type": "Ready", "status": "True"}],
             "podIP": "10.2.0.1"}
    for second_ready, jax_deletes, port_deletes in ((True, "old", "new"),
                                                    (False, "old", "new")):
        st = State("replicaset", 1)
        st.add("replicasets", {**meta("order"), "spec": {
            "replicas": 1, "selector": {"matchLabels": labels},
            "template": {"metadata": {"labels": labels},
                         "spec": {"containers": [{"name": "m", "image": "x"}]}}}})
        st.add("pods", lambda uids, c: pod("old", labels, owners=owner(
            "ReplicaSet", "order", "replicasets", "apps/v1", uids), node="node-a"), ready)
        st.add("pods", lambda uids, c: _older_then_newer(uids, c, "new"),
               ready if second_ready else {**ready, "conditions": [
                   {"type": "Ready", "status": "False"}]})
        st.keys = ["default/order"]

        def deleted(stored):
            return sorted(p["metadata"]["name"] for p in stored["pods"]
                          if p["metadata"].get("deletionTimestamp"))
        assert deleted(run("jax", st)) == [jax_deletes]
        assert deleted(run("torch", st)) == [port_deletes]
    # the order itself, on typed pods
    mk = lambda name, ts, node, phase, ok: torch_from_dict(tt.Pod, {  # noqa: E731
        "metadata": {"name": name, "creationTimestamp": ts}, "spec": {"nodeName": node},
        "status": {"phase": phase, "conditions": [
            {"type": "Ready", "status": "True" if ok else "False"}]}})
    pods = [mk("ready-old", "2026-01-01T00:00:00Z", "n", "Running", True),
            mk("ready-new", "2026-01-01T00:00:09Z", "n", "Running", True),
            mk("notready", "2026-01-01T00:00:01Z", "n", "Running", False),
            mk("pending", "2026-01-01T00:00:02Z", "n", "Pending", False),
            mk("unscheduled", "2026-01-01T00:00:03Z", "", "Pending", False)]
    assert [p.metadata.name for p in treplicaset.scale_down_order(pods)] == [
        "unscheduled", "pending", "notready", "ready-new", "ready-old"]


def test_replicaset_expectations_are_met_by_the_caches_events_and_expire():
    exp = treplicaset.Expectations()
    exp.TIMEOUT = 0.2
    assert exp.satisfied("ns/rs")
    exp.expect("ns/rs", adds=2)
    exp.creation_observed("ns/rs")
    assert not exp.satisfied("ns/rs")
    exp.creation_observed("ns/rs")
    assert exp.satisfied("ns/rs")
    exp.expect("ns/rs", dels=["u1", "u2"])
    exp.deletion_observed("ns/rs", "u1")
    exp.deletion_observed("ns/rs", "u3")  # not one of ours
    assert not exp.satisfied("ns/rs")
    time.sleep(0.25)
    assert exp.satisfied("ns/rs")  # expired


# ----------------------------------------------------- helpers against JAX


def _template(rng):
    labels = {"app": f"a{int(rng.integers(5))}"}
    tmpl = pod_template(rng, labels, restart=_pick(rng, [None, "Always", "Never"]))
    if rng.random() < 0.5:
        tmpl["metadata"]["annotations"] = {"note": str(int(rng.integers(9)))}
    if rng.random() < 0.4:
        tmpl["spec"]["containers"].append(container(rng, "side"))
    if rng.random() < 0.3:
        tmpl["spec"]["tolerations"] = [{"key": "k", "operator": "Exists"}]
    return tmpl


@pytest.mark.parametrize("seed", range(8))
def test_template_hash_is_jaxs_bit_for_bit(seed):
    tmpl = _template(np.random.default_rng(12000 + seed))
    ours = tdeployment.template_hash(torch_from_dict(tt.PodTemplateSpec, tmpl))
    theirs = jdeployment.template_hash(jax_from_dict(jt.PodTemplateSpec, tmpl))
    assert ours == theirs and len(ours) == 10
    assert tdeployment.resolve_portion("25%", 7, True) == \
        jdeployment.resolve_portion("25%", 7, True) == 2


@pytest.mark.parametrize("seed", range(4))
def test_service_account_token_is_jaxs_byte_for_byte(seed):
    rng = np.random.default_rng(13000 + seed)
    key, ns, name = f"k{int(rng.integers(99))}", f"ns{seed}", _pick(rng, ["default", "robot"])
    uid = f"{int(rng.integers(1 << 30)):08x}-0000-4000-8000-000000000000"
    token = tserviceaccount.sign_token(key, ns, name, uid)
    assert token == jserviceaccount.sign_token(key, ns, name, uid)
    assert jserviceaccount.verify_token(key, token)["uid"] == uid
    assert jserviceaccount.verify_token(key + "x", token) is None


@pytest.mark.parametrize("mod", [tworkqueue, jworkqueue], ids=["port", "jax"])
def test_workqueue_dedups_requeues_and_backs_off(mod):
    q = mod.RateLimitingQueue(base_delay=0.01, max_delay=0.04)
    try:
        q.add("a")
        q.add("a")
        q.add("b")
        assert q.len() == 2
        item = q.get(timeout=1)
        assert item == "a"
        q.add("a")  # while processing: queued again on done()
        assert q.len() == 1
        q.done("a")
        assert [q.get(timeout=1), q.get(timeout=1)] == ["b", "a"]
        q.done("a")
        q.done("b")
        for _ in range(4):
            q.add_rate_limited("c")
        assert q.num_requeues("c") == 4
        t0 = time.monotonic()
        assert q.get(timeout=2) == "c" and time.monotonic() - t0 < 1.0
        q.forget("c")
        assert q.num_requeues("c") == 0
        q.add_after("d", 0.3)
        assert q.get(timeout=0.05) is None  # not due yet
        assert q.get(timeout=2) == "d"
        q.done("d")
    finally:
        q.shut_down()
    assert q.get(timeout=0.1) is None


# ------------------------------------------------------------ the process


def test_controller_manager_process_serves_metrics_and_exits_zero_on_sigterm(tmp_path):
    """``python -m kubernetes1_tpu_torch controller-manager`` against a JAX
    Master: it runs the loops (an Indexed Job's pods come with the
    gpu.ktpu.io stamps, a Deployment's ReplicaSet with JAX's hash), serves
    its families on /metrics and ok on /healthz, and exits 0 on SIGTERM."""
    master = Master().start()
    client = Client(master.url)
    log = tmp_path / "cm.log"
    out = open(log, "w")
    proc = subprocess.Popen([sys.executable, "-m", "kubernetes1_tpu_torch", "controller-manager",
                             "--server", master.url, "--metrics-port", "0",
                             "--node-monitor-grace", "5", "--endpoints-coalesce-ms", "0"],
                            cwd=REPO, stdout=out, stderr=subprocess.STDOUT)
    try:
        _wait(lambda: "controller manager running" in log.read_text() or proc.poll() is not None,
              30)
        text = log.read_text()
        assert proc.poll() is None, text
        url = text.split("controller manager metrics on ", 1)[1].split()[0]
        with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
            assert json.loads(r.read()) == {"status": "ok"}
        client.jobs.create({**meta("ranks"), "spec": {
            "completionMode": "Indexed", "completions": 2, "parallelism": 2,
            "gangScheduling": True, "template": {"spec": {
                "containers": [{"name": "m", "image": "x"}], "restartPolicy": "Never"}}}})
        tmpl = {"metadata": {"labels": {"app": "web"}},
                "spec": {"containers": [{"name": "m", "image": "x"}]}}
        client.deployments.create({**meta("web"), "spec": {
            "replicas": 2, "selector": {"matchLabels": {"app": "web"}}, "template": tmpl}})
        pods = _wait(lambda: [p for p in client.pods.list("default")[0]
                              if p["metadata"]["name"].startswith("ranks-")]
                     if len(client.pods.list("default")[0]) >= 4 else None, 30)
        for p in pods:
            ann = p["metadata"]["annotations"]
            assert ann["gpu.ktpu.io/coordinator-address"] == "ranks-0.default:8476"
            assert not [k for k in ann if k.startswith("tpu.ktpu.io/")]
        stored = client.deployments.get("web")["spec"]["template"]
        want = jdeployment.template_hash(jax_from_dict(jt.PodTemplateSpec, stored))
        rsets = client.resource("replicasets").list("default")[0]
        assert [r["metadata"]["name"] for r in rsets] == [f"web-{want}"]
        with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
            metrics = r.read().decode()
        for family in ("ktpu_gang_recovery_seconds", "ktpu_gang_attempts_total",
                       "ktpu_endpoints_writes_total", "ktpu_endpoints_coalesced_total",
                       "ktpu_endpoints_propagation_seconds", "ktpu_node_evictions_total",
                       "ktpu_nodelifecycle_errors_total",
                       "ktpu_node_not_ready_transitions_total"):
            assert f"# TYPE {family} " in metrics, family
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=15)
        out.close()
        client.close()
        master.stop()
    assert rc == 0, log.read_text()


def _wait(fn, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = fn()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout} s")
