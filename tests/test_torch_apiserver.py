"""The port's apiserver (``kubernetes1_tpu_torch.apiserver.Master``) held to
the JAX package's ``Master``, over HTTP with plain urllib.

One script of requests goes to a JAX ``Master(port=0)`` and to the port's,
both in this process and both fresh, and every answer's status code and
body must be equal after the values that differ run to run are masked:
uids, timestamps, the server's created-at and bound-at stamps and the
commit stamps of lag-stamp bookmarks.  The script covers the routes the
port's cluster tests reach: create, get, list, watch, update, ``status``
and merge patch of every kind they use, delete of pods, jobs,
podcustommetrics and a namespace; label (set-based included) and
field selectors, the indexed ``spec.nodeName`` one too; ``limit`` and
``continue``; watches from a resourceVersion with progress and lag-stamp
bookmarks; the binding subresource, ``bindings:batch`` and
``delete:batch`` with their per-item results; eviction refused with 429
by a spent disruption budget; the pod log proxy; 400, 404, 409 and 422;
``/healthz``, ``/readyz``, ``/livez``; the request counts of ``/metrics``.
A second script compacts both stores and asks for a watch and a LIST
continuation from below the floor: 410 from both.

Three cases are the port's on purpose, and each is a test of its own that
the JAX ``Master`` does not pass: a container limit on ``nvidia.com/gpu``
is rewritten by ResourceV2 into the pod-level form (the JAX apiserver
refuses it), a ``google.com/tpu`` limit is refused (the JAX one rewrites
it), and a second binding of a bound pod to its own node is refused with
409 (the JAX one accepts it and overwrites the pod's cards).
"""

import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from kubernetes1_tpu.apiserver import Master as JaxMaster
from kubernetes1_tpu.apiserver import server as jax_server
from kubernetes1_tpu_torch.apiserver import Master
from kubernetes1_tpu_torch.apiserver import server as port_server

MASKED = "<masked>"
MASK_KEYS = {"uid", "creationTimestamp", "deletionTimestamp"}
MASK_ANNOTATIONS = {"slo.ktpu.io/created-at", "slo.ktpu.io/bound-at",
                    "obs.ktpu.io/committed-at"}
HEARTBEAT_S = 0.2  # the watch loops' idle tick, shortened for the test


def _mask(x):
    if isinstance(x, dict):
        out = {}
        for k, v in x.items():
            if k in MASK_KEYS:
                out[k] = MASKED
            elif k == "annotations" and isinstance(v, dict):
                out[k] = {a: MASKED if a in MASK_ANNOTATIONS else _mask(av)
                          for a, av in v.items()}
            else:
                out[k] = _mask(v)
        return out
    if isinstance(x, (list, tuple)):
        return [_mask(v) for v in x]
    return x


def _call(url, method, path, body=None, raw=False):
    """(status, decoded body): JSON, a watch's list of frames (None for a
    heartbeat line), or text."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            code, payload = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, payload = e.code, e.read()
    if raw:
        return code, payload.decode()
    if "watch=1" in path and code == 200:
        return code, [json.loads(line) if line.strip() else None
                      for line in payload.decode().split("\n")[:-1]]
    return code, json.loads(payload)


@pytest.fixture(autouse=True)
def _short_heartbeat(monkeypatch):
    monkeypatch.setattr(jax_server, "WATCH_HEARTBEAT_SECONDS", HEARTBEAT_S)
    monkeypatch.setattr(port_server, "WATCH_HEARTBEAT_SECONDS", HEARTBEAT_S)


class _KubeletLogs(BaseHTTPRequestHandler):
    """A kubelet's /containerLogs endpoint: echoes the path it was asked."""

    def do_GET(self):
        body = f"log of {self.path} with {self.headers.get('Authorization')}\n".encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


@pytest.fixture(scope="module")
def kubelet():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _KubeletLogs)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def _meta(name, ns="default", **kw):
    return {"name": name, "namespace": ns, **kw}


def _pod(name, labels, gpus=0, ns="default", **spec):
    pod_spec = {"containers": [{"name": "main", "image": "busybox",
                                "command": ["sleep", "1"]}], **spec}
    if gpus:
        pod_spec["extendedResources"] = [{"name": "gpu", "resource": "nvidia.com/gpu",
                                          "quantity": gpus}]
        pod_spec["containers"][0]["extendedResourceRequests"] = ["gpu"]
    return {"kind": "Pod", "apiVersion": "v1", "metadata": _meta(name, ns, labels=labels),
            "spec": pod_spec}


def _script(kubelet_url):
    """[(method, path, body)] of the parity script."""
    V1, BATCH, APPS = "/api/v1", "/apis/batch/v1", "/apis/apps/v1"
    D = f"{V1}/namespaces/default"
    node = {"kind": "Node", "apiVersion": "v1",
            "metadata": {"name": "n1", "labels": {"pool": "h100"},
                         "annotations": {"kubelet.ktpu.io/server": kubelet_url}},
            "status": {"capacity": {"cpu": "8", "pods": "10"},
                       "extendedResources": {"nvidia.com/gpu": [
                           {"id": "nv0-h0-gpu0", "health": "Healthy",
                            "attributes": {"nvidia.com/gpu/model": "H100"}}]}}}
    s = [
        ("GET", "/healthz", None), ("GET", "/readyz", None), ("GET", "/livez", None),
        ("GET", f"{V1}/namespaces", None),
        ("POST", f"{V1}/namespaces", {"kind": "Namespace", "apiVersion": "v1",
                                      "metadata": {"name": "team-a"}}),
        ("POST", f"{V1}/nodes", node),
        ("POST", f"{V1}/nodes", {**node, "metadata": {"name": "n2", "labels": {"pool": "a100"}}}),
        ("GET", f"{V1}/nodes/n1", None),
        ("GET", f"{V1}/nodes?labelSelector=pool%20in%20(h100,b200)", None),
        ("PUT", f"{V1}/nodes/n2/status", {**node, "metadata": {"name": "n2"},
                                          "status": {"capacity": {"cpu": "4"}}}),
        ("POST", f"{D}/pods", _pod("p1", {"app": "a"}, gpus=1)),
        ("POST", f"{D}/pods", _pod("p2", {"app": "b", "tier": "x"})),
        ("POST", f"{V1}/namespaces/team-a/pods", _pod("p3", {"app": "a"}, ns="team-a")),
        ("POST", f"{D}/pods", _pod("p1", {"app": "a"})),  # 409 AlreadyExists
        ("POST", f"{D}/pods", {"kind": "Pod", "metadata": {"name": "empty"},
                               "spec": {"containers": []}}),  # 422
        ("POST", f"{D}/pods", {"kind": "Node", "metadata": {"name": "wrong"}}),  # 400
        ("POST", f"{D}/pods", _pod("gang-0", {}, schedulingGang="g")),  # 422 no size
        ("GET", f"{D}/pods/p1", None),
        ("GET", f"{D}/pods/ghost", None),  # 404
        ("GET", f"{V1}/foos", None),  # 404 not registered
        ("GET", f"{V1}/pods?labelSelector=app%20in%20(a,b),!missing", None),
        ("GET", f"{D}/pods?labelSelector=tier", None),
        ("GET", f"{V1}/pods?fieldSelector=status.phase=Pending", None),
        ("GET", f"{D}/pods?fieldSelector=spec.nodeName=", None),
        ("POST", f"{D}/pods/p1/binding", {"kind": "Binding", "apiVersion": "v1",
                                          "metadata": _meta("p1"), "targetNode": "n1",
                                          "extendedResourceAssignments": {
                                              "gpu": ["nv0-h0-gpu0"]}}),
        ("POST", f"{D}/pods/p1/binding", {"kind": "Binding", "metadata": _meta("p1"),
                                          "targetNode": "n2"}),  # 409 bound elsewhere
        ("POST", f"{D}/pods/bindings:batch", {"items": [
            {"kind": "Binding", "metadata": _meta("p2"), "targetNode": "n2"},
            {"kind": "Binding", "metadata": _meta("ghost"), "targetNode": "n2"},
            {"kind": "Binding", "metadata": _meta("p1"), "targetNode": "n2"}]}),
        ("GET", f"{D}/pods/p1", None),
        ("GET", f"{V1}/pods?fieldSelector=spec.nodeName=n1", None),
        ("GET", f"{V1}/pods?fieldSelector=spec.nodeName!=n1,status.phase=Pending", None),
        ("GET", f"{D}/pods/p1/log?container=main&tailLines=5", None),
        ("PUT", f"{D}/pods/p1/status", {"kind": "Pod", "metadata": _meta("p1"),
                                        "status": {"phase": "Running"}}),
        ("PATCH", f"{D}/pods/p1", {"metadata": {"labels": {"patched": "yes"}}}),
        ("PATCH", f"{D}/pods/p2/status", {"status": {"phase": "Running"}}),
        ("PATCH", f"{D}/pods/p1", {"spec": {"nodeName": "n2"}}),  # 403 immutable
        ("GET", f"{D}/pods?limit=1", None),
        ("GET", f"{V1}/pods?limit=2&labelSelector=app", None),
        ("GET", f"{D}/pods?limit=-1", None),  # 400
        ("GET", f"{D}/pods?continue=garbage", None),  # 400
        ("POST", "/apis/policy/v1/namespaces/default/poddisruptionbudgets",
         {"kind": "PodDisruptionBudget", "apiVersion": "policy/v1", "metadata": _meta("pdb-a"),
          "spec": {"selector": {"matchLabels": {"app": "a"}}, "minAvailable": 1}}),
        ("PUT", "/apis/policy/v1/namespaces/default/poddisruptionbudgets/pdb-a/status",
         {"kind": "PodDisruptionBudget", "metadata": _meta("pdb-a"),
          "status": {"disruptionsAllowed": 0}}),
        ("POST", f"{D}/pods/p1/eviction", {"kind": "Eviction", "apiVersion": "policy/v1",
                                           "metadata": _meta("p1")}),  # 429
        ("POST", f"{D}/pods/p2/eviction", {"kind": "Eviction", "metadata": _meta("p2")}),
        ("GET", f"{D}/pods/p2", None),
        ("POST", f"{D}/pods/delete:batch", {"items": [
            {"name": "p2"}, {"name": "ghost"}, {"name": "p1", "resourceVersion": "999"},
            {"name": ""}]}),
        ("POST", f"{D}/pods/delete:batch", {"items": [{"name": "p3", "namespace": "team-a"}]}),
        ("DELETE", f"{V1}/namespaces/team-a/pods/p3?gracePeriodSeconds=0", None),
        ("DELETE", f"{D}/pods", None),  # 400 collection delete
    ]
    # the other kinds: create, get, list, update, status, patch
    kinds = [
        (f"{D}/events", {"kind": "Event", "apiVersion": "v1", "metadata": _meta("ev1"),
                         "involvedObject": {"kind": "Pod", "name": "p1"},
                         "reason": "Scheduled", "sourceComponent": "scheduler"}),
        (f"{BATCH}/namespaces/default/jobs",
         {"kind": "Job", "apiVersion": "batch/v1", "metadata": _meta("job1"),
          "spec": {"completions": 2, "completionMode": "Indexed",
                   "template": {"spec": {"containers": [{"name": "c", "image": "i"}]}}}}),
        (f"{BATCH}/namespaces/default/cronjobs",
         {"kind": "CronJob", "apiVersion": "batch/v1", "metadata": _meta("cron1"),
          "spec": {"schedule": "*/5 * * * *"}}),
        (f"{APPS}/namespaces/default/replicasets",
         {"kind": "ReplicaSet", "apiVersion": "apps/v1", "metadata": _meta("rs1"),
          "spec": {"selector": {"matchLabels": {"app": "r"}},
                   "template": {"metadata": {"labels": {"app": "r"}},
                                "spec": {"containers": [{"name": "c", "image": "i"}]}}}}),
        (f"{APPS}/namespaces/default/deployments",
         {"kind": "Deployment", "apiVersion": "apps/v1", "metadata": _meta("dep1"),
          "spec": {"replicas": 2, "selector": {"matchLabels": {"app": "d"}},
                   "template": {"metadata": {"labels": {"app": "d"}},
                                "spec": {"containers": [{"name": "c", "image": "i"}]}}}}),
        (f"{APPS}/namespaces/default/daemonsets",
         {"kind": "DaemonSet", "apiVersion": "apps/v1", "metadata": _meta("ds1"),
          "spec": {"selector": {"matchLabels": {"app": "ds"}}}}),
        (f"{APPS}/namespaces/default/statefulsets",
         {"kind": "StatefulSet", "apiVersion": "apps/v1", "metadata": _meta("ss1"),
          "spec": {"selector": {"matchLabels": {"app": "s"}},
                   "template": {"metadata": {"labels": {"app": "s"}}}}}),
        (f"{D}/services", {"kind": "Service", "apiVersion": "v1", "metadata": _meta("svc1"),
                           "spec": {"type": "NodePort", "ports": [{"port": 80}]}}),
        (f"{D}/endpoints", {"kind": "Endpoints", "apiVersion": "v1", "metadata": _meta("svc1"),
                            "subsets": [{"addresses": [{"ip": "10.0.0.1"}]}]}),
        (f"{D}/configmaps", {"kind": "ConfigMap", "apiVersion": "v1", "metadata": _meta("cm1"),
                             "data": {"k": "v"}}),
        (f"{D}/secrets", {"kind": "Secret", "apiVersion": "v1", "metadata": _meta("s1"),
                          "data": {"token": "t"}}),
        (f"{D}/serviceaccounts", {"kind": "ServiceAccount", "apiVersion": "v1",
                                  "metadata": _meta("sa1")}),
        (f"{D}/resourcequotas", {"kind": "ResourceQuota", "apiVersion": "v1",
                                 "metadata": _meta("rq1"), "spec": {"hard": {"pods": "20"}}}),
        (f"{V1}/persistentvolumes", {"kind": "PersistentVolume", "apiVersion": "v1",
                                     "metadata": {"name": "pv1"},
                                     "spec": {"capacity": {"storage": "1Gi"}}}),
        (f"{D}/persistentvolumeclaims", {"kind": "PersistentVolumeClaim", "apiVersion": "v1",
                                         "metadata": _meta("pvc1")}),
        ("/apis/storage.k8s.io/v1/storageclasses",
         {"kind": "StorageClass", "apiVersion": "storage.k8s.io/v1",
          "metadata": {"name": "sc1"}, "provisioner": "local"}),
        ("/apis/certificates/v1/certificatesigningrequests",
         {"kind": "CertificateSigningRequest", "apiVersion": "certificates/v1",
          "metadata": {"name": "csr1", "annotations": {"ktpu.io/created-by": "mallory"}},
          "spec": {"username": "system:node:n1"}}),
        ("/apis/autoscaling/v1/namespaces/default/horizontalpodautoscalers",
         {"kind": "HorizontalPodAutoscaler", "apiVersion": "autoscaling/v1",
          "metadata": _meta("hpa1"), "spec": {"maxReplicas": 3}}),
        ("/apis/scheduling/v1/priorityclasses",
         {"kind": "PriorityClass", "apiVersion": "scheduling/v1",
          "metadata": {"name": "high"}, "value": 1000}),
        ("/apis/metrics.k8s.io/v1/nodemetrics",
         {"kind": "NodeMetrics", "apiVersion": "metrics.k8s.io/v1", "metadata": {"name": "n1"},
          "usage": {"cpu": "1"}}),
        ("/apis/metrics.k8s.io/v1/namespaces/default/podmetrics",
         {"kind": "PodMetrics", "apiVersion": "metrics.k8s.io/v1", "metadata": _meta("p1"),
          "containers": [{"name": "main", "usage": {"cpu": "250m"}}]}),
        ("/apis/custom.metrics.k8s.io/v1/namespaces/default/podcustommetrics",
         {"kind": "PodCustomMetrics", "apiVersion": "custom.metrics.k8s.io/v1",
          "metadata": _meta("p1"), "samples": [{"name": "qps", "value": 3.5}]}),
    ]
    for coll, obj in kinds:
        one = f"{coll}/{obj['metadata']['name']}"
        s += [("POST", coll, obj), ("GET", one, None), ("GET", coll, None),
              ("PUT", one, {**obj, "metadata": {**obj["metadata"], "labels": {"v": "2"}}}),
              ("PUT", one + "/status", obj),
              ("PATCH", one, {"metadata": {"annotations": {"patched": "1"}}}),
              ("GET", one, None),
              ("GET", f"{coll}?watch=1&resourceVersion=1&timeoutSeconds=0.1", None)]
    s += [
        ("POST", f"{D}/pods", {**_pod("p4", {"app": "c"}), "spec": {
            "containers": [{"name": "main", "image": "i"}], "priorityClassName": "high"}}),
        ("POST", f"{D}/pods", {**_pod("p5", {}), "spec": {
            "containers": [{"name": "main", "image": "i"}], "priorityClassName": "nope"}}),
        ("POST", f"{BATCH}/namespaces/default/cronjobs",
         {"kind": "CronJob", "metadata": _meta("bad-cron"), "spec": {"schedule": "0 0 31 2 *"}}),
        ("DELETE", f"{BATCH}/namespaces/default/jobs/job1", None),
        ("DELETE", "/apis/custom.metrics.k8s.io/v1/namespaces/default/podcustommetrics/p1", None),
        ("GET", f"{BATCH}/namespaces/default/jobs/job1", None),
        ("DELETE", f"{V1}/namespaces/team-a", None),
        ("GET", f"{V1}/namespaces?fieldSelector=status.phase=Terminating", None),
        ("POST", f"{V1}/namespaces/team-a/configmaps",
         {"kind": "ConfigMap", "metadata": _meta("late", "team-a")}),  # 403 terminating
        # watches from a resourceVersion: the replay, then the idle tick
        ("GET", f"{D}/pods?watch=1&resourceVersion=3&timeoutSeconds=0.1", None),
        ("GET", f"{V1}/pods?watch=1&resourceVersion=10&timeoutSeconds=0.1"
                "&progressBookmarks=1&labelSelector=app", None),
        ("GET", f"{V1}/pods?watch=1&resourceVersion=1&timeoutSeconds=0.1"
                "&fieldSelector=spec.nodeName=n1&lagStamps=1", None),
        ("GET", f"{V1}/nodes?watch=1&resourceVersion=x", None),  # 400
        ("GET", f"{V1}/nodes?watch=1&resourceVersion=2&timeoutSeconds=0.1&lagStamps=1", None),
        ("GET", f"{V1}/namespaces?watch=1&resourceVersion=1&timeoutSeconds=0.1", None),
    ]
    return s


def _run(url, script):
    return [(m, p, *_call(url, m, p, b, raw=p.endswith("tailLines=5"))) for m, p, b in script]


def _request_counts(url):
    _, text = _call(url, "GET", "/metrics", raw=True)
    return sorted(line for line in text.splitlines()
                  if line.startswith("apiserver_request_total{"))


@pytest.fixture()
def masters():
    jm = JaxMaster(port=0, event_loop_serving=False).start()
    pm = Master(port=0).start()
    yield jm, pm
    pm.stop()
    jm.stop()


def test_the_request_script_answers_as_the_jax_apiserver(masters, kubelet):
    jm, pm = masters
    script = _script(kubelet)
    want, got = _run(jm.url, script), _run(pm.url, script)
    for w, g in zip(want, got):
        assert _mask(g) == _mask(w), f"{w[0]} {w[1]}"
    codes = {w[2] for w in want}
    assert {200, 201, 400, 403, 404, 409, 422, 429} <= codes
    assert _request_counts(pm.url) == _request_counts(jm.url)


def test_continue_and_watch_from_below_the_floor_are_410(kubelet):
    jm = JaxMaster(port=0, event_loop_serving=False, cacher_history_limit=4,
                   store_history_limit=4).start()
    pm = Master(port=0)
    pm.store.HISTORY_LIMIT = pm.cacher.HISTORY_LIMIT = 4  # the JAX Master's knobs, by hand
    pm.start()
    try:
        first = [_call(m.url, "GET", "/api/v1/namespaces/default/configmaps?limit=1")
                 for m in (jm, pm)]
        script = [("POST", "/api/v1/namespaces/default/configmaps",
                   {"kind": "ConfigMap", "metadata": _meta(f"cm{i}")}) for i in range(12)]
        script += [("GET", "/api/v1/namespaces/default/configmaps?limit=5", None)]
        want, got = _run(jm.url, script), _run(pm.url, script)
        assert [_mask(g) for g in got] == [_mask(w) for w in want]
        token = want[-1][3]["metadata"]["continue"]
        assert token == got[-1][3]["metadata"]["continue"]
        assert first[0] == first[1]
        tail = [("GET", f"/api/v1/namespaces/default/configmaps?limit=5&continue={token}", None),
                ("GET", "/api/v1/namespaces/default/configmaps?watch=1&resourceVersion=3", None),
                ("GET", "/api/v1/namespaces/default/configmaps?watch=1&resourceVersion=13"
                        "&timeoutSeconds=0.1", None)]
        # the token's revision is above the floor: it still pages; then the
        # store and the cache both compact past it
        want, got = _run(jm.url, tail[:1]), _run(pm.url, tail[:1])
        assert _mask(got) == _mask(want) and want[0][2] == 200
        for m in (jm, pm):
            m.store.compact(keep_last=1)
            _run(m.url, [("POST", "/api/v1/namespaces/default/configmaps",
                          {"kind": "ConfigMap", "metadata": _meta(f"cm-{i}")})
                         for i in range(6)])
        want, got = _run(jm.url, tail), _run(pm.url, tail)
        assert _mask(got) == _mask(want)
        assert [w[2] for w in want] == [410, 410, 410]
    finally:
        pm.stop()
        jm.stop()


# ------------------------------------------------- the port's three deviations


def _limited(name, resource):
    pod = _pod(name, {"app": "v1"})
    pod["spec"]["containers"][0]["resources"] = {"limits": {resource: 1, "cpu": "1"},
                                                 "requests": {resource: 1}}
    return pod


def test_a_gpu_container_limit_is_rewritten_by_resource_v2(masters):
    """The pre-v2 PodSpec runs: the limit becomes a uuid-named pod-level
    extended resource that the container requests, the raw limit and
    request go, and the pod tolerates the resource's taint.  The JAX
    apiserver refuses the same pod with 422."""
    jm, pm = masters
    path = "/api/v1/namespaces/default/pods"
    code, pod = _call(pm.url, "POST", path, _limited("old-form", "nvidia.com/gpu"))
    assert code == 201, pod
    (per,) = pod["spec"]["extendedResources"]
    assert per["resource"] == "nvidia.com/gpu" and per["quantity"] == 1
    assert len(per["name"]) == 36 and per["name"].count("-") == 4  # a uuid4
    c = pod["spec"]["containers"][0]
    assert c["extendedResourceRequests"] == [per["name"]]
    assert c["resources"] == {"limits": {"cpu": "1"}}
    assert {"key": "nvidia.com/gpu", "operator": "Exists"} in pod["spec"]["tolerations"]
    assert _call(pm.url, "GET", f"{path}/old-form")[1]["spec"] == pod["spec"]
    jcode, status = _call(jm.url, "POST", path, _limited("old-form", "nvidia.com/gpu"))
    assert (jcode, status["reason"]) == (422, "Invalid")
    assert "'nvidia.com/gpu' is not available on this cluster" in status["message"]


def test_a_tpu_container_limit_is_refused_naming_the_gpu_resource(masters):
    """The mirror of the JAX text: google.com/tpu has no card here.  The
    JAX apiserver rewrites the same pod into its pod-level form."""
    jm, pm = masters
    path = "/api/v1/namespaces/default/pods"
    code, status = _call(pm.url, "POST", path, _limited("tpu-form", "google.com/tpu"))
    assert (code, status["reason"]) == (422, "Invalid")
    assert status["message"] == ("resource 'google.com/tpu' is not available on this cluster; "
                                 "use 'nvidia.com/gpu' (GPU-native equivalent)")
    assert _call(pm.url, "GET", f"{path}/tpu-form")[0] == 404
    jcode, jpod = _call(jm.url, "POST", path, _limited("tpu-form", "google.com/tpu"))
    assert jcode == 201 and jpod["spec"]["extendedResources"][0]["resource"] == "google.com/tpu"


def test_a_second_binding_to_the_same_node_is_refused(masters):
    """A bound pod refuses every binding, to its own node too, and keeps
    its cards; the JAX apiserver accepts that rebinding and overwrites the
    pod's cards with the second binding's."""
    jm, pm = masters
    results = {}
    for which, m in (("jax", jm), ("port", pm)):
        path = "/api/v1/namespaces/default/pods"
        assert _call(m.url, "POST", path, _pod("bound", {}, gpus=1))[0] == 201

        def bind(card):
            return _call(m.url, "POST", f"{path}/bound/binding", {
                "kind": "Binding", "metadata": _meta("bound"), "targetNode": "n1",
                "extendedResourceAssignments": {"gpu": [card]}})

        assert bind("card-0")[0] == 201
        again = bind("card-1")
        batch = _call(m.url, "POST", f"{path}/bindings:batch", {"items": [
            {"kind": "Binding", "metadata": _meta("bound"), "targetNode": "n1",
             "extendedResourceAssignments": {"gpu": ["card-2"]}}]})[1]["results"][0]
        cards = _call(m.url, "GET", f"{path}/bound")[1]["spec"]["extendedResources"][0]
        results[which] = (again, batch, cards["assigned"])
    again, batch, cards = results["port"]
    assert again == (409, {"kind": "Status", "apiVersion": "v1", "status": "Failure",
                           "code": 409, "reason": "Conflict",
                           "message": "pod bound already bound to n1"})
    assert batch["code"] == 409 and cards == ["card-0"]
    jagain, jbatch, jcards = results["jax"]
    assert jagain[0] == 201 and jbatch["status"] == "Success" and jcards == ["card-2"]


# ------------------------------------------------ the types and the selectors

def _fields(cls, seen=None):
    """(name, wire name, default, nested fields) of a dataclass, recursively."""
    import dataclasses
    import typing

    seen = set() if seen is None else seen
    if cls in seen:
        return cls.__name__
    seen.add(cls)
    out = []
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        default = (f.default if f.default is not dataclasses.MISSING
                   else f.default_factory() if f.default_factory is not dataclasses.MISSING
                   else "MISSING")
        nested = [_fields(a, seen) for a in (typing.get_args(hints[f.name]) or
                                              (hints[f.name],))
                  if dataclasses.is_dataclass(a)]
        out.append((f.name, repr(default), nested))
    return out


def _registered():
    from kubernetes1_tpu_torch.machinery.scheme import global_scheme
    return sorted(global_scheme.by_resource.items())


@pytest.mark.parametrize("plural,cls", _registered(), ids=[p for p, _ in _registered()])
def test_each_registered_kind_is_the_jax_kind_field_for_field(plural, cls):
    """Every kind the port's apiserver serves has the JAX class's fields,
    defaults, nesting, kind, apiVersion, plural and namespaced flag, so
    both encode a body to the same wire dict."""
    from kubernetes1_tpu.api import types as jt
    from kubernetes1_tpu.machinery.scheme import global_scheme as jscheme
    from kubernetes1_tpu_torch.machinery.scheme import global_scheme as pscheme

    jcls = getattr(jt, cls.__name__)
    assert (cls.KIND, cls.API_VERSION) == (jcls.KIND, jcls.API_VERSION)
    assert jscheme.by_resource[plural] is jcls
    assert pscheme.namespaced[plural] == jscheme.namespaced[plural]
    assert _fields(cls) == _fields(jcls)


@pytest.mark.parametrize("selector", [
    "", "app=a", "app==a,tier!=x", "app in (a, b),!missing", "env notin (prod)",
    "tier", "a=b,c in (x,y),!d,e,f!=g", "bad key=1", "k in (a"])
def test_label_selectors_parse_and_match_as_the_jax_ones(selector):
    from kubernetes1_tpu.machinery import labels as jlabels
    from kubernetes1_tpu_torch.machinery import labels as plabels

    sets = [{}, {"app": "a"}, {"app": "b", "tier": "x"}, {"env": "prod", "tier": "y"},
            {"a": "b", "c": "y", "e": "1", "f": "h"}, {"missing": "1", "app": "a"}]
    try:
        want = jlabels.parse_selector(selector)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).replace("(", r"\(").replace(")", r"\)")):
            plabels.parse_selector(selector)
        return
    assert plabels.parse_selector(selector) == want
    assert [plabels.selector_matches(want, s) for s in sets] == \
        [jlabels.selector_matches(want, s) for s in sets]
