"""The port's CLI (``kubernetes1_tpu_torch/cli``) against the JAX one.

Two hollow clusters side by side: ``jax`` is the JAX CLI on a JAX
``LocalCluster(nodes=2, tpus_per_node=4, hollow=True)``, ``torch`` the
port's CLI on the port's ``LocalCluster(nodes=2, gpus_per_node=4,
hollow=True)``.  Every scenario of ``tests/test_cli.py`` runs on both.  A
seeded script of CLI invocations, the same argv list on both, must give
the same stdout, stderr and exit code at tolerance 0 after masking uids,
resourceVersions, ages and timestamps, ports, and the TPU seam
(``google.com/tpu`` and the TPU column words against ``nvidia.com/gpu``
and GPU; column padding follows the masked widths).  The deviations are
cases of their own that assert both answers: ``top`` and the printers
count only their own package's cards, ``version``, ``api-resources``
(the port's scheme lacks item 18's kinds) and ``cluster-up``'s flags.
The process cases run ``python -m kubernetes1_tpu_torch ktpu cluster-up``
and stop it with SIGINT.
"""

import io
import json
import os
import random
import re
import signal
import socket
import subprocess
import sys
import time

import pytest
import yaml

import kubernetes1_tpu.cli as jcli
import kubernetes1_tpu_torch.cli as tcli
from kubernetes1_tpu.localcluster import LocalCluster as JaxLocalCluster
from kubernetes1_tpu.machinery import ApiError as JaxApiError
from kubernetes1_tpu_torch.localcluster import LocalCluster
from kubernetes1_tpu_torch.machinery.errors import ApiError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": (jcli, JaxApiError), "torch": (tcli, ApiError)}
FLAVORS = ("jax", "torch")
WAIT_S = 60.0


@pytest.fixture(scope="module")
def clusters():
    """Both hollow clusters, their kubelets reading no eviction signals."""
    from kubernetes1_tpu.kubelet import eviction
    from kubernetes1_tpu_torch.kubelet import kubelet as tkubelet

    mp = pytest.MonkeyPatch()
    mp.setattr(eviction, "default_signals", lambda: {})
    mp.setattr(tkubelet, "default_signals", lambda: {})
    made = {}
    try:
        made["jax"] = JaxLocalCluster(nodes=2, tpus_per_node=4, hollow=True).start().wait_ready()
        made["torch"] = LocalCluster(nodes=2, gpus_per_node=4, hollow=True).start().wait_ready()
        yield made
    finally:
        for c in made.values():
            c.stop()
        mp.undo()


def invoke(flavor: str, url: str, *argv) -> tuple:
    """One invocation of a package's CLI as its ``main`` runs it, but with
    the output in a buffer of its own (the in-process components print to
    sys.stdout too): (stdout, stderr, exit code)."""
    mod, api_error = PKGS[flavor]
    out = io.StringIO()
    err = ""
    args = mod.build_parser().parse_args(["--server", url] + list(argv))
    cli = mod.CLI(url, "default", out=out)
    try:
        mod.dispatch(cli, args)
        code = 0
    except api_error as e:
        err, code = f"error: {e}\n", 1
    except SystemExit as e:
        if isinstance(e.code, str):
            err, code = e.code + "\n", 1
        else:
            code = e.code or 0
    finally:
        cli.cs.close()
    return out.getvalue(), err, code


def run_cli(clusters, flavor, *argv) -> str:
    """test_cli.py's run_cli: the output, SystemExit raised."""
    mod = PKGS[flavor][0]
    url = clusters[flavor].url
    out = io.StringIO()
    cli = mod.CLI(url, "default", out=out)
    try:
        mod.dispatch(cli, mod.build_parser().parse_args(["--server", url] + list(argv)))
    finally:
        cli.cs.close()
    return out.getvalue()


def poll(fn, what: str, timeout: float = 30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = fn()
        if got:
            return got
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def _write(tmp_path, name: str, doc: dict) -> str:
    f = tmp_path / name
    f.write_text(yaml.safe_dump(doc))
    return str(f)


# ------------------------------------------------ tests/test_cli.py, on both

@pytest.mark.parametrize("flavor", FLAVORS)
def test_get_nodes_table(clusters, flavor):
    out = run_cli(clusters, flavor, "get", "nodes")
    assert "node-0" in out and "node-1" in out and "Ready" in out
    assert "4/4" in out  # healthy/total cards
    assert ("TPUS(H/T)" if flavor == "jax" else "GPUS(H/T)") in out


@pytest.mark.parametrize("flavor", FLAVORS)
def test_apply_get_delete_roundtrip(clusters, flavor, tmp_path):
    f = _write(tmp_path, "pod.yaml", {
        "kind": "Pod", "apiVersion": "v1", "metadata": {"name": "cli-pod"},
        "spec": {"containers": [{"name": "c", "image": "busybox", "command": ["sleep", "60"]}]}})
    assert "pods/cli-pod created" in run_cli(clusters, flavor, "apply", "-f", f)
    out = run_cli(clusters, flavor, "get", "pods", "cli-pod", "-o", "json")
    assert json.loads(out)["metadata"]["name"] == "cli-pod"
    assert "pods/cli-pod configured" in run_cli(clusters, flavor, "apply", "-f", f)
    assert "Name:         cli-pod" in run_cli(clusters, flavor, "describe", "pod", "cli-pod")
    assert "deleted" in run_cli(clusters, flavor, "delete", "pod", "cli-pod")


def _deployment(name: str, replicas: int, image: str = "busybox", cause: str = "") -> dict:
    tmpl_meta = {"labels": {"app": name}}
    if cause:
        tmpl_meta["annotations"] = {"ktpu.io/change-cause": cause}
    return {"kind": "Deployment", "apiVersion": "apps/v1", "metadata": {"name": name},
            "spec": {"replicas": replicas, "selector": {"matchLabels": {"app": name}},
                     "template": {"metadata": tmpl_meta, "spec": {"containers": [
                         {"name": "c", "image": image, "command": ["sleep", "300"]}]}}}}


@pytest.mark.parametrize("flavor", FLAVORS)
def test_deployment_scale_and_rollout(clusters, flavor, tmp_path):
    f = _write(tmp_path, "deploy.yaml", _deployment("web", 2))
    run_cli(clusters, flavor, "apply", "-f", f)
    out = run_cli(clusters, flavor, "rollout", "status", "deployment/web", "--timeout", "30")
    assert "successfully rolled out" in out
    assert "scaled to 3" in run_cli(clusters, flavor, "scale", "deployment/web", "--replicas", "3")
    poll(lambda: "3/3" in run_cli(clusters, flavor, "get", "deploy", "web"),
         "deployment scales to 3")
    run_cli(clusters, flavor, "delete", "deployment", "web")


@pytest.mark.parametrize("flavor", FLAVORS)
def test_cordon_drain_uncordon(clusters, flavor):
    assert "cordoned" in run_cli(clusters, flavor, "cordon", "node-1")
    assert "SchedulingDisabled" in run_cli(clusters, flavor, "get", "nodes")
    assert "drained" in run_cli(clusters, flavor, "drain", "node-1")
    run_cli(clusters, flavor, "uncordon", "node-1")
    assert "SchedulingDisabled" not in run_cli(clusters, flavor, "get", "nodes")


@pytest.mark.parametrize("flavor", FLAVORS)
def test_top_nodes(clusters, flavor):
    out = run_cli(clusters, flavor, "top", "nodes")
    assert ("TPU-USED" if flavor == "jax" else "GPU-USED") in out and "node-0" in out


@pytest.mark.parametrize("flavor", FLAVORS)
def test_api_resources(clusters, flavor):
    out = run_cli(clusters, flavor, "api-resources")
    assert "pods" in out and "Pod" in out


@pytest.mark.parametrize("flavor", FLAVORS)
def test_wait_for_delete(clusters, flavor):
    mod = PKGS[flavor][0]
    cli = mod.CLI(clusters[flavor].url, "default", out=io.StringIO())
    api = cli.cs.api if flavor == "jax" else cli.cs.client
    api.request("POST", "/api/v1/namespaces/default/pods", body={
        "kind": "Pod", "apiVersion": "v1", "metadata": {"name": "wait-pod"},
        "spec": {"containers": [{"name": "main", "image": "w",
                                 "resources": {"requests": {"cpu": "100m"}}}]}})
    cli.cs.pods.delete("wait-pod", "default", grace_seconds=0)
    cli.cs.close()
    out = run_cli(clusters, flavor, "wait", "pods/wait-pod", "--for", "delete", "--timeout", "20")
    assert "condition met" in out


@pytest.mark.parametrize("flavor", FLAVORS)
def test_patch_verb(clusters, flavor, tmp_path):
    f = _write(tmp_path, "cm.yaml", {"kind": "ConfigMap", "apiVersion": "v1",
                                     "metadata": {"name": "patch-me"}, "data": {"a": "1"}})
    run_cli(clusters, flavor, "apply", "-f", f)
    assert "patched" in run_cli(clusters, flavor, "patch", "configmap", "patch-me",
                                "-p", '{"data":{"b":"2"}}')
    got = json.loads(run_cli(clusters, flavor, "get", "configmaps", "patch-me", "-o", "json"))
    assert got["data"] == {"a": "1", "b": "2"}


@pytest.mark.parametrize("flavor", FLAVORS)
def test_label_and_annotate(clusters, flavor, tmp_path):
    f = _write(tmp_path, "cm.yaml", {"kind": "ConfigMap", "apiVersion": "v1",
                                     "metadata": {"name": "label-me"}})
    run_cli(clusters, flavor, "apply", "-f", f)

    def get():
        return json.loads(run_cli(clusters, flavor, "get", "configmaps", "label-me", "-o", "json"))

    run_cli(clusters, flavor, "label", "configmap", "label-me", "tier=web")
    assert get()["metadata"]["labels"] == {"tier": "web"}
    with pytest.raises(SystemExit):  # changing without --overwrite refuses
        run_cli(clusters, flavor, "label", "configmap", "label-me", "tier=db")
    run_cli(clusters, flavor, "label", "configmap", "label-me", "tier=db", "--overwrite")
    run_cli(clusters, flavor, "label", "configmap", "label-me", "tier-")
    assert not (get()["metadata"].get("labels") or {})
    run_cli(clusters, flavor, "annotate", "configmap", "label-me", "note=hi")
    assert get()["metadata"]["annotations"]["note"] == "hi"


@pytest.mark.parametrize("flavor", FLAVORS)
def test_edit_verb(clusters, flavor, tmp_path, monkeypatch):
    f = _write(tmp_path, "cm.yaml", {"kind": "ConfigMap", "apiVersion": "v1",
                                     "metadata": {"name": "edit-me"}, "data": {"k": "v0"}})
    run_cli(clusters, flavor, "apply", "-f", f)
    editor = tmp_path / "editor.sh"
    editor.write_text("#!/bin/sh\nsed -i 's/v0/v1/' \"$1\"\n")
    editor.chmod(0o755)
    monkeypatch.setenv("EDITOR", str(editor))
    assert "edited" in run_cli(clusters, flavor, "edit", "configmap", "edit-me")
    got = json.loads(run_cli(clusters, flavor, "get", "configmaps", "edit-me", "-o", "json"))
    assert got["data"]["k"] == "v1"


@pytest.mark.parametrize("flavor", FLAVORS)
def test_rollout_history_and_undo(clusters, flavor, tmp_path):
    manifest = _deployment("rollme", 1, image="img:v1", cause="v1")
    path = _write(tmp_path, "rollme.yaml", manifest)
    run_cli(clusters, flavor, "apply", "-f", path)
    manifest["spec"]["template"]["spec"]["containers"][0]["image"] = "img:v2"
    manifest["spec"]["template"]["metadata"]["annotations"]["ktpu.io/change-cause"] = "v2"
    path = _write(tmp_path, "rollme.yaml", manifest)
    run_cli(clusters, flavor, "apply", "-f", path)

    def history():
        out = run_cli(clusters, flavor, "rollout", "history", "deployment/rollme")
        return [ln for ln in out.splitlines() if ln.strip()]

    # the controller stamps the second ReplicaSet's revision after it makes
    # it (a 0 until then): wait for both stamps, not for two lines
    lines = poll(lambda: (lambda ls: ls if len(ls) >= 2 and "0\t" not in
                          [ln[:2] for ln in ls] else None)(history()), "two stamped revisions")
    assert any(ln.startswith("1\t") and "v1" in ln for ln in lines), lines
    assert any(ln.startswith("2\t") and "v2" in ln for ln in lines), lines
    assert "rolled back" in run_cli(clusters, flavor, "rollout", "undo", "deployment/rollme")
    got = json.loads(run_cli(clusters, flavor, "get", "deployments", "rollme", "-o", "json"))
    assert got["spec"]["template"]["spec"]["containers"][0]["image"] == "img:v1"
    # the rolled-back template becomes the NEW highest revision
    poll(lambda: history()[-1].startswith("3\t"), "revision 3")
    run_cli(clusters, flavor, "delete", "deployments", "rollme")


@pytest.mark.parametrize("flavor", FLAVORS)
def test_three_way_apply_removes_dropped_fields(clusters, flavor, tmp_path):
    m = {"kind": "ConfigMap", "apiVersion": "v1",
         "metadata": {"name": "cfg3w", "labels": {"team": "ml", "tier": "train"}},
         "data": {"lr": "3e-4", "batch": "256"}}
    run_cli(clusters, flavor, "apply", "-f", _write(tmp_path, "cm.yaml", m))

    def live():
        return json.loads(run_cli(clusters, flavor, "get", "configmaps", "cfg3w", "-o", "json"))

    assert live()["metadata"]["labels"] == {"team": "ml", "tier": "train"}
    assert "kubectl.kubernetes.io/last-applied-configuration" in live()["metadata"]["annotations"]
    m["metadata"]["labels"] = {"team": "ml"}
    m["data"] = {"lr": "1e-4"}
    assert "configured" in run_cli(clusters, flavor, "apply", "-f",
                                   _write(tmp_path, "cm.yaml", m))
    got = live()
    assert got["metadata"]["labels"] == {"team": "ml"}
    assert got["data"] == {"lr": "1e-4"}
    run_cli(clusters, flavor, "delete", "configmaps", "cfg3w")


@pytest.mark.parametrize("flavor", FLAVORS)
def test_three_way_apply_preserves_server_owned_fields(clusters, flavor, tmp_path):
    m = {"kind": "ConfigMap", "apiVersion": "v1", "metadata": {"name": "cfg-owned"},
         "data": {"a": "1"}}
    run_cli(clusters, flavor, "apply", "-f", _write(tmp_path, "cm2.yaml", m))
    run_cli(clusters, flavor, "annotate", "configmaps", "cfg-owned", "owned-by=some-controller")
    m["data"] = {"a": "2"}
    run_cli(clusters, flavor, "apply", "-f", _write(tmp_path, "cm2.yaml", m))
    live = json.loads(run_cli(clusters, flavor, "get", "configmaps", "cfg-owned", "-o", "json"))
    assert live["data"] == {"a": "2"}
    assert live["metadata"]["annotations"]["owned-by"] == "some-controller"
    run_cli(clusters, flavor, "delete", "configmaps", "cfg-owned")


@pytest.mark.parametrize("flavor", FLAVORS)
def test_taint_add_and_remove(clusters, flavor):
    assert "tainted" in run_cli(clusters, flavor, "taint", "nodes", "node-0",
                                "dedicated=gpu:NoSchedule")
    node = json.loads(run_cli(clusters, flavor, "get", "nodes", "node-0", "-o", "json"))
    assert {"key": "dedicated", "value": "gpu", "effect": "NoSchedule"} in node["spec"]["taints"]
    run_cli(clusters, flavor, "taint", "node-0", "dedicated:NoSchedule-")
    node = json.loads(run_cli(clusters, flavor, "get", "nodes", "node-0", "-o", "json"))
    assert not node.get("spec", {}).get("taints")


@pytest.mark.parametrize("flavor", FLAVORS)
def test_expose_deployment(clusters, flavor, tmp_path):
    run_cli(clusters, flavor, "apply", "-f", _write(tmp_path, "dep.yaml", _deployment("web", 1)))
    out = run_cli(clusters, flavor, "expose", "deployment", "web", "--port", "80",
                  "--target-port", "8080")
    assert "service/web exposed" in out
    svc = json.loads(run_cli(clusters, flavor, "get", "services", "web", "-o", "json"))
    assert svc["spec"]["selector"] == {"app": "web"}
    assert svc["spec"]["ports"][0]["port"] == 80
    assert svc["spec"]["ports"][0]["targetPort"] == 8080
    run_cli(clusters, flavor, "delete", "services", "web")
    run_cli(clusters, flavor, "delete", "deployments", "web")


@pytest.mark.parametrize("flavor", FLAVORS)
def test_auth_can_i(clusters, flavor):
    assert run_cli(clusters, flavor, "auth", "can-i", "create", "pods").strip() == "yes"


@pytest.mark.parametrize("flavor", FLAVORS)
def test_explain(clusters, flavor):
    out = run_cli(clusters, flavor, "explain", "pods")
    assert "KIND:     Pod" in out and "spec" in out
    out = run_cli(clusters, flavor, "explain", "pods.spec.containers")
    assert "Container" in out and "image" in out
    out = run_cli(clusters, flavor, "explain", "pods.spec.nodeName")
    assert "FIELD:" in out and "str" in out


# ------------------------------------------------------- the seeded script

MASKS = [
    (re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}"), "<uid>"),
    (re.compile(r"(resourceVersion\"?:\s*)[\"']?\d+[\"']?"), r"\1<rv>"),
    (re.compile(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d(\.\d+)?Z"), "<ts>"),
    (re.compile(r"(?<![\w.-])\d+[smhd](?![\w.-])"), "<age>"),
    (re.compile(r"(127\.0\.0\.1|localhost):\d+"), r"\1:<port>"),
    (re.compile(r"google\.com/tpu"), "nvidia.com/gpu"),
    (re.compile(r"\bTPU"), "GPU"),
    (re.compile(r" +"), " "),
]


def mask(text: str) -> str:
    for pattern, repl in MASKS:
        text = pattern.sub(repl, text)
    return text


EXPLAIN = ["pods", "pods.spec", "pods.spec.containers", "pods.spec.nodeName", "nodes.status",
           "deployments.spec", "jobs.spec", "services.spec.ports", "configmaps", "secrets",
           "priorityclasses", "namespaces"]
VERBS = ["get", "list", "create", "delete", "patch", "watch"]
RESOURCES = ["pods", "po", "nodes", "deployments", "configmaps", "cm", "secrets", "jobs",
             "priorityclasses", "namespaces"]


def script(seed: int, tmp_path) -> list:
    """A seeded list of argv, the same for both packages, over objects
    whose state no controller races (configmaps, secrets, priority
    classes, a zero-replica Deployment, the nodes), with each of the
    CLI's output forms and error paths."""
    rng = random.Random(seed)
    pre = f"s{seed}"
    cms = [f"{pre}-cm{i}" for i in range(3)]
    steps = []

    def manifest(doc) -> str:
        path = tmp_path / f"m{len(steps)}.yaml"
        path.write_text(yaml.safe_dump(doc))
        return str(path)

    def cm_doc(name):
        return {"kind": "ConfigMap", "apiVersion": "v1",
                "metadata": {"name": name,
                             "labels": {f"k{rng.randrange(3)}": f"v{rng.randrange(3)}"}},
                "data": {f"key{i}": f"val{rng.randrange(100)}" for i in range(rng.randrange(4))}}

    ops = [
        lambda: ["apply", "-f", manifest(cm_doc(rng.choice(cms)))],
        lambda: ["create", "-f", manifest(cm_doc(rng.choice(cms)))],
        lambda: ["get", rng.choice(["configmaps", "cm", "configmap"]), rng.choice(cms), "-o",
                 rng.choice(["json", "yaml", "name", "table"])],
        lambda: ["get", "cm", "-l", f"k{rng.randrange(3)}=v{rng.randrange(3)}", "-o",
                 rng.choice(["name", "table"])],
        lambda: ["get", "cm", "-A", "-o", "name"],
        lambda: ["patch", "configmap", rng.choice(cms), "-p",
                 json.dumps({"data": {f"p{rng.randrange(3)}": str(rng.randrange(9))}})],
        lambda: ["patch", "configmap", rng.choice(cms), "-p", "{not json"],
        lambda: ["label", "configmap", rng.choice(cms), f"l{rng.randrange(2)}=x{rng.randrange(2)}"]
        + (["--overwrite"] if rng.random() < 0.5 else []),
        lambda: ["label", "configmap", rng.choice(cms), f"l{rng.randrange(2)}-"],
        lambda: ["annotate", "configmap", rng.choice(cms), f"a{rng.randrange(2)}=y"],
        lambda: ["describe", "configmap", rng.choice(cms)],
        lambda: ["delete", "configmaps", rng.choice(cms)],
        lambda: ["delete", "-f", manifest(cm_doc(rng.choice(cms)))],
        lambda: ["wait", f"configmaps/{rng.choice(cms)}", "--for", "delete", "--timeout", "1"],
        lambda: ["explain", rng.choice(EXPLAIN)],
        lambda: ["explain", "pods.spec.noSuchField"],
        lambda: ["auth", "can-i", rng.choice(VERBS), rng.choice(RESOURCES)],
        lambda: ["get", "nodes"] + rng.choice([[], ["-o", "name"], ["node-1"]]),
        lambda: ["get", "pods", f"{pre}-missing"],
        lambda: ["delete", "pod", f"{pre}-missing"],
        lambda: ["get", "secrets", f"{pre}-sec", "-o", rng.choice(["json", "name"])],
        lambda: ["apply", "-f", manifest({"kind": "Secret", "apiVersion": "v1",
                                          "metadata": {"name": f"{pre}-sec"}, "type": "Opaque",
                                          "data": {"token": f"dG9r{rng.randrange(10)}"}})],
        lambda: ["apply", "-f", manifest({"kind": "PriorityClass", "apiVersion": "scheduling/v1",
                                          "metadata": {"name": f"{pre}-pc"},
                                          "value": rng.randrange(1000)})],
        lambda: ["get", "pc", f"{pre}-pc", "-o", rng.choice(["yaml", "name", "table"])],
        lambda: ["scale", f"configmaps/{rng.choice(cms)}", "--replicas", "2"],
        lambda: ["taint", "nodes", "node-1", "seed=x:Bogus"],
        lambda: ["get", "ns", "-o", "name"],
    ]
    weights = [6, 1] + [2] * (len(ops) - 2)  # applies keep the configmaps alive
    for _ in range(50):
        steps.append(rng.choices(ops, weights)[0]())
    dep = manifest(_deployment(f"{pre}-dep", 0))
    steps += [["apply", "-f", dep],
              ["rollout", "status", f"deployment/{pre}-dep", "--timeout", "30"],
              ["scale", f"deployment/{pre}-dep", "--replicas", "0"],
              ["get", "deploy", f"{pre}-dep", "-o", "name"],
              ["rollout", "restart", f"deployment/{pre}-dep"],
              ["taint", "nodes", "node-1", f"{pre}=t:PreferNoSchedule"],
              ["taint", "nodes", "node-1", f"{pre}=u:PreferNoSchedule"],
              ["taint", "nodes", "node-1", f"{pre}=u:PreferNoSchedule", "--overwrite"],
              ["get", "nodes", "node-1", "-o", "json"],
              ["taint", "node-1", f"{pre}:PreferNoSchedule-"],
              ["taint", "node-1", f"{pre}:PreferNoSchedule-"],
              ["cordon", "node-1"], ["uncordon", "node-1"],
              ["delete", "deployment", f"{pre}-dep"],
              ["delete", "priorityclasses", f"{pre}-pc"]]
    steps += [["delete", "configmaps", name] for name in cms]
    return steps


@pytest.mark.parametrize("seed", range(4))
def test_seeded_script_gives_the_same_answers(clusters, seed, tmp_path):
    """Step by step on both clusters, the same argv: stdout, stderr and the
    exit code equal after the masks.  ``get nodes -o json`` is compared
    on everything but the node's cards (each package's own), its kubelet's
    address and the images of the pods the earlier cases' placements put
    on it."""
    mismatches = []
    for argv in script(seed, tmp_path):
        got = {}
        for flavor in FLAVORS:
            out, err, code = invoke(flavor, clusters[flavor].url, *argv)
            if argv[:2] == ["get", "nodes"] and "json" in argv:
                doc = json.loads(out)
                doc["status"].pop("extendedResources")
                doc["status"].pop("images", None)
                doc["metadata"]["annotations"].pop("kubelet.ktpu.io/server")
                doc["status"]["conditions"] = [c["type"] for c in doc["status"]["conditions"]]
                out = json.dumps(doc, sort_keys=True)
            got[flavor] = (mask(out), mask(err), code)
        if got["jax"] != got["torch"]:
            mismatches.append((argv, got))
    assert not mismatches, "\n".join(f"{a}: {g}" for a, g in mismatches[:5])


# ------------------------------------------------------------ deviations

def test_the_tpu_seam_each_cli_counts_its_own_cards(clusters):
    """Deviation: the JAX CLI reads google.com/tpu, the port's
    nvidia.com/gpu, in ``top`` and in the node and pod tables.  Both CLIs
    on both clusters: each sees 4 cards a node only on its own cluster."""
    got = {}
    for flavor in FLAVORS:
        for where in FLAVORS:
            url = clusters[where].url
            top = invoke(flavor, url, "top", "nodes")[0].splitlines()
            table = invoke(flavor, url, "get", "nodes")[0].splitlines()
            got[flavor, where] = (top[0].split(), top[1].split(), table[0].split()[3],
                                  table[1].split()[3] if len(table[1].split()) > 4 else "")
    assert got["torch", "torch"] == (["NODE", "GPU-USED", "GPU-TOTAL", "UTIL%"],
                                     ["node-0", "0", "4", "0"], "GPUS(H/T)", "4/4")
    assert got["torch", "jax"] == (["NODE", "GPU-USED", "GPU-TOTAL", "UTIL%"],
                                   ["node-0", "0", "0", "-"], "GPUS(H/T)", "")
    assert got["jax", "jax"] == (["NODE", "TPU-USED", "TPU-TOTAL", "UTIL%"],
                                 ["node-0", "0", "4", "0"], "TPUS(H/T)", "4/4")
    assert got["jax", "torch"] == (["NODE", "TPU-USED", "TPU-TOTAL", "UTIL%"],
                                   ["node-0", "0", "0", "-"], "TPUS(H/T)", "")
    pods = {f: invoke(f, clusters[f].url, "top", "pods")[0].splitlines()[0].split()
            for f in FLAVORS}
    assert pods == {"jax": ["POD", "PHASE", "TPUS"], "torch": ["POD", "PHASE", "GPUS"]}


def _main(flavor: str, *argv) -> tuple:
    mod = PKGS[flavor][0]
    out, err = io.StringIO(), io.StringIO()
    from contextlib import redirect_stderr, redirect_stdout

    with redirect_stdout(out), redirect_stderr(err):
        try:
            code = mod.main(list(argv))
        except SystemExit as e:
            code = e.code
    return out.getvalue(), code


def test_version_names_its_package():
    assert _main("jax", "version") == ("ktpu v0.1 (kubernetes1_tpu)\n", 0)
    assert _main("torch", "version") == ("ktpu v0.1 (kubernetes1_tpu_torch)\n", 0)


ITEM_18_KINDS = {"apiservices", "customresourcedefinitions", "leases",
                 "mutatingwebhookconfigurations", "podpresets", "podsecuritypolicies",
                 "validatingwebhookconfigurations"}


def test_api_resources_lists_each_packages_scheme(clusters):
    """Deviation: the port lists what its scheme registers, the JAX kinds
    but those item 18 still leaves out (leases, CRDs, APIServices,
    webhooks, PodPresets, PSPs); each row is the JAX row for the same plural."""
    from kubernetes1_tpu_torch.machinery.scheme import global_scheme

    rows = {f: invoke(f, clusters[f].url, "api-resources")[0].splitlines() for f in FLAVORS}
    assert rows["torch"][0] == rows["jax"][0]
    jax_rows = {r.split()[0]: r for r in rows["jax"][1:]}
    torch_rows = {r.split()[0]: r for r in rows["torch"][1:]}
    assert set(torch_rows) == set(global_scheme.by_resource)
    assert set(jax_rows) - set(torch_rows) == ITEM_18_KINDS
    assert all(torch_rows[p] == jax_rows[p] for p in torch_rows)


def _accepts(flavor: str, *argv) -> bool:
    mod = PKGS[flavor][0]
    err = io.StringIO()
    from contextlib import redirect_stderr

    with redirect_stderr(err):
        try:
            mod.build_parser().parse_args(list(argv))
            return True
        except SystemExit:
            return False


@pytest.mark.parametrize("argv,jax,torch", [
    (["cluster-up", "--gpus-per-node", "2", "--real-gpu", "--hollow", "--port", "5"], False, True),
    (["cluster-up", "--tpus-per-node", "2", "--real-tpu", "--hollow", "--port", "5"], True, False),
    (["cluster-up", "--nodes", "3", "--hollow"], True, True),
    (["init", "--port", "6443"], True, True),
    (["join", "--server", "https://x", "--token", "t"], True, True),
    (["--token", "t", "get", "pods"], True, True),
    (["--kubeconfig", "k", "--ca-file", "c", "get", "pods"], True, True),
])
def test_cluster_up_and_auth_flags(argv, jax, torch):
    """Deviation: cluster-up's --gpus-per-node / --real-gpu in place of
    --tpus-per-node / --real-tpu; init, join and the client's auth and TLS
    flags are both packages' (item 18)."""
    assert (_accepts("jax", *argv), _accepts("torch", *argv)) == (jax, torch)


def test_cluster_up_defaults_match_the_jax_ones():
    j = jcli.build_parser().parse_args(["cluster-up"])
    t = tcli.build_parser().parse_args(["cluster-up"])
    assert (t.nodes, t.gpus_per_node, t.port, t.hollow, t.real_gpu) == \
        (j.nodes, j.tpus_per_node, j.port, j.hollow, j.real_tpu) == (1, 4, 8001, False, False)


# --------------------------------------------------------------- processes

def test_importing_the_cli_loads_neither_torch_nor_jax():
    code = ("import sys, kubernetes1_tpu_torch.cli\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'jaxlib', 'kubernetes1_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=60, check=True).stdout
    assert out.strip() == "[]"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _refused(port: int) -> bool:
    try:
        socket.create_connection(("127.0.0.1", port), timeout=1).close()
        return False
    except OSError:
        return True


def _ktpu(url: str, *argv) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "kubernetes1_tpu_torch", "ktpu", "--server",
                           url, *argv], cwd=REPO, capture_output=True, text=True, timeout=60)


def _children(pid: int) -> set:
    out = set()
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    if int(f.read().rsplit(")", 1)[1].split()[1]) == pid:
                        out.add(int(d))
            except (OSError, ValueError, IndexError):
                continue
    return out


def _pod_pids(url: str) -> set:
    """Processes whose environment holds KTPU_APISERVER=url: the pods of
    that cluster."""
    out = set()
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/environ", "rb") as f:
                    if f"KTPU_APISERVER={url}".encode() in f.read().split(b"\0"):
                        out.add(int(d))
            except OSError:
                continue
    return out


class ClusterUp:
    """``cluster-up`` as a child process in a session of its own."""

    # the kubelets read no eviction signals: the test host's disk may be full
    PRELUDE = ("import sys\n"
               "import kubernetes1_tpu_torch.kubelet.kubelet as k\n"
               "k.default_signals = lambda: {}\n"
               "from kubernetes1_tpu_torch.cli import main\n"
               "sys.exit(main(sys.argv[1:]))\n")

    def __init__(self, tmp_path, *flags, via_module=True):
        self.port = _free_port()
        self.url = f"http://127.0.0.1:{self.port}"
        argv = ["-m", "kubernetes1_tpu_torch", "ktpu"] if via_module else ["-c", self.PRELUDE]
        self.log = open(tmp_path / "cluster-up.log", "w+")
        env = {k: v for k, v in os.environ.items() if k != "KTPU_FAKE_GPUS"}
        self.proc = subprocess.Popen(
            [sys.executable, *argv, "cluster-up", "--nodes", "1", "--port", str(self.port),
             *flags], cwd=REPO, stdout=self.log, stderr=subprocess.STDOUT, env=env,
            start_new_session=True)

    def output(self) -> str:
        self.log.seek(0)
        return self.log.read()

    def wait_node_ready(self):
        def ready():
            assert self.proc.poll() is None, self.output()
            got = _ktpu(self.url, "get", "nodes")
            return got.returncode == 0 and re.search(r"^node-0\s+Ready\s", got.stdout, re.M)

        poll(ready, "node-0 Ready through ktpu", WAIT_S)

    def interrupt(self) -> int:
        self.proc.send_signal(signal.SIGINT)
        return self.proc.wait(timeout=WAIT_S)

    def close(self):
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()
        self.log.close()


def test_cluster_up_hollow_answers_get_nodes_and_stops_on_sigint(tmp_path):
    cu = ClusterUp(tmp_path, "--hollow")
    try:
        cu.wait_node_ready()
        got = _ktpu(cu.url, "top", "nodes")
        assert got.returncode == 0 and got.stdout.splitlines()[1].split() == \
            ["node-0", "0", "4", "0"]
        children = _children(cu.proc.pid)
        assert cu.interrupt() == 0, cu.output()
        assert f"cluster up: apiserver {cu.url}" in cu.output()
        assert "cluster down" in cu.output()
        assert _refused(cu.port)
        assert not [p for p in children if os.path.exists(f"/proc/{p}")]
    finally:
        cu.close()


def test_cluster_up_process_nodes_leave_no_pod_process(tmp_path):
    """Without --hollow the node runs a ProcessRuntime on fake cards; a
    running pod's process is gone once SIGINT has stopped the cluster."""
    cu = ClusterUp(tmp_path, via_module=False)
    try:
        cu.wait_node_ready()
        pod = tmp_path / "pod.yaml"
        spec = {"restartPolicy": "Never", "extendedResources": [
            {"name": "gpu", "resource": "nvidia.com/gpu", "quantity": 1}],
            "containers": [{"name": "c", "image": "python",
                            "command": [sys.executable, "-c", "import time; time.sleep(300)"],
                            "extendedResourceRequests": ["gpu"]}]}
        pod.write_text(yaml.safe_dump({"kind": "Pod", "apiVersion": "v1",
                                       "metadata": {"name": "sleeper"}, "spec": spec}))
        assert _ktpu(cu.url, "apply", "-f", str(pod)).returncode == 0
        assert _ktpu(cu.url, "wait", "pod/sleeper", "--for", "phase=running",
                     "--timeout", "60").returncode == 0
        pids = poll(lambda: _pod_pids(cu.url), "the pod's process")
        top = _ktpu(cu.url, "top", "pods").stdout.splitlines()
        assert top[1].split() == ["sleeper", "Running", "1"]
        assert cu.interrupt() == 0, cu.output()
        poll(lambda: not [p for p in pids if _alive(p)], "the pod's process to go", 10)
        assert _refused(cu.port)
    finally:
        cu.close()


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def test_cluster_up_real_gpu_without_a_card_fails(tmp_path):
    """--real-gpu never falls back to fake cards: with no card on the
    machine cluster-up exits 1 and leaves nothing listening."""
    cu = ClusterUp(tmp_path, "--real-gpu", "--hollow")
    try:
        assert cu.proc.wait(timeout=WAIT_S) == 1
        assert "error: --real-gpu: this machine has no NVIDIA card" in cu.output()
        assert _refused(cu.port)
    finally:
        cu.close()
