"""``ktpu init`` and ``ktpu join`` of the port (``cli/bootstrap.py``) as an
operator runs them: two commands, two state directories on one machine,
two kubelet identities, every component a ``python -m
kubernetes1_tpu_torch <component>`` process.

``init`` brings up the port's apiserver (HTTPS only, Node,RBAC, a WAL),
scheduler, controller manager and a kubelet whose x509 credential came
through a CSR; the join command it prints, parsed as an operator would,
adds a second node.  Both nodes go Ready under their CSR-signed
identities; anonymous access is refused; nothing listens in plain HTTP; a
join with a bad token or a wrong CA pin exits non-zero and makes no node.
At teardown every process of both ``pids.json`` files stops, and no
process of the cluster survives it (the leak check of
``tests/conftest.py`` holds the session to that as well).
"""

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import time
from urllib.parse import urlparse

import pytest

from kubernetes1_tpu_torch.api import types as t
from kubernetes1_tpu_torch.client.clientset import Clientset
from kubernetes1_tpu_torch.machinery.errors import ApiError, Forbidden

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPONENTS = ["apiserver", "controller-manager", "kubelet", "scheduler"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ktpu(*argv, timeout=90):
    return subprocess.run([sys.executable, "-m", "kubernetes1_tpu_torch", "ktpu", *argv],
                          capture_output=True, text=True, timeout=timeout, cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO))


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _stop(dirs) -> list:
    """SIGTERM every process group of the dirs' pids.json; the pids still
    alive after 20 s (then killed)."""
    pids = []
    for d in dirs:
        try:
            with open(os.path.join(d, "pids.json")) as f:
                pids += list(json.load(f).values())
        except OSError:
            continue
    for pid in pids:
        try:
            os.killpg(pid, signal.SIGTERM)
        except OSError:
            pass
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline and any(_alive(p) for p in pids):
        time.sleep(0.1)
    stuck = [p for p in pids if _alive(p)]
    for pid in stuck:
        try:
            os.killpg(pid, signal.SIGKILL)
        except OSError:
            pass
    return stuck


def _cluster_pids(server: str) -> list:
    """Processes whose environment names the cluster's apiserver (its pods)."""
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                if f"KTPU_APISERVER={server}".encode() in f.read().split(b"\0"):
                    out.append(int(pid))
        except OSError:
            continue
    return out


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bootstrap")
    d1, d2 = str(tmp / "host1"), str(tmp / "host2")
    env = {"d1": d1, "d2": d2, "bad": str(tmp / "bad"),
           "plugins": {"host1": str(tmp / "plugins1"), "host2": str(tmp / "plugins2")}}
    try:
        r = ktpu("init", "--dir", d1, "--port", str(_free_port()), "--node-name", "host1",
                 "--plugin-dir", env["plugins"]["host1"])
        assert r.returncode == 0, r.stdout + r.stderr
        parts = next(line for line in r.stdout.splitlines() if "ktpu join" in line).split()
        env.update(server=parts[parts.index("--server") + 1],
                   token=parts[parts.index("--token") + 1],
                   ca_hash=parts[parts.index("--ca-cert-hash") + 1], init_out=r.stdout)
        r2 = ktpu("join", "--server", env["server"], "--token", env["token"],
                  "--ca-cert-hash", env["ca_hash"], "--node-name", "host2", "--dir", d2,
                  "--plugin-dir", env["plugins"]["host2"])
        assert r2.returncode == 0, r2.stdout + r2.stderr
        env["join_out"] = r2.stdout
        yield env
    finally:
        stuck = _stop([d1, d2])
        survivors = _cluster_pids(env.get("server", "-"))
        for pid in survivors:
            os.kill(pid, signal.SIGKILL)
        assert not stuck and not survivors, (stuck, survivors)


def test_both_nodes_join_ready_under_csr_signed_credentials(cluster):
    assert cluster["server"].startswith("https://")
    assert "node host2 joined the cluster" in cluster["join_out"]
    admin = Clientset.from_config(os.path.join(cluster["d1"], "admin.conf"))
    try:
        deadline = time.monotonic() + 30
        while True:
            nodes = admin.nodes.list()[0]
            ready = {n.metadata.name for n in nodes if any(
                c.type == "Ready" and c.status == "True" for c in n.status.conditions)}
            if ready == {"host1", "host2"} or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        assert ready == {"host1", "host2"}
        csrs = admin.certificatesigningrequests.list()[0]
        for node in ("host1", "host2"):
            mine = [c for c in csrs if c.metadata.name.startswith(f"node-csr-{node}-")]
            assert len(mine) == 1 and mine[0].status.certificate.startswith(
                "-----BEGIN CERTIFICATE-----")
        for n in nodes:
            assert n.metadata.annotations["kubelet.ktpu.io/server"].startswith("https://")
    finally:
        admin.close()


def test_the_state_dirs_hold_what_the_jax_init_writes(cluster):
    d1, d2 = cluster["d1"], cluster["d2"]
    for name in ("admin.conf", "controller-manager.conf", "scheduler.conf", "kubelet.conf",
                 "pids.json", "store.wal", "pki/ca.crt", "pki/ca.key", "pki/apiserver.crt",
                 "pki/sa.key", "pki/kubelet.crt", "pki/kubelet.key"):
        assert os.path.exists(os.path.join(d1, name)), name
    for name in ("kubelet.conf", "pki/ca.crt", "pki/kubelet.crt", "pids.json"):
        assert os.path.exists(os.path.join(d2, name)), name
    assert oct(os.stat(os.path.join(d1, "pki", "ca.key")).st_mode & 0o777) == "0o600"
    with open(os.path.join(d1, "pids.json")) as f:
        pids = json.load(f)
    assert sorted(pids) == COMPONENTS
    commands = []
    for name in sorted(os.listdir(os.path.join(d1, "manifests"))):
        with open(os.path.join(d1, "manifests", name)) as f:
            commands.append(json.load(f)["spec"]["containers"][0]["command"])
    for pid in pids.values():
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            commands.append(f.read().decode().split("\0"))
    for cmd in commands:
        assert cmd[1:3] == ["-m", "kubernetes1_tpu_torch"], cmd
        assert not any(a.startswith("kubernetes1_tpu.") or a == "kubernetes1_tpu" for a in cmd)
    assert len(commands) == 7
    kubelet = [cmd for cmd in commands if cmd[3:4] == ["kubelet"]]
    assert [cmd[cmd.index("--plugin-dir") + 1] for cmd in kubelet] == [
        cluster["plugins"]["host1"]]


def test_the_apiserver_and_the_kubelets_speak_tls_only(cluster):
    admin = Clientset.from_config(os.path.join(cluster["d1"], "admin.conf"))
    try:
        urls = [cluster["server"]] + [n.metadata.annotations["kubelet.ktpu.io/server"]
                                      for n in admin.nodes.list()[0]]
    finally:
        admin.close()
    for url in urls:
        p = urlparse(url)
        conn = http.client.HTTPConnection(p.hostname, p.port, timeout=5)
        with pytest.raises((OSError, http.client.HTTPException)):
            conn.request("GET", "/healthz")
            conn.getresponse().read()
        conn.close()


def test_anonymous_reads_cluster_info_and_nothing_else(cluster):
    anon = Clientset(cluster["server"], ca_file=os.path.join(cluster["d1"], "pki", "ca.crt"))
    try:
        info = anon.configmaps.get("cluster-info", "kube-public")
        assert info.data["server"] == cluster["server"]
        with pytest.raises(Forbidden):
            anon.pods.list("default")
    finally:
        anon.close()


@pytest.mark.parametrize("what", ["bad token", "wrong ca-cert-hash"])
def test_a_bad_join_is_refused_and_makes_no_node(cluster, what):
    token = "deadbe.0000000000000000" if what == "bad token" else cluster["token"]
    pin = cluster["ca_hash"] if what == "bad token" else "sha256:" + "0" * 64
    r = ktpu("join", "--server", cluster["server"], "--token", token, "--ca-cert-hash", pin,
             "--node-name", "intruder", "--dir", cluster["bad"], timeout=60)
    assert r.returncode != 0
    out = (r.stdout + r.stderr).lower()
    assert ("invalid bearer token" in out) if what == "bad token" else ("mismatch" in out)
    assert not os.path.exists(os.path.join(cluster["bad"], "pids.json"))
    admin = Clientset.from_config(os.path.join(cluster["d1"], "admin.conf"))
    try:
        assert "intruder" not in {n.metadata.name for n in admin.nodes.list()[0]}
    finally:
        admin.close()


def test_init_refuses_a_port_where_an_apiserver_serves(cluster, tmp_path):
    port = urlparse(cluster["server"]).port
    r = ktpu("init", "--dir", str(tmp_path / "again"), "--port", str(port), "--node-name", "x")
    assert r.returncode != 0 and "already serving" in r.stdout + r.stderr
    assert not os.path.exists(tmp_path / "again" / "pids.json")


def test_the_bootstrap_token_may_create_a_csr_but_not_read_pods(cluster):
    boot = Clientset(cluster["server"], token=cluster["token"],
                     ca_file=os.path.join(cluster["d1"], "pki", "ca.crt"))
    try:
        csr = t.CertificateSigningRequest()
        csr.metadata.name = "probe-csr"
        csr.spec.request, csr.spec.username = "opaque", "probe"
        made = boot.certificatesigningrequests.create(csr)
        assert made.metadata.annotations["ktpu.io/created-by"].startswith("system:bootstrap:")
        with pytest.raises(Forbidden):
            boot.pods.list("default")
        with pytest.raises(ApiError) as e:
            boot.secrets.list("kube-system")
        assert e.value.code == 403
    finally:
        boot.close()
