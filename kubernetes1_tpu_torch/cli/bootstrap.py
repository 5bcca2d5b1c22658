"""`ktpu init` / `ktpu join`: a cluster of the port's components over
TLS in two commands.  The port's copy of the JAX package's
``cli/bootstrap.py``: it writes the same ``pki/``, ``*.conf``,
``manifests/`` and ``pids.json``, and spawns only ``python -m
kubernetes1_tpu_torch <component>``.

Ref: cmd/kubeadm phases — certs (app/phases/certs/certs.go:37
CreatePKIAssets: CA, apiserver serving cert, component client certs),
control-plane static manifests (app/phases/controlplane/manifests.go:45-47),
bootstrap tokens (app/phases/bootstraptoken), the cluster-info discovery
ConfigMap (app/phases/bootstraptoken/clusterinfo), and the kubelet
TLS-bootstrap CSR flow (pkg/controller/certificates).

init, on the first host:
  1. certs          — the cluster CA (x509), the apiserver's serving
                      cert, client certs for the admin, scheduler and
                      controller manager, the SA signing key, under
                      --dir/pki.
  2. control plane  — manifests for an HTTPS-only apiserver (Node,RBAC,
                      its store's WAL in --dir/store.wal), scheduler and
                      controller manager, and those exact commands
                      started as processes.
  3. bootstrap      — the join token as the kube-system bootstrap-token
                      Secret; the CA in the kube-public cluster-info
                      ConfigMap (readable by anonymous and bootstrappers);
                      the RBAC that lets system:bootstrappers submit node
                      CSRs; the join command with the CA's pin.
  4. kubelet        — this host's kubelet through the flow join uses: a
                      key and a PEM CSR, signed by the certificate
                      controller into a dual-EKU node cert, the kubelet's
                      client credential and its :10250 serving cert.

join, on another host:
  1. fetch the CA from cluster-info over unverified TLS, pin it against
     --ca-cert-hash, then reconnect verified;
  2. authenticate with the join token (system:bootstrap:<id>), submit a
     node CSR, which the certificate controller approves and signs;
  3. write kubelet.conf and start the kubelet with the signed credential.
"""


from __future__ import annotations

import http.client
import json
import os
import secrets as _secrets
import subprocess
import sys
import time
from typing import List, Optional, Tuple

from ..api import types as t
from ..client.clientset import Clientset
from ..machinery import AlreadyExists, ApiError, NotFound
from ..machinery.meta import to_iso
from ..utils import pki

CONTROL_PLANE = ("apiserver", "controller-manager", "scheduler")


def _write(path: str, content: str, mode: int = 0o600) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(content)
    os.chmod(path, mode)
    return path


def _manifest(name: str, command: List[str]) -> dict:
    """Static-pod manifest shape (the kubeadm manifests analog): a kubelet
    with --static-pod-dir pointed at <dir>/manifests re-hosts the control
    plane after a reboot."""
    return {
        "kind": "Pod",
        "apiVersion": "v1",
        "metadata": {"name": f"kube-{name}", "namespace": "kube-system",
                     "labels": {"component": name, "tier": "control-plane"}},
        "spec": {"containers": [{
            "name": name, "image": "ktpu-control-plane",
            "command": command,
        }], "restartPolicy": "Always"},
    }


def _spawn(command: List[str], log_path: str) -> subprocess.Popen:
    """A component as a process of its own session: the pid that
    ``pids.json`` holds leads its process group."""
    with open(log_path, "ab") as logf:
        return subprocess.Popen(command, stdout=logf, stderr=subprocess.STDOUT,
                                start_new_session=True)


def _wait_healthy(cs: Clientset, timeout: float = 30.0):
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        try:
            cs.client.request("GET", "/healthz")
            return
        except (ApiError, OSError) as e:
            last = e
            time.sleep(0.2)
    raise SystemExit(f"error: apiserver never became healthy: {last}")


def bootstrap_node_credential(server: str, join_token: str, node_name: str,
                              ca_file: str = "",
                              timeout: float = 30.0) -> Tuple[str, str]:
    """The kubelet TLS-bootstrap flow (ref: kubelet certificate bootstrap +
    pkg/controller/certificates): generate a key, submit a PEM CSR as the
    bootstrap identity, wait for auto-approval + signature, and return
    (cert_pem, key_pem) — a real x509 credential for the wire."""
    csr_pem, key_pem = pki.create_csr(
        cn=f"system:node:{node_name}", orgs=["system:nodes"],
        dns_sans=[node_name, "localhost"], ip_sans=["127.0.0.1"])
    bcs = Clientset(server, token=join_token, ca_file=ca_file)
    try:
        csr = t.CertificateSigningRequest()
        # kubeadm-style random suffix: every (re-)join submits a FRESH CSR
        # carrying the new public key, and bootstrappers need no delete
        # grant (a shared join token must not let one holder delete another
        # host's in-flight CSR)
        csr.metadata.name = f"node-csr-{node_name}-{_secrets.token_hex(3)}"
        csr.spec.request = csr_pem
        csr.spec.username = f"system:node:{node_name}"
        csr.spec.groups = ["system:nodes"]
        csr.spec.usages = ["client auth", "server auth"]
        try:
            bcs.certificatesigningrequests.create(csr, "")
        except ApiError as e:
            raise SystemExit(f"error: CSR create failed: {e}")
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                cur = bcs.certificatesigningrequests.get(csr.metadata.name, "")
            except NotFound:
                time.sleep(0.2)
                continue
            if any(c.type == "Denied" for c in cur.status.conditions):
                raise SystemExit(f"error: CSR {csr.metadata.name} was denied")
            if cur.status.certificate:
                return cur.status.certificate, key_pem
            time.sleep(0.2)
        raise SystemExit("error: timed out waiting for the CSR to be signed "
                         "(is the controller-manager running?)")
    finally:
        bcs.close()


def _discover_ca(server: str, ca_cert_hash: str) -> str:
    """kubeadm token discovery: read cluster-info over UNVERIFIED TLS, pin
    the CA against the printed hash, and only then trust it.  NO credential
    rides this connection — cluster-info is anonymous-readable precisely so
    the join token is never exposed to an unverified peer (kubeadm's
    insecure discovery is likewise unauthenticated)."""
    dcs = Clientset(server, insecure=True)
    try:
        info = dcs.configmaps.get("cluster-info", "kube-public")
    except ApiError as e:
        raise SystemExit(f"error: cluster-info discovery failed: {e}")
    finally:
        dcs.close()
    ca_pem = (info.data or {}).get("ca", "")
    if not ca_pem:
        raise SystemExit("error: cluster-info has no CA (server predates TLS?)")
    if ca_cert_hash:
        got = pki.ca_cert_hash(ca_pem)
        if got != ca_cert_hash:
            raise SystemExit(
                f"error: cluster CA hash mismatch: got {got}, "
                f"pinned {ca_cert_hash} — possible MITM, refusing")
    else:
        print("WARNING: no --ca-cert-hash given; the fetched CA is "
              "unauthenticated (kubeadm's unsafe-skip-ca-verification mode)")
    return ca_pem


def init(args) -> int:
    d = os.path.abspath(args.dir)
    port = args.port
    server = f"https://{args.advertise_address}:{port}"

    # ---- preflight (ref kubeadm preflight): re-running init against a live
    # control plane must not clobber pids.json with a dead pid and then
    # trip over the existing fixed-name objects — refuse early instead.
    # Probe BOTH protocols: a live pre-TLS apiserver answers plaintext only
    # (its reply makes the TLS probe raise SSLError, not ConnectionRefused).
    for probe_url in (server, f"http://{args.advertise_address}:{port}"):
        probe = Clientset(probe_url, insecure=True)
        try:
            probe.client.request("GET", "/healthz")
            raise SystemExit(
                f"error: an apiserver is already serving at {probe_url} "
                f"(state in {d}; stop it via pids.json before re-running init)")
        except SystemExit:
            raise
        except (ApiError, OSError, http.client.HTTPException):
            pass  # nothing (or not an apiserver) listening on this proto
        finally:
            probe.close()

    # ---- phase certs (ref certs.go:37 CreatePKIAssets)
    pki_dir = os.path.join(d, "pki")
    ca_cert, ca_key = pki.create_ca("ktpu-ca")
    ca_crt_path, ca_key_path = pki.write_pki(pki_dir, "ca", ca_cert, ca_key)
    apiserver_cert, apiserver_key = pki.issue_cert(
        ca_cert, ca_key, cn="kube-apiserver", server=True,
        dns_sans=["localhost", os.uname().nodename],
        ip_sans=[args.advertise_address, "127.0.0.1"])
    pki.write_pki(pki_dir, "apiserver", apiserver_cert, apiserver_key)
    # component client certs: O=system:masters so RBAC grants are uniform
    # (kubeadm binds per-component roles; one group keeps the flag surface
    # small while every hop still carries a distinct x509 identity)
    component_confs = {}
    for comp, cn in (("admin", "ktpu-admin"),
                     ("controller-manager", "system:kube-controller-manager"),
                     ("scheduler", "system:kube-scheduler")):
        cert, key = pki.issue_cert(ca_cert, ca_key, cn=cn,
                                   orgs=["system:masters"], client=True)
        pki.write_pki(pki_dir, comp, cert, key)
        conf_path = os.path.join(
            d, "admin.conf" if comp == "admin" else f"{comp}.conf")
        _write(conf_path, json.dumps({
            "server": server, "ca": "pki/ca.crt",
            "cert": f"pki/{comp}.crt", "key": f"pki/{comp}.key"}, indent=1))
        component_confs[comp] = conf_path
    sa_key = _secrets.token_hex(32)
    admin_token = _secrets.token_hex(16)
    token_id = _secrets.token_hex(3)
    token_secret = _secrets.token_hex(8)
    join_token = f"{token_id}.{token_secret}"
    _write(os.path.join(pki_dir, "sa.key"), sa_key)
    ca_hash = pki.ca_cert_hash(ca_cert)
    print(f"[certs] cluster CA + serving/client certs under {pki_dir}; "
          f"admin.conf written")

    # ---- phase control-plane (manifests + processes) — HTTPS only
    commands = {
        "apiserver": [
            sys.executable, "-m", "kubernetes1_tpu_torch", "apiserver",
            "--host", args.advertise_address, "--port", str(port),
            "--authorization-mode", "Node,RBAC",
            "--token", admin_token,
            "--tls-cert-file", os.path.join(pki_dir, "apiserver.crt"),
            "--tls-key-file", os.path.join(pki_dir, "apiserver.key"),
            "--client-ca-file", ca_crt_path,
            "--sa-key-file", os.path.join(pki_dir, "sa.key"),
            "--wal", os.path.join(d, "store.wal"),
        ],
        "controller-manager": [
            sys.executable, "-m", "kubernetes1_tpu_torch", "controller-manager",
            "--kubeconfig", component_confs["controller-manager"],
            "--ca-key-file", ca_key_path,
            "--ca-cert-file", ca_crt_path,
            "--sa-key-file", os.path.join(pki_dir, "sa.key"),
        ],
        "scheduler": [
            sys.executable, "-m", "kubernetes1_tpu_torch", "scheduler",
            "--kubeconfig", component_confs["scheduler"],
            # no plain-HTTP /metrics listener beside the TLS ones (the JAX
            # init passes 0, an ephemeral plain-HTTP port)
            "--metrics-port", "-1",
        ],
    }
    pids = {}
    for name in CONTROL_PLANE:
        _write(os.path.join(d, "manifests", f"kube-{name}.json"),
               json.dumps(_manifest(name, commands[name]), indent=1))
        if name != "apiserver":
            continue
        pids[name] = _spawn(commands[name], os.path.join(d, f"{name}.log")).pid
    # record the pid BEFORE waiting: a health-wait failure must leave a
    # kill recipe behind, not an orphaned port-holding apiserver
    _write(os.path.join(d, "pids.json"), json.dumps(pids), mode=0o644)
    cs = Clientset.from_config(component_confs["admin"])
    _wait_healthy(cs)
    for name in ("controller-manager", "scheduler"):
        pids[name] = _spawn(commands[name], os.path.join(d, f"{name}.log")).pid
    _write(os.path.join(d, "pids.json"), json.dumps(pids), mode=0o644)
    print(f"[control-plane] apiserver/scheduler/controller-manager up at "
          f"{server} (TLS; manifests in {d}/manifests)")

    # ---- phase bootstrap token + cluster-info + RBAC
    ttl_s = getattr(args, "token_ttl", 24 * 3600)
    sec = t.Secret(type="bootstrap.kubernetes.io/token", data={
        "token-id": token_id, "token-secret": token_secret,
        "usage-bootstrap-authentication": "true",
        # kubeadm default: join tokens expire (24h) — a console-printed
        # credential must not authenticate forever
        "expiration": to_iso(time.time() + ttl_s),
    })
    sec.metadata.name = f"bootstrap-token-{token_id}"
    cs.secrets.create(sec, "kube-system")
    # cluster-info: the CA a joining host fetches and pins (ref
    # bootstraptoken/clusterinfo; readable without a full credential)
    info = t.ConfigMap(data={"ca": ca_cert, "server": server})
    info.metadata.name = "cluster-info"
    try:
        cs.configmaps.create(info, "kube-public")
    except AlreadyExists:
        pass
    info_role = t.Role()
    info_role.metadata.name = "ktpu:bootstrap-signer-clusterinfo"
    info_role.metadata.namespace = "kube-public"
    info_role.rules = [t.PolicyRule(verbs=["get"], resources=["configmaps"],
                                    resource_names=["cluster-info"])]
    info_rb = t.RoleBinding()
    info_rb.metadata.name = "ktpu:bootstrap-signer-clusterinfo"
    info_rb.metadata.namespace = "kube-public"
    info_rb.subjects = [
        t.Subject(kind="User", name="system:anonymous"),
        t.Subject(kind="Group", name="system:bootstrappers"),
        t.Subject(kind="Group", name="system:unauthenticated"),
    ]
    info_rb.role_ref = t.RoleRef(kind="Role",
                                 name="ktpu:bootstrap-signer-clusterinfo")
    for maker, client in ((info_role, cs.roles), (info_rb, cs.rolebindings)):
        try:
            client.create(maker, "kube-public")
        except AlreadyExists:
            pass
    role = t.ClusterRole()
    role.metadata.name = "system:node-bootstrapper"
    role.rules = [t.PolicyRule(
        verbs=["create", "get", "list", "watch"],
        resources=["certificatesigningrequests"],
    )]
    try:
        cs.clusterroles.create(role, "")
    except AlreadyExists:
        pass  # WAL-backed store survives restarts; fixed names are idempotent
    rb = t.ClusterRoleBinding()
    rb.metadata.name = "ktpu:node-bootstrappers"
    rb.subjects = [t.Subject(kind="Group", name="system:bootstrappers")]
    rb.role_ref = t.RoleRef(kind="ClusterRole", name="system:node-bootstrapper")
    try:
        cs.clusterrolebindings.create(rb, "")
    except AlreadyExists:
        pass
    print(f"[bootstrap-token] join token stored (ttl {ttl_s}s); cluster-info "
          "published; CSR RBAC for system:bootstrappers in place")

    # ---- this host's kubelet via the SAME join flow
    node_name = args.node_name
    cert_pem, key_pem = bootstrap_node_credential(
        server, join_token, node_name, ca_file=ca_crt_path)
    kubelet_crt, kubelet_key = pki.write_pki(pki_dir, "kubelet",
                                             cert_pem, key_pem)
    _write(os.path.join(d, "kubelet.conf"), json.dumps({
        "server": server, "ca": "pki/ca.crt",
        "cert": "pki/kubelet.crt", "key": "pki/kubelet.key"}, indent=1))
    kubelet_cmd = [
        sys.executable, "-m", "kubernetes1_tpu_torch", "kubelet",
        "--kubeconfig", os.path.join(d, "kubelet.conf"),
        "--node-name", node_name,
        "--root-dir", os.path.join(d, "kubelet"),
        "--tls-cert-file", kubelet_crt,
        "--tls-key-file", kubelet_key,
        "--plugin-dir", args.plugin_dir,
    ]
    pids["kubelet"] = _spawn(kubelet_cmd, os.path.join(d, "kubelet.log")).pid
    _write(os.path.join(d, "pids.json"), json.dumps(pids), mode=0o644)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        try:
            if any(c.type == t.NODE_READY and c.status == "True"
                   for c in cs.nodes.get(node_name, "").status.conditions):
                break
        except ApiError:
            pass
        time.sleep(0.3)
    print(f"[kubelet] node {node_name} joined via CSR bootstrap "
          f"(dual-EKU cert: client + :10250 serving)")
    cs.close()

    print()
    print("Your cluster control plane is up (TLS everywhere). To administer:")
    print(f"    export KTPU_KUBECONFIG={component_confs['admin']}")
    print("    ktpu get nodes")
    print()
    print("To add another host, run on it:")
    print(f"    ktpu join --server {server} --token {join_token} "
          f"--ca-cert-hash {ca_hash} --node-name <name>")
    return 0


def join(args) -> int:
    d = os.path.abspath(args.dir)
    node_name = args.node_name
    # ---- discovery: fetch + pin the cluster CA, then go fully verified
    ca_pem = _discover_ca(args.server, getattr(args, "ca_cert_hash", ""))
    pki_dir = os.path.join(d, "pki")
    ca_path, _ = pki.write_pki(pki_dir, "ca", ca_pem)
    cert_pem, key_pem = bootstrap_node_credential(
        args.server, args.token, node_name, ca_file=ca_path)
    kubelet_crt, kubelet_key = pki.write_pki(pki_dir, "kubelet",
                                             cert_pem, key_pem)
    _write(os.path.join(d, "kubelet.conf"), json.dumps({
        "server": args.server, "ca": "pki/ca.crt",
        "cert": "pki/kubelet.crt", "key": "pki/kubelet.key"}, indent=1))
    kubelet_cmd = [
        sys.executable, "-m", "kubernetes1_tpu_torch", "kubelet",
        "--kubeconfig", os.path.join(d, "kubelet.conf"),
        "--node-name", node_name,
        "--root-dir", os.path.join(d, "kubelet"),
        "--tls-cert-file", kubelet_crt,
        "--tls-key-file", kubelet_key,
        "--plugin-dir", args.plugin_dir,
    ]
    pid = _spawn(kubelet_cmd, os.path.join(d, "kubelet.log")).pid
    _write(os.path.join(d, "pids.json"), json.dumps({"kubelet": pid}),
           mode=0o644)
    # confirm the node goes Ready under its CSR-issued x509 identity
    cs = Clientset(args.server, ca_file=ca_path,
                   cert_file=kubelet_crt, key_file=kubelet_key)
    deadline = time.monotonic() + 30
    ready = False
    while time.monotonic() < deadline and not ready:
        try:
            ready = any(c.type == t.NODE_READY and c.status == "True"
                        for c in cs.nodes.get(node_name, "").status.conditions)
        except ApiError:
            pass
        if not ready:
            time.sleep(0.3)
    cs.close()
    if not ready:
        raise SystemExit(f"error: node {node_name} never became Ready "
                         f"(see {d}/kubelet.log)")
    print(f"node {node_name} joined the cluster (kubelet pid {pid}, "
          f"x509 credential in {d}/pki)")
    return 0
