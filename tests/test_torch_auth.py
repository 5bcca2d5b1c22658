"""The port's authentication, authorization and TLS held to the JAX
package's (``apiserver/auth.py``, NodeRestriction, the certificate
controller), over HTTPS with plain urllib, at tolerance 0.

A JAX ``Master`` and the port's, both in ``Node,RBAC`` mode and both HTTPS
only, with the same cluster CA (client certificates optional), the same
static tokens and service-account key, get the same requests under the
same credentials: x509 client certificates (the admin's, alice's, two
nodes'), static tokens, a service account's token and a deleted one's,
bootstrap tokens live and expired, a bogus token and none.  Every status code and body must be
equal after uids, timestamps and the server's created-at stamps are
masked.  The seeded scripts draw Roles, ClusterRoles and their bindings
and ~60 requests each (reads, writes, mirror pods, secret volumes, node
patches, CSRs, SelfSubjectAccessReviews); the fixed cases are
``tests/test_auth.py``'s for what the port has: RBAC, the Node
authorizer, NodeRestriction, CSR immutability, node secret scoping and
the legacy shared-token mode.  The certificate controller of each package
decides seeded CSRs (creators, usernames, groups, x509 subjects that match
or smuggle) in its own cluster; the decisions and the certificates'
identity and usages are equal, but for an approved request that is no
PEM CSR, which the JAX signer answers with its HMAC KTPU-CERT credential
and the port denies (a deviation, both answers asserted).  The streams
ride TLS on both hops: ``ktpu exec`` through the port's HTTPS apiserver
to a port kubelet serving HTTPS.  Deviation, a case with both answers:
over TLS the port's ``upgrade_request`` keeps the frames that arrive with
the 101 head; the JAX one drops them.
"""

import io
import json
import socket
import ssl
import sys
import threading
import time
import urllib.error
import urllib.request
from contextlib import redirect_stdout

import numpy as np
import pytest

from kubernetes1_tpu.apiserver import Master as JaxMaster
from kubernetes1_tpu.client import Clientset as JaxClientset
from kubernetes1_tpu.client import InformerFactory as JaxInformerFactory
from kubernetes1_tpu.controllers.certificates import CertificateController as JaxCSRController
from kubernetes1_tpu.utils import streams as jstreams
from kubernetes1_tpu_torch.api import types as t
from kubernetes1_tpu_torch.apiserver import Master
from kubernetes1_tpu_torch.cli import build_parser, dispatch
from kubernetes1_tpu_torch.cli import CLI
from kubernetes1_tpu_torch.client.clientset import Clientset
from kubernetes1_tpu_torch.controllers.certificates import CertificateController
from kubernetes1_tpu_torch.controllers.serviceaccount import sign_token
from kubernetes1_tpu_torch.kubelet import kubelet as port_kubelet
from kubernetes1_tpu_torch.kubelet.kubelet import Kubelet
from kubernetes1_tpu_torch.kubelet.runtime import ProcessRuntime
from kubernetes1_tpu_torch.utils import pki
from kubernetes1_tpu_torch.utils import streams as tstreams

SA_KEY = "test-sa-key"
STATIC = {"admin-tok": ("system:admin", ["system:masters"]), "alice-tok": ("alice", []),
          "bob-tok": ("bob", ["dev-team"])}
MASKED = "<masked>"
MASK_KEYS = {"uid", "creationTimestamp", "deletionTimestamp", "lastUpdateTime"}
MASK_ANNOTATIONS = {"slo.ktpu.io/created-at", "slo.ktpu.io/bound-at"}
SEEDS = range(8)
CERTS = {  # name -> (CN, O)
    "admin": ("ktpu-admin", ["system:masters"]),
    "alice": ("alice", ["dev-team"]),
    "node1": ("system:node:n1", ["system:nodes"]),
    "node2": ("system:node:n2", ["system:nodes"]),
}
CREDS = ["admin", "alice", "node1", "node2", "admin-tok", "alice-tok", "bob-tok", "sa",
         "sa-gone", "boot", "boot-expired", "bogus", "anonymous"]


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
    if isinstance(x, list):
        return [_mask(v) for v in x]
    return x


@pytest.fixture(scope="module")
def pki_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("pki")
    ca_cert, ca_key = pki.create_ca("ktpu-ca")
    pki.write_pki(str(d), "ca", ca_cert, ca_key)
    pki.write_pki(str(d), "apiserver", *pki.issue_cert(
        ca_cert, ca_key, cn="kube-apiserver", server=True, dns_sans=["localhost"],
        ip_sans=["127.0.0.1"]))
    for name, (cn, orgs) in CERTS.items():
        pki.write_pki(str(d), name, *pki.issue_cert(ca_cert, ca_key, cn=cn, orgs=orgs,
                                                    client=True, server=name.startswith("node"),
                                                    ip_sans=["127.0.0.1"]))
    return d


def _master_kw(d, **kw):
    return dict(authorization_mode="Node,RBAC", static_tokens=dict(STATIC),
                sa_signing_key=SA_KEY,
                tls_cert_file=str(d / "apiserver.crt"), tls_key_file=str(d / "apiserver.key"),
                client_ca_file=str(d / "ca.crt"), **kw)


class Side:
    """One package's HTTPS apiserver and the credentials' clients of it."""

    def __init__(self, name, master, d):
        self.name, self.master, self.d = name, master, d
        self.url = master.url
        self.tokens = {"admin-tok": "admin-tok", "alice-tok": "alice-tok",
                       "bob-tok": "bob-tok", "bogus": "not-a-token"}
        self._ctx = {}

    def ctx(self, cred):
        if cred not in self._ctx:
            c = ssl.create_default_context(cafile=str(self.d / "ca.crt"))
            if cred in CERTS:
                c.load_cert_chain(str(self.d / f"{cred}.crt"), str(self.d / f"{cred}.key"))
            self._ctx[cred] = c
        return self._ctx[cred]

    def call(self, cred, method, path, body=None):
        """(status, masked JSON body or text) of one request."""
        headers = {"Content-Type": "application/json"}
        if cred in self.tokens:
            headers["Authorization"] = f"Bearer {self.tokens[cred]}"
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(self.url + path, data=data, method=method, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=30, context=self.ctx(cred)) as r:
                code, payload = r.status, r.read()
        except urllib.error.HTTPError as e:
            code, payload = e.code, e.read()
        try:
            return code, _mask(json.loads(payload))
        except ValueError:
            return code, payload.decode(errors="replace")


def _secret(name, ns="default", **kw):
    return {"kind": "Secret", "apiVersion": "v1", "metadata": {"name": name, "namespace": ns},
            **kw}


def _pod(name, node="", mirror=False, secret="", sa="", ns="default"):
    meta = {"name": name, "namespace": ns}
    if mirror:
        meta["annotations"] = {"kubelet.ktpu.io/static": "true"}
    spec = {"containers": [{"name": "c", "image": "busybox", "command": ["sleep", "1"]}]}
    if node:
        spec["nodeName"] = node
    if secret:
        spec["volumes"] = [{"name": "v", "secret": {"secretName": secret}}]
    if sa:
        spec["serviceAccountName"] = sa
    return {"kind": "Pod", "apiVersion": "v1", "metadata": meta, "spec": spec}


def _setup(side):
    """The objects every script starts from, written by the admin."""
    V1 = "/api/v1"
    future, past = "2999-01-01T00:00:00Z", "2001-01-01T00:00:00Z"
    for path, body in [
        (f"{V1}/namespaces", {"kind": "Namespace", "metadata": {"name": "team-a"}}),
        (f"{V1}/nodes", {"kind": "Node", "metadata": {"name": "n1"}}),
        (f"{V1}/nodes", {"kind": "Node", "metadata": {"name": "n2"}}),
        (f"{V1}/namespaces/default/secrets", _secret("mounted", data={"k": "m"})),
        (f"{V1}/namespaces/default/secrets", _secret("unrelated", data={"k": "u"})),
        (f"{V1}/namespaces/default/configmaps",
         {"kind": "ConfigMap", "metadata": {"name": "cm-mounted"}, "data": {"a": "1"}}),
        (f"{V1}/namespaces/default/pods", _pod("on-n1", "n1", secret="mounted")),
        (f"{V1}/namespaces/default/pods", _pod("on-n2", "n2")),
        (f"{V1}/namespaces/team-a/pods", _pod("team-pod", "n1", ns="team-a")),
        (f"{V1}/namespaces/default/serviceaccounts",
         {"kind": "ServiceAccount", "metadata": {"name": "builder"}}),
        (f"{V1}/namespaces/default/serviceaccounts",
         {"kind": "ServiceAccount", "metadata": {"name": "gone"}}),
        (f"{V1}/namespaces/kube-system/secrets", _secret(
            "bootstrap-token-abcdef", "kube-system", type="bootstrap.kubernetes.io/token",
            data={"token-id": "abcdef", "token-secret": "0123456789abcdef",
                  "usage-bootstrap-authentication": "true", "expiration": future})),
        (f"{V1}/namespaces/kube-system/secrets", _secret(
            "bootstrap-token-old000", "kube-system", type="bootstrap.kubernetes.io/token",
            data={"token-id": "old000", "token-secret": "0123456789abcdef",
                  "usage-bootstrap-authentication": "true", "expiration": past})),
        (f"{V1}/namespaces/kube-public/configmaps",
         {"kind": "ConfigMap", "metadata": {"name": "cluster-info"}, "data": {"ca": "x"}}),
    ]:
        code, out = side.call("admin", "POST", path, body)
        assert code == 201, (side.name, path, out)
    for sa in ("builder", "gone"):
        uid = side.master.registry.get("serviceaccounts", "default", sa).metadata.uid
        side.tokens["sa" if sa == "builder" else "sa-gone"] = sign_token(SA_KEY, "default", sa,
                                                                         uid)
    assert side.call("admin", "DELETE", f"{V1}/namespaces/default/serviceaccounts/gone")[0] == 200
    side.tokens["boot"] = "abcdef.0123456789abcdef"
    side.tokens["boot-expired"] = "old000.0123456789abcdef"


@pytest.fixture()
def sides(pki_dir):
    jm = JaxMaster(port=0, event_loop_serving=False, **_master_kw(pki_dir)).start()
    pm = Master(port=0, **_master_kw(pki_dir)).start()
    out = {"jax": Side("jax", jm, pki_dir), "torch": Side("torch", pm, pki_dir)}
    try:
        for side in out.values():
            _setup(side)
        yield out
    finally:
        jm.stop()
        pm.stop()


def both(sides, script):
    """Run ``[(cred, method, path, body)]`` on both; assert every answer
    equal and return the port's."""
    got = {name: [side.call(*step) for step in script] for name, side in sides.items()}
    for step, j, p in zip(script, got["jax"], got["torch"]):
        assert p == j, f"{step}: the port answered {p}, JAX {j}"
    return got["torch"]


RBAC = "/apis/rbac/v1"
RESOURCES = ["pods", "secrets", "configmaps", "nodes", "pods/log", "*", "services",
             "certificatesigningrequests"]
VERBS = ["get", "list", "watch", "create", "update", "patch", "delete", "*"]
SUBJECTS = [{"kind": "User", "name": "alice"}, {"kind": "Group", "name": "dev-team"},
            {"kind": "ServiceAccount", "name": "builder", "namespace": "default"},
            {"kind": "ServiceAccount", "name": "gone", "namespace": "default"},
            {"kind": "Group", "name": "system:bootstrappers"},
            {"kind": "User", "name": "system:anonymous"},
            {"kind": "Group", "name": "system:unauthenticated"},
            {"kind": "User", "name": "bob"}]


def _rules(rng):
    rules = []
    for _ in range(rng.integers(1, 3)):
        rule = {"verbs": sorted(rng.choice(VERBS, rng.integers(1, 4), replace=False).tolist()),
                "resources": sorted(rng.choice(RESOURCES, rng.integers(1, 3),
                                               replace=False).tolist())}
        if rng.random() < 0.3:
            rule["resourceNames"] = [["on-n1", "mounted", "cm-mounted", "n1"][rng.integers(4)]]
        rules.append(rule)
    return rules


def _rbac_script(rng):
    script = []
    for i in range(rng.integers(2, 5)):
        ns = ["default", "team-a"][rng.integers(2)]
        script.append(("admin", "POST", f"{RBAC}/namespaces/{ns}/roles",
                       {"kind": "Role", "metadata": {"name": f"r{i}"}, "rules": _rules(rng)}))
        script.append(("admin", "POST", f"{RBAC}/clusterroles",
                       {"kind": "ClusterRole", "metadata": {"name": f"cr{i}"},
                        "rules": _rules(rng)}))
        subjects = [SUBJECTS[j] for j in rng.choice(len(SUBJECTS), rng.integers(1, 3),
                                                    replace=False)]
        if rng.random() < 0.5:
            script.append(("admin", "POST", f"{RBAC}/namespaces/{ns}/rolebindings",
                           {"kind": "RoleBinding", "metadata": {"name": f"rb{i}"},
                            "subjects": subjects,
                            "roleRef": {"kind": ["Role", "ClusterRole"][rng.integers(2)],
                                        "name": [f"r{i}", f"cr{i}"][rng.integers(2)]}}))
        else:
            script.append(("admin", "POST", f"{RBAC}/clusterrolebindings",
                           {"kind": "ClusterRoleBinding", "metadata": {"name": f"crb{i}"},
                            "subjects": subjects,
                            "roleRef": {"kind": "ClusterRole", "name": f"cr{i}"}}))
    return script


def _request(rng, i):
    """One random request under one random credential."""
    cred = CREDS[rng.integers(len(CREDS))]
    ns = ["default", "team-a", "kube-system"][rng.integers(3)]
    pod = ["on-n1", "on-n2", "ghost", f"made-{i}"][rng.integers(4)]
    node = ["n1", "n2", "n3"][rng.integers(3)]
    D = f"/api/v1/namespaces/{ns}"
    k = rng.integers(16)
    if k == 0:
        return cred, "GET", f"{D}/pods", None
    if k == 1:
        return cred, "GET", f"/api/v1/namespaces/default/pods/{pod}", None
    if k == 2:
        return cred, "POST", "/api/v1/namespaces/default/pods", _pod(
            f"made-{i}", ["", "n1", "n2"][rng.integers(3)], mirror=rng.random() < 0.6,
            secret=["", "mounted"][rng.integers(2)], sa=["", "builder"][rng.integers(2)])
    if k == 3:
        return cred, "DELETE", f"/api/v1/namespaces/default/pods/{pod}", None
    if k == 4:
        return cred, "GET", f"/api/v1/namespaces/default/secrets/" \
                            f"{['mounted', 'unrelated'][rng.integers(2)]}", None
    if k == 5:
        return cred, "GET", f"{D}/secrets", None
    if k == 6:
        return cred, "GET", "/api/v1/namespaces/default/configmaps/cm-mounted", None
    if k == 7:
        return cred, "PATCH", f"/api/v1/nodes/{node}", {"metadata": {"labels": {"i": str(i)}}}
    if k == 8:
        return cred, "PATCH", f"/api/v1/nodes/{node}/status", {
            "status": {"capacity": {"cpu": str(i)}}}
    if k == 9:
        return cred, "POST", "/api/v1/nodes", {"kind": "Node", "metadata": {"name": node}}
    if k == 10:
        return cred, "POST", "/apis/certificates/v1/certificatesigningrequests", {
            "kind": "CertificateSigningRequest", "metadata": {"name": f"csr-{i}"},
            "spec": {"request": "r", "username": f"system:node:{node}",
                     "groups": ["system:nodes"]}}
    if k == 11:
        return cred, "GET", "/api/v1/namespaces/kube-public/configmaps/cluster-info", None
    if k == 12:
        return cred, "POST", "/apis/authorization.k8s.io/v1/selfsubjectaccessreviews", {
            "spec": {"resourceAttributes": {
                "verb": VERBS[rng.integers(len(VERBS) - 1)],
                "resource": RESOURCES[rng.integers(len(RESOURCES))].split("/")[0],
                "namespace": ns, "name": ["", "on-n1"][rng.integers(2)],
                "subresource": ["", "status", "log"][rng.integers(3)]}}}
    if k == 13:
        return cred, "PATCH", f"/api/v1/namespaces/default/pods/{pod}", {
            "spec": {"volumes": [{"name": "v", "secret": {"secretName": "unrelated"}}]}}
    if k == 14:
        return cred, "PUT", f"/api/v1/namespaces/default/pods/{pod}/status", {
            "kind": "Pod", "metadata": {"name": pod, "namespace": "default"},
            "status": {"phase": "Running"}}
    return cred, "GET", "/api/v1/nodes", None


@pytest.mark.parametrize("seed", SEEDS)
def test_seeded_request_scripts_answer_as_the_jax_apiserver(sides, seed):
    rng = np.random.default_rng(seed)
    script = _rbac_script(rng) + [_request(rng, i) for i in range(60)]
    answers = both(sides, script)
    codes = {c for c, _ in answers}
    assert {200, 403} <= codes and 401 in codes  # the script reaches allow, deny and bad creds


def test_authentication_outcomes(sides):
    P = "/api/v1/namespaces/default/pods"
    got = both(sides, [(cred, "GET", P, None) for cred in CREDS])
    codes = dict(zip(CREDS, (c for c, _ in got)))
    assert codes == {"admin": 200, "alice": 403, "node1": 200, "node2": 200, "admin-tok": 200,
                     "alice-tok": 403, "bob-tok": 403, "sa": 403, "sa-gone": 401, "boot": 403,
                     "boot-expired": 401, "bogus": 401, "anonymous": 403}
    assert "system:serviceaccount:default:builder" in got[CREDS.index("sa")][1]["message"]
    assert "system:bootstrap:abcdef" in got[CREDS.index("boot")][1]["message"]
    assert "system:anonymous" in got[CREDS.index("anonymous")][1]["message"]
    # the port counts its refusals by credential class on /metrics, which
    # anonymous may read (the JAX apiserver counts none)
    code, text = sides["torch"].call("anonymous", "GET", "/metrics")
    denied = [line for line in text.splitlines()
              if line.startswith("ktpu_apiserver_authz_denied_total{")]
    assert code == 200 and denied == [  # other: alice's certificate and token, bob's token
        f'ktpu_apiserver_authz_denied_total{{credential="{c}"}} {n}' for c, n in
        (("anonymous", 1), ("bootstrap", 1), ("node", 0), ("serviceaccount", 1), ("other", 3))]
    assert "alice" not in text and "builder" not in text and "abcdef" not in text


def test_rbac_bindings_grant_and_scope(sides):
    """tests/test_auth.py's TestRBAC: a Role in one namespace, a
    ClusterRole to a group, resourceNames."""
    D = "/api/v1/namespaces/default"
    got = both(sides, [
        ("admin", "POST", f"{RBAC}/namespaces/default/roles",
         {"kind": "Role", "metadata": {"name": "pod-worker"},
          "rules": [{"verbs": ["get", "list", "create"], "resources": ["pods"]},
                    {"verbs": ["get"], "resources": ["secrets"], "resourceNames": ["mounted"]}]}),
        ("admin", "POST", f"{RBAC}/namespaces/default/rolebindings",
         {"kind": "RoleBinding", "metadata": {"name": "alice-pods"},
          "subjects": [{"kind": "User", "name": "alice"}],
          "roleRef": {"kind": "Role", "name": "pod-worker"}}),
        ("admin", "POST", f"{RBAC}/clusterroles",
         {"kind": "ClusterRole", "metadata": {"name": "node-admin"},
          "rules": [{"verbs": ["*"], "resources": ["nodes"]}]}),
        ("admin", "POST", f"{RBAC}/clusterrolebindings",
         {"kind": "ClusterRoleBinding", "metadata": {"name": "devs-nodes"},
          "subjects": [{"kind": "Group", "name": "dev-team"}],
          "roleRef": {"kind": "ClusterRole", "name": "node-admin"}}),
        ("alice-tok", "POST", f"{D}/pods", _pod("mine")),
        ("alice-tok", "GET", f"{D}/pods/mine", None),
        ("alice-tok", "DELETE", f"{D}/pods/mine", None),
        ("alice-tok", "GET", "/api/v1/namespaces/kube-system/pods", None),
        ("alice-tok", "GET", f"{D}/secrets/mounted", None),
        ("alice-tok", "GET", f"{D}/secrets/unrelated", None),
        ("alice-tok", "GET", f"{D}/pods/on-n1/log", None),
        ("bob-tok", "GET", "/api/v1/nodes", None),
        ("bob-tok", "GET", f"{D}/pods", None),
        ("alice", "GET", "/api/v1/nodes", None),
    ])
    assert [c for c, _ in got[4:]] == [201, 200, 403, 403, 200, 403, 403, 200, 403, 200]


def test_node_authorizer_and_node_restriction(sides):
    """tests/test_auth.py's TestNodeAuthorizer, TestNodeRestriction and
    TestNodeSecretsScoping, under an x509 node certificate."""
    D = "/api/v1/namespaces/default"
    got = both(sides, [
        ("node1", "PATCH", "/api/v1/nodes/n1/status", {"status": {"capacity": {"cpu": "8"}}}),
        ("node1", "PATCH", "/api/v1/nodes/n2/status", {"status": {"capacity": {"cpu": "8"}}}),
        ("node1", "PUT", f"{D}/pods/on-n1/status", {"kind": "Pod", "metadata": {
            "name": "on-n1", "namespace": "default"}, "status": {"phase": "Running"}}),
        ("node1", "PUT", f"{D}/pods/on-n2/status", {"kind": "Pod", "metadata": {
            "name": "on-n2", "namespace": "default"}, "status": {"phase": "Running"}}),
        ("node1", "POST", f"{D}/pods", _pod("evil", "n1", mirror=True, secret="unrelated")),
        ("node1", "POST", f"{D}/pods", _pod("not-mirror", "n1")),
        ("node1", "POST", f"{D}/pods", _pod("foreign", "n2", mirror=True)),
        ("node1", "POST", f"{D}/pods", _pod("mirror-ok", "n1", mirror=True)),
        ("node1", "PATCH", f"{D}/pods/mirror-ok", {"spec": {"volumes": [
            {"name": "v", "secret": {"secretName": "unrelated"}}]}}),
        ("node1", "GET", f"{D}/secrets/mounted", None),
        ("node1", "GET", f"{D}/secrets/unrelated", None),
        ("node1", "GET", f"{D}/secrets", None),
        ("node1", "POST", "/api/v1/nodes", {"kind": "Node", "metadata": {"name": "n9"}}),
        ("node2", "POST", "/api/v1/nodes", {"kind": "Node", "metadata": {"name": "n2x"}}),
        ("node1", "POST", "/api/v1/namespaces/kube-system/secrets",
         _secret("kubelet-token-n1", "kube-system", data={"token": "t"})),
        ("node1", "POST", "/api/v1/namespaces/kube-system/secrets",
         _secret("kubelet-token-n2", "kube-system", data={"token": "t"})),
        ("node1", "GET", "/api/v1/namespaces/kube-system/secrets/kubelet-token-n1", None),
        ("node1", "POST", f"{D}/events", {"kind": "Event", "metadata": {"name": "e1"},
                                          "involvedObject": {"kind": "Pod", "name": "on-n1"},
                                          "reason": "Started"}),
        ("node1", "GET", f"{D}/events/e1", None),
        ("node1", "GET", "/api/v1/pods?fieldSelector=spec.nodeName%3Dn1", None),
    ])
    assert [c for c, _ in got] == [200, 403, 200, 403, 403, 403, 403, 201, 403, 200, 403, 403,
                                   403, 403, 201, 403, 403, 201, 403, 200]
    assert "may not reference secrets" in got[4][1]["message"]
    assert "mirror" in got[5][1]["message"] and "bound to itself" in got[6][1]["message"]
    assert "its own Node" in got[12][1]["message"]


def test_csr_spec_and_creator_are_frozen_after_create(sides):
    """tests/test_auth.py's TestCSRImmutability; and the creator stamped
    server-side (TestCSRImpersonation's first half)."""
    C = "/apis/certificates/v1/certificatesigningrequests"
    csr = {"kind": "CertificateSigningRequest", "metadata": {"name": "frozen"},
           "spec": {"request": "r", "username": "system:node:n1", "groups": ["system:nodes"]}}
    got = both(sides, [
        ("node1", "POST", C, csr),
        ("admin", "PUT", f"{C}/frozen", {**csr, "spec": {**csr["spec"],
                                                         "username": "system:node:other"},
                                         "metadata": {"name": "frozen", "annotations": {
                                             "ktpu.io/created-by": "system:node:other"}}}),
        ("admin", "PATCH", f"{C}/frozen", {"spec": {"username": "x"}, "metadata": {
            "annotations": {"ktpu.io/created-by": "hacker"}}}),
    ])
    for _code, body in got:
        assert body["spec"]["username"] == "system:node:n1"
        assert body["metadata"]["annotations"]["ktpu.io/created-by"] == "system:node:n1"


def test_legacy_shared_token_mode(pki_dir):
    """tests/test_auth.py's TestLegacyTokenMode: AlwaysAllow with a token,
    which (or a verified client certificate) is the admin."""
    kw = _master_kw(pki_dir, token="legacy-tok")
    kw.update(authorization_mode="AlwaysAllow", static_tokens=None)
    jm = JaxMaster(port=0, event_loop_serving=False, **kw).start()
    pm = Master(port=0, **kw).start()
    try:
        sides = {"jax": Side("jax", jm, pki_dir), "torch": Side("torch", pm, pki_dir)}
        for side in sides.values():
            side.tokens = {"legacy": "legacy-tok", "bogus": "nope"}
        P = "/api/v1/namespaces/default/pods"
        got = both(sides, [("legacy", "GET", P, None), ("bogus", "GET", P, None),
                           ("anonymous", "GET", P, None), ("alice", "GET", P, None),
                           ("legacy", "POST", P, _pod("p")),
                           ("alice", "POST", "/apis/authorization.k8s.io/v1/"
                                             "selfsubjectaccessreviews",
                            {"spec": {"resourceAttributes": {"verb": "delete",
                                                             "resource": "nodes"}}})])
        assert [c for c, _ in got] == [200, 401, 401, 200, 201, 201]
        assert got[5][1]["status"] == {"allowed": True}
    finally:
        jm.stop()
        pm.stop()


def test_no_security_option_serves_every_request_as_the_admin():
    pm = Master(port=0).start()
    try:
        with urllib.request.urlopen(urllib.request.Request(
                pm.url + "/apis/authorization.k8s.io/v1/selfsubjectaccessreviews",
                data=b'{"spec":{"resourceAttributes":{"verb":"delete","resource":"nodes"}}}',
                method="POST"), timeout=10) as r:
            assert json.loads(r.read())["status"] == {"allowed": True}
        assert pm.url.startswith("http://")
    finally:
        pm.stop()


def test_https_serves_no_plain_http(sides):
    import http.client

    for side in sides.values():
        port = int(side.url.rsplit(":", 1)[1])
        assert side.url.startswith("https://")
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
        with pytest.raises((OSError, http.client.HTTPException)):
            conn.request("GET", "/healthz")
            conn.getresponse().read()
        conn.close()
        assert side.call("anonymous", "GET", "/healthz") == (200, {"status": "ok"})


# ---------------------------------------------------------------- CSR signer


def _csr_cases(rng, ca_cert):
    """[(creator credential, name, spec)] of seeded CSRs, after two fixed
    ones: a node renewing its own identity, and one smuggling an admin
    subject past the approver."""
    cases = [("node1", "csr-own", {
        "request": pki.create_csr("system:node:n1", ["system:nodes"])[0],
        "username": "system:node:n1", "groups": ["system:nodes"],
        "usages": ["client auth", "server auth"]}),
        ("boot", "csr-smuggled", {
            "request": pki.create_csr("system:admin", ["system:nodes"])[0],
            "username": "system:node:n2", "groups": ["system:nodes"],
            "usages": ["client auth"]})]
    for i in range(10):
        username = ["system:node:n1", "system:node:n2", "alice"][rng.integers(3)]
        groups = [["system:nodes"], ["system:nodes", "system:masters"], []][rng.integers(3)]
        kind = rng.integers(3)
        if kind == 0:
            request = f"opaque-{i}"
        else:
            cn = username if kind == 1 else "system:admin"  # 2: a smuggled subject
            request = pki.create_csr(cn, groups, dns_sans=["n"], ip_sans=["127.0.0.1"])[0]
        usages = [["client auth"], ["client auth", "server auth"], []][rng.integers(3)]
        cred = ["admin", "node1", "boot", "alice"][rng.integers(4)]
        cases.append((cred, f"csr-{i}", {"request": request, "username": username,
                                         "groups": groups, "usages": usages}))
    return cases


def _decision(csr: dict) -> dict:
    st = csr.get("status") or {}
    cert = st.get("certificate", "")
    if cert.startswith("-----BEGIN CERTIFICATE"):
        from cryptography import x509

        c = x509.load_pem_x509_certificate(cert.encode())
        eku = [e.value for e in c.extensions if type(e.value).__name__ == "ExtendedKeyUsage"]
        cert = ("x509", pki.cert_identity(cert),
                sorted(o.dotted_string for o in eku[0]) if eku else [])
    return {"conditions": [(c["type"], c.get("reason"), c.get("message"))
                           for c in st.get("conditions") or []], "certificate": cert}


@pytest.mark.parametrize("seed", range(4))
def test_certificate_controller_decides_as_the_jax_one(sides, pki_dir, seed):
    """Each package's controller, over its own clientset and informers,
    syncs the same seeded CSRs once each: approvals, denials (a smuggled
    subject), the certificates' identities and usages are equal.  An
    approved request that is no PEM CSR is the deviation: the JAX signer
    issues its HMAC KTPU-CERT credential, the port denies it."""
    rng = np.random.default_rng(seed)
    ca_cert = (pki_dir / "ca.crt").read_text()
    ca_key = (pki_dir / "ca.key").read_text()
    cases = _csr_cases(rng, ca_cert)
    C = "/apis/certificates/v1/certificatesigningrequests"
    both(sides, [("admin", "POST", f"{RBAC}/clusterroles",
                  {"kind": "ClusterRole", "metadata": {"name": "csr-maker"},
                   "rules": [{"verbs": ["create", "get"],
                              "resources": ["certificatesigningrequests"]}]}),
                 ("admin", "POST", f"{RBAC}/clusterrolebindings",
                  {"kind": "ClusterRoleBinding", "metadata": {"name": "csr-makers"},
                   "subjects": [{"kind": "Group", "name": "system:bootstrappers"},
                                {"kind": "User", "name": "alice"}],
                   "roleRef": {"kind": "ClusterRole", "name": "csr-maker"}})]
         + [(cred, "POST", C, {"kind": "CertificateSigningRequest", "metadata": {"name": name},
                               "spec": spec}) for cred, name, spec in cases])
    files = dict(ca_file=str(pki_dir / "ca.crt"), cert_file=str(pki_dir / "admin.crt"),
                 key_file=str(pki_dir / "admin.key"))
    decisions = {}
    for name, side in sides.items():
        if name == "jax":
            cs = JaxClientset(side.url, **files)
            factory = JaxInformerFactory(cs)
            ctl = JaxCSRController(cs, factory, ca_key=ca_key, ca_cert_pem=ca_cert)
        else:
            cs = Clientset(side.url, **files)
            factory = cs.informers()
            ctl = CertificateController(cs, factory, ca_key=ca_key, ca_cert_pem=ca_cert)
        ctl.setup()
        factory.start_all()
        factory.wait_for_sync()
        try:
            deadline = time.monotonic() + 10
            while len(ctl.csrs.list()) < len(cases) and time.monotonic() < deadline:
                time.sleep(0.05)
            for _cred, csr_name, _spec in cases:
                ctl.sync(csr_name)
        finally:
            factory.stop_all()
            cs.close()
        decisions[name] = {n: _decision(side.call("admin", "GET", f"{C}/{n}")[1])
                           for _c, n, _s in cases}
    opaque = {n for _c, n, spec in cases if not spec["request"].startswith("-----BEGIN")}
    deviations = 0
    for n in decisions["jax"]:
        j, p = decisions["jax"][n], decisions["torch"][n]
        if n in opaque and j["certificate"].startswith("KTPU-CERT."):
            deviations += 1
            assert p == {"conditions": j["conditions"] + [(
                "Denied", "NotACertificateRequest",
                "spec.request is not a PEM certificate signing request")], "certificate": ""}
        else:
            assert p == j, n
    assert deviations == sum(1 for n in opaque if ("Approved", "AutoApproved", "node client "
                             "certificate") in decisions["jax"][n]["conditions"])
    own, smuggled = decisions["torch"]["csr-own"], decisions["torch"]["csr-smuggled"]
    assert own["certificate"][:2] == ("x509", ("system:node:n1", ["system:nodes"]))
    assert [c[:2] for c in smuggled["conditions"]] == [("Approved", "AutoApproved"),
                                                       ("Denied", "SubjectMismatch")]


# ------------------------------------------------------------ TLS streams


@pytest.fixture()
def tls_node(pki_dir, tmp_path, monkeypatch):
    """The port's HTTPS apiserver, a port kubelet for n1 serving HTTPS on
    the node certificate, and a pod running on it: (master, admin
    clientset, node clientset, kubelet)."""
    monkeypatch.setattr(port_kubelet, "default_signals", lambda: {})
    master = Master(port=0, **_master_kw(pki_dir)).start()
    files = {name: dict(ca_file=str(pki_dir / "ca.crt"), cert_file=str(pki_dir / f"{name}.crt"),
                        key_file=str(pki_dir / f"{name}.key")) for name in ("admin", "node1")}
    admin = Clientset(master.url, **files["admin"])
    node_cs = Clientset(master.url, **files["node1"])
    kl = Kubelet(node_cs, "n1", ProcessRuntime(root_dir=str(tmp_path / "root")),
                 plugin_dir=str(tmp_path / "plugins"), heartbeat_interval=0.5,
                 server_tls_cert_file=str(pki_dir / "node1.crt"),
                 server_tls_key_file=str(pki_dir / "node1.key"))
    kl.start()
    try:
        assert kl.server.url.startswith("https://")
        pod = t.Pod()
        pod.metadata.name = "tls-exec"
        pod.spec.node_name = "n1"
        pod.spec.containers = [t.Container(name="c", image="python", command=[
            sys.executable, "-c", "import time; print('up', flush=True); time.sleep(60)"])]
        admin.pods.create(pod)
        deadline = time.monotonic() + 30
        while admin.pods.get("tls-exec").status.phase != "Running":
            assert time.monotonic() < deadline, "the pod never ran"
            time.sleep(0.1)
        yield master, admin, node_cs, kl
    finally:
        kl.stop()
        kl.runtime.kill_all()
        admin.close()
        node_cs.close()
        master.stop()


def _exec(master, pki_dir, cred, command):
    """``ktpu exec tls-exec -- <command>`` under an x509 credential: its
    stdout, or the OSError of a refused stream."""
    out = io.StringIO()
    args = build_parser().parse_args([
        "--ca-file", str(pki_dir / "ca.crt"), "--client-cert-file", str(pki_dir / f"{cred}.crt"),
        "--client-key-file", str(pki_dir / f"{cred}.key"), "exec", "tls-exec", "--", *command])
    cs = Clientset(master.url, ca_file=args.ca_file, cert_file=args.client_cert_file,
                   key_file=args.client_key_file)
    try:
        with redirect_stdout(out):
            dispatch(CLI(master.url, "default", out=out, clientset=cs), args)
    except OSError as e:
        return e
    finally:
        cs.close()
    return out.getvalue()


def test_exec_over_tls_on_both_hops(tls_node, pki_dir):
    """``ktpu exec`` with a client certificate to the port's HTTPS
    apiserver, which dials the kubelet's HTTPS server and verifies it
    against the cluster CA; the log proxy rides the same hop.  The node's
    certificate may not exec (the Node authorizer)."""
    master, admin, _node, _kl = tls_node
    assert "over-tls" in _exec(master, pki_dir, "admin", ["echo", "over-tls"])
    assert "up" in admin.client.pod_log("tls-exec")
    refused = _exec(master, pki_dir, "node1", ["true"])
    assert isinstance(refused, OSError) and "403" in str(refused)


def test_rbac_denies_exec_without_the_subresource_grant(tls_node, pki_dir):
    """tests/test_streaming.py's TestSecurity case: a Role granting get and
    list on pods does not grant pods/exec; granting the subresource opens
    it."""
    master, admin, _node, _kl = tls_node
    role = t.Role(rules=[t.PolicyRule(verbs=["get", "list"], resources=["pods"])])
    role.metadata.name, role.metadata.namespace = "viewer", "default"
    role = admin.roles.create(role)
    rb = t.RoleBinding(subjects=[t.Subject(kind="User", name="alice")],
                       role_ref=t.RoleRef(kind="Role", name="viewer"))
    rb.metadata.name, rb.metadata.namespace = "viewer-b", "default"
    admin.rolebindings.create(rb)
    refused = _exec(master, pki_dir, "alice", [sys.executable, "-c", "print(1)"])
    assert isinstance(refused, OSError) and "403" in str(refused)
    role.rules.append(t.PolicyRule(verbs=["get"], resources=["pods/exec"]))
    admin.roles.update(role)
    assert _exec(master, pki_dir, "alice", [sys.executable, "-c", "print(1)"]).strip() == "1"


def test_the_kubelet_passes_the_node_authorizer(tls_node):
    """The port's kubelet under its node certificate: its periodic check
    of its token secret (a create, where the JAX kubelet's GET is refused)
    and its event recorder's repeat count (a merge patch, where the JAX
    recorder's GET is refused) draw no refusal, and a deleted token
    secret comes back."""
    master, admin, _node, kl = tls_node
    kl._beats = kl.TOKEN_RECHECK_BEATS - 1
    kl._heartbeat()
    admin.secrets.delete("kubelet-token-n1", "kube-system")
    kl._beats = kl.TOKEN_RECHECK_BEATS - 1
    kl._heartbeat()
    assert admin.secrets.get("kubelet-token-n1", "kube-system").data["token"] == kl.server_token
    pod = admin.pods.get("tls-exec")
    for _ in range(3):
        kl.recorder.event(pod, "Warning", "Probe", "the same message")
    kl.recorder.flush()
    probes = [e for e in admin.events.list("default")[0] if e.reason == "Probe"]
    assert [e.count for e in probes] == [3]
    metrics = admin.client.request("GET", "/metrics", raw=True).decode()
    assert 'ktpu_apiserver_authz_denied_total{credential="node"} 0' in metrics


def test_the_tls_head_read_keeps_the_frames_after_the_101(pki_dir):
    """Deviation: a server that writes its 101 head and a status frame in
    one TLS record.  The port's ``upgrade_request`` hands the frame to the
    stream; the JAX one reads 4 KiB at once and drops it (its next read
    finds nothing)."""
    sctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    sctx.load_cert_chain(str(pki_dir / "apiserver.crt"), str(pki_dir / "apiserver.key"))
    cctx = ssl.create_default_context(cafile=str(pki_dir / "ca.crt"))
    listener = socket.create_server(("127.0.0.1", 0))
    frame = b"\x03" + len(b'{"exitCode": 0}').to_bytes(4, "big") + b'{"exitCode": 0}'

    def serve(n):
        for _ in range(n):
            conn, _ = listener.accept()
            with sctx.wrap_socket(conn, server_side=True) as tls:
                head = b""
                while b"\r\n\r\n" not in head:
                    head += tls.recv(1024)
                tls.sendall(b"HTTP/1.1 101 Switching Protocols\r\nUpgrade: ktpu-stream\r\n"
                            b"Connection: Upgrade\r\n\r\n" + frame)
                time.sleep(1.5)

    th = threading.Thread(target=serve, args=(2,), daemon=True)
    th.start()
    port = listener.getsockname()[1]
    try:
        got = {}
        for name, mod in (("torch", tstreams), ("jax", jstreams)):
            sock = mod.upgrade_request("127.0.0.1", port, "/exec", {}, ssl_context=cctx)
            sock.settimeout(1.0)
            try:
                got[name] = tstreams.read_frame(sock)
            except OSError:  # the timeout: the frame is gone
                got[name] = None
            finally:
                sock.close()
        th.join(timeout=10)
    finally:
        listener.close()
    assert got == {"torch": (3, b'{"exitCode": 0}'), "jax": None}
