"""The port's PKI (``kubernetes1_tpu_torch.utils.pki``) held to the JAX
package's ``utils/pki.py``: each package reads the other's CSRs and
certificates, signs the other's CSRs with the same identity, usages,
names and lifetime, pins the same CA hash, and a Python ``ssl`` handshake
crosses between a CA of one package and leaf certificates of the other,
both ways.  Tolerance 0: identities, usages and lifetimes are compared
for equality.
"""

import base64
import os
import socket
import ssl
import stat
import threading

import pytest
from cryptography import x509
from cryptography.hazmat.primitives.serialization import Encoding
from cryptography.x509.oid import ExtendedKeyUsageOID

from kubernetes1_tpu.utils import pki as jpki
from kubernetes1_tpu_torch.utils import pki as tpki

PKGS = {"jax": jpki, "torch": tpki}
PAIRS = [("jax", "torch"), ("torch", "jax")]


def _profile(cert_pem: str) -> dict:
    """What a certificate asserts, without its key, serial or dates."""
    cert = x509.load_pem_x509_certificate(cert_pem.encode())
    exts = {type(e.value).__name__: e for e in cert.extensions}
    eku = exts.get("ExtendedKeyUsage")
    san = exts.get("SubjectAlternativeName")
    return {
        "subject": cert.subject.rfc4514_string(),
        "issuer": cert.issuer.rfc4514_string(),
        "ca": exts["BasicConstraints"].value.ca,
        "critical": sorted(n for n, e in exts.items() if e.critical),
        "eku": sorted(o.dotted_string for o in eku.value) if eku else [],
        "dns": sorted(san.value.get_values_for_type(x509.DNSName)) if san else [],
        "ip": sorted(str(i) for i in san.value.get_values_for_type(x509.IPAddress)) if san else [],
        "lifetime": cert.not_valid_after_utc - cert.not_valid_before_utc,
        "key": type(cert.public_key()).__name__,
    }


@pytest.fixture(scope="module")
def cas():
    return {name: mod.create_ca("ktpu-ca") for name, mod in PKGS.items()}


def test_create_ca_profiles_are_equal(cas):
    assert _profile(cas["torch"][0]) == _profile(cas["jax"][0])
    assert _profile(cas["torch"][0])["ca"] is True


@pytest.mark.parametrize("client,server", [(True, False), (False, True), (True, True),
                                           (False, False)])
def test_issue_cert_profiles_are_equal(cas, client, server):
    kw = dict(cn="system:node:n1", orgs=["system:nodes"], dns_sans=["n1", "localhost"],
              ip_sans=["127.0.0.1", "not-an-ip"], client=client, server=server)
    got = {name: _profile(PKGS[name].issue_cert(*cas["jax"], **kw)[0]) for name in PKGS}
    assert got["torch"] == got["jax"]
    want = ([ExtendedKeyUsageOID.CLIENT_AUTH.dotted_string] if client else []) + \
        ([ExtendedKeyUsageOID.SERVER_AUTH.dotted_string] if server else [])
    assert got["torch"]["eku"] == sorted(want)
    assert got["torch"]["dns"] == ["localhost", "n1", "not-an-ip"]


@pytest.mark.parametrize("maker,reader", PAIRS + [("jax", "jax"), ("torch", "torch")])
def test_each_package_reads_the_others_csr_and_certificate(cas, maker, reader):
    csr, key = PKGS[maker].create_csr("system:node:n7", ["system:nodes", "extra"],
                                      dns_sans=["n7"], ip_sans=["10.0.0.7"])
    assert PKGS[reader].csr_identity(csr) == ("system:node:n7", ["system:nodes", "extra"])
    assert PKGS[reader].is_pem_csr(csr) and not PKGS[reader].is_pem_csr(key)
    cert, _ = PKGS[maker].issue_cert(*cas[maker], cn="alice", orgs=["dev"], client=True)
    assert PKGS[reader].cert_identity(cert) == ("alice", ["dev"])


@pytest.mark.parametrize("signer,requester", PAIRS)
@pytest.mark.parametrize("client,server", [(True, True), (True, False)])
def test_sign_csr_of_the_other_package_gives_equal_certificates(cas, signer, requester,
                                                                client, server):
    csr, _ = PKGS[requester].create_csr("system:node:n2", ["system:nodes"],
                                        dns_sans=["n2", "localhost"], ip_sans=["127.0.0.1"])
    got = {name: _profile(PKGS[name].sign_csr(*cas[signer], csr, client=client, server=server))
           for name in (signer, requester)}
    assert got[signer] == got[requester]
    assert got[signer]["ip"] == ["127.0.0.1"] and got[signer]["dns"] == ["localhost", "n2"]


def test_sign_csr_refuses_a_csr_whose_signature_does_not_hold(cas):
    csr, _ = jpki.create_csr("system:node:n3")
    der = bytearray(x509.load_pem_x509_csr(csr.encode()).public_bytes(Encoding.DER))
    der[-1] ^= 0xFF  # the signature's last byte
    bad = ("-----BEGIN CERTIFICATE REQUEST-----\n" + base64.encodebytes(bytes(der)).decode()
           + "-----END CERTIFICATE REQUEST-----\n")
    for mod in PKGS.values():
        with pytest.raises(ValueError):
            mod.sign_csr(*cas["torch"], bad)


@pytest.mark.parametrize("maker", sorted(PKGS))
def test_ca_cert_hash_is_equal_on_the_same_pem(cas, maker):
    pem = cas[maker][0]
    assert tpki.ca_cert_hash(pem) == jpki.ca_cert_hash(pem)
    assert tpki.ca_cert_hash(pem).startswith("sha256:") and len(tpki.ca_cert_hash(pem)) == 71


def test_write_pki_keeps_keys_private(tmp_path, cas):
    for name, mod in PKGS.items():
        d = tmp_path / name
        crt, key = mod.write_pki(str(d), "ca", *cas[name])
        assert open(crt).read() == cas[name][0] and open(key).read() == cas[name][1]
        assert stat.S_IMODE(os.stat(key).st_mode) == 0o600
        assert mod.write_pki(str(d), "only", cas[name][0])[1] == ""


@pytest.mark.parametrize("ca_pkg,leaf_pkg", PAIRS)
def test_a_tls_handshake_crosses_between_the_packages(tmp_path, ca_pkg, leaf_pkg):
    """A CA of one package, the server's and the client's certificates
    signed by the other from CSRs of the first: a mutual TLS handshake
    verifies both sides and each peer reads the other's subject."""
    ca_cert, ca_key = PKGS[ca_pkg].create_ca("ktpu-ca")
    ca = tmp_path / "ca.crt"
    ca.write_text(ca_cert)
    files = {}
    for role, cn, orgs, client, server in (("server", "kube-apiserver", [], False, True),
                                           ("client", "ktpu-admin", ["system:masters"], True,
                                            False)):
        csr, key = PKGS[ca_pkg].create_csr(cn, orgs, dns_sans=["localhost"],
                                           ip_sans=["127.0.0.1"])
        cert = PKGS[leaf_pkg].sign_csr(ca_cert, ca_key, csr, client=client, server=server)
        files[role] = PKGS[leaf_pkg].write_pki(str(tmp_path), role, cert, key)
    sctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    sctx.load_cert_chain(*files["server"])
    sctx.load_verify_locations(cafile=str(ca))
    sctx.verify_mode = ssl.CERT_REQUIRED
    cctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    cctx.load_verify_locations(cafile=str(ca))
    cctx.load_cert_chain(*files["client"])
    listener = socket.create_server(("127.0.0.1", 0))
    seen = {}

    def serve():
        conn, _ = listener.accept()
        with sctx.wrap_socket(conn, server_side=True) as tls:
            seen["client"] = dict(x[0] for x in tls.getpeercert()["subject"])
            tls.sendall(b"ok")

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    try:
        with socket.create_connection(listener.getsockname(), timeout=10) as raw:
            with cctx.wrap_socket(raw, server_hostname="127.0.0.1") as tls:
                seen["server"] = dict(x[0] for x in tls.getpeercert()["subject"])
                assert tls.recv(2) == b"ok"
        th.join(timeout=10)
        assert not th.is_alive()
    finally:
        listener.close()
    assert seen["server"] == {"commonName": "kube-apiserver"}
    assert seen["client"] == {"commonName": "ktpu-admin", "organizationName": "system:masters"}
