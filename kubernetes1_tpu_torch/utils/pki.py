"""Cluster PKI: x509 certificates for every wire of the cluster.  The
port's copy of the JAX package's ``utils/pki.py``, over the same
``cryptography`` package: the same keys, subjects, extensions and
lifetimes, so either package reads and signs the other's CSRs and
certificates.

Ref: cmd/kubeadm/app/phases/certs/certs.go:37 (CreatePKIAssets: CA,
apiserver serving cert, component client certs), pkiutil (NewCertAndKey),
and the kubelet TLS-bootstrap flow (CSR in, signed client cert out —
pkg/controller/certificates/signer).

- EC P-256 keys everywhere: the handshake and issuance are cheap, and
  every TLS stack speaks it.
- One dual-EKU node certificate (clientAuth + serverAuth, SANs for the
  node's addresses) instead of kubeadm's separate kubelet client/serving
  pair: the kubelet both dials the apiserver and serves :10250, and one
  CSR round-trip keeps ``ktpu join`` one-shot.
- The CA "hash" for join-time discovery pinning is sha256 over the CA
  cert's DER (kubeadm pins the SPKI; whole-cert pinning is stronger).
"""

from __future__ import annotations

import datetime
import hashlib
import ipaddress
import os
from typing import Iterable, List, Optional, Tuple

from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.x509.oid import ExtendedKeyUsageOID, NameOID

_ONE_DAY = datetime.timedelta(days=1)


def _new_key():
    return ec.generate_private_key(ec.SECP256R1())


def _key_pem(key) -> str:
    return key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption(),
    ).decode()


def _load_key(key_pem: str):
    return serialization.load_pem_private_key(key_pem.encode(), password=None)


def _load_cert(cert_pem: str) -> x509.Certificate:
    return x509.load_pem_x509_certificate(cert_pem.encode())


def _subject(cn: str, orgs: Iterable[str]) -> x509.Name:
    parts = [x509.NameAttribute(NameOID.COMMON_NAME, cn)]
    parts += [x509.NameAttribute(NameOID.ORGANIZATION_NAME, o) for o in orgs]
    return x509.Name(parts)


def _san_list(dns_sans: Iterable[str], ip_sans: Iterable[str]) -> List:
    sans: List = [x509.DNSName(d) for d in dns_sans]
    for ip in ip_sans:
        try:
            sans.append(x509.IPAddress(ipaddress.ip_address(ip)))
        except ValueError:
            sans.append(x509.DNSName(ip))  # hostname slipped into ip list
    return sans


def create_ca(cn: str = "ktpu-ca", days: int = 3650) -> Tuple[str, str]:
    """Self-signed CA. Returns (cert_pem, key_pem)."""
    key = _new_key()
    now = datetime.datetime.now(datetime.timezone.utc)
    name = _subject(cn, [])
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - _ONE_DAY)
        .not_valid_after(now + datetime.timedelta(days=days))
        .add_extension(x509.BasicConstraints(ca=True, path_length=None),
                       critical=True)
        .add_extension(
            x509.KeyUsage(
                digital_signature=True, key_cert_sign=True, crl_sign=True,
                content_commitment=False, key_encipherment=False,
                data_encipherment=False, key_agreement=False,
                encipher_only=False, decipher_only=False),
            critical=True)
        .sign(key, hashes.SHA256())
    )
    return cert.public_bytes(serialization.Encoding.PEM).decode(), _key_pem(key)


def issue_cert(
    ca_cert_pem: str,
    ca_key_pem: str,
    cn: str,
    orgs: Iterable[str] = (),
    dns_sans: Iterable[str] = (),
    ip_sans: Iterable[str] = (),
    client: bool = False,
    server: bool = False,
    days: int = 365,
) -> Tuple[str, str]:
    """Issue a leaf cert + fresh key. Returns (cert_pem, key_pem)."""
    key = _new_key()
    cert_pem = _build_leaf(
        ca_cert_pem, ca_key_pem, key.public_key(), _subject(cn, orgs),
        dns_sans, ip_sans, client, server, days)
    return cert_pem, _key_pem(key)


def _build_leaf(ca_cert_pem, ca_key_pem, public_key, subject,
                dns_sans, ip_sans, client, server, days) -> str:
    ca_cert = _load_cert(ca_cert_pem)
    ca_key = _load_key(ca_key_pem)
    now = datetime.datetime.now(datetime.timezone.utc)
    ekus = []
    if client:
        ekus.append(ExtendedKeyUsageOID.CLIENT_AUTH)
    if server:
        ekus.append(ExtendedKeyUsageOID.SERVER_AUTH)
    b = (
        x509.CertificateBuilder()
        .subject_name(subject)
        .issuer_name(ca_cert.subject)
        .public_key(public_key)
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - _ONE_DAY)
        .not_valid_after(now + datetime.timedelta(days=days))
        .add_extension(x509.BasicConstraints(ca=False, path_length=None),
                       critical=True)
        .add_extension(
            x509.KeyUsage(
                digital_signature=True, key_encipherment=False,
                content_commitment=False, data_encipherment=False,
                key_agreement=False, key_cert_sign=False, crl_sign=False,
                encipher_only=False, decipher_only=False),
            critical=True)
    )
    if ekus:
        b = b.add_extension(x509.ExtendedKeyUsage(ekus), critical=False)
    sans = _san_list(dns_sans, ip_sans)
    if sans:
        b = b.add_extension(x509.SubjectAlternativeName(sans), critical=False)
    cert = b.sign(ca_key, hashes.SHA256())
    return cert.public_bytes(serialization.Encoding.PEM).decode()


def create_csr(
    cn: str,
    orgs: Iterable[str] = (),
    dns_sans: Iterable[str] = (),
    ip_sans: Iterable[str] = (),
) -> Tuple[str, str]:
    """PEM CSR + its private key (the kubelet's side of TLS bootstrap)."""
    key = _new_key()
    b = x509.CertificateSigningRequestBuilder().subject_name(_subject(cn, orgs))
    sans = _san_list(dns_sans, ip_sans)
    if sans:
        b = b.add_extension(x509.SubjectAlternativeName(sans), critical=False)
    csr = b.sign(key, hashes.SHA256())
    return csr.public_bytes(serialization.Encoding.PEM).decode(), _key_pem(key)


def csr_identity(csr_pem: str) -> Tuple[str, List[str]]:
    """(CN, organizations) a CSR asks for — the approver checks these
    against the requesting user before the signer ever runs."""
    csr = x509.load_pem_x509_csr(csr_pem.encode())
    cn = ""
    orgs: List[str] = []
    for attr in csr.subject:
        if attr.oid == NameOID.COMMON_NAME:
            cn = str(attr.value)
        elif attr.oid == NameOID.ORGANIZATION_NAME:
            orgs.append(str(attr.value))
    return cn, orgs


def sign_csr(
    ca_cert_pem: str,
    ca_key_pem: str,
    csr_pem: str,
    client: bool = False,
    server: bool = False,
    days: int = 365,
) -> str:
    """Sign a PEM CSR with the cluster CA, preserving subject + SANs.
    The CSR's signature is verified first (proof-of-possession)."""
    csr = x509.load_pem_x509_csr(csr_pem.encode())
    if not csr.is_signature_valid:
        raise ValueError("CSR signature invalid")
    dns_sans: List[str] = []
    ip_sans: List[str] = []
    try:
        san = csr.extensions.get_extension_for_class(
            x509.SubjectAlternativeName).value
        dns_sans = san.get_values_for_type(x509.DNSName)
        ip_sans = [str(ip) for ip in san.get_values_for_type(x509.IPAddress)]
    except x509.ExtensionNotFound:
        pass
    return _build_leaf(ca_cert_pem, ca_key_pem, csr.public_key(),
                       csr.subject, dns_sans, ip_sans, client, server, days)


def cert_identity(cert_pem: str) -> Tuple[str, List[str]]:
    """(CN, organizations) of a leaf cert — the x509 authn mapping
    (CN=username, O=groups; staging authenticator/request/x509)."""
    cert = _load_cert(cert_pem)
    cn = ""
    orgs: List[str] = []
    for attr in cert.subject:
        if attr.oid == NameOID.COMMON_NAME:
            cn = str(attr.value)
        elif attr.oid == NameOID.ORGANIZATION_NAME:
            orgs.append(str(attr.value))
    return cn, orgs


def is_pem_csr(data: str) -> bool:
    return "-----BEGIN CERTIFICATE REQUEST-----" in (data or "")


def ca_cert_hash(ca_cert_pem: str) -> str:
    """`sha256:<hex>` pin for join-time discovery (kubeadm's
    --discovery-token-ca-cert-hash role)."""
    der = _load_cert(ca_cert_pem).public_bytes(serialization.Encoding.DER)
    return "sha256:" + hashlib.sha256(der).hexdigest()


def write_pki(dir_path: str, name: str, cert_pem: str,
              key_pem: Optional[str] = None) -> Tuple[str, str]:
    """Write <name>.crt (+ <name>.key, 0600). Returns their paths."""
    os.makedirs(dir_path, exist_ok=True)
    cert_path = os.path.join(dir_path, f"{name}.crt")
    with open(cert_path, "w") as f:
        f.write(cert_pem)
    key_path = ""
    if key_pem is not None:
        key_path = os.path.join(dir_path, f"{name}.key")
        fd = os.open(key_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w") as f:
            f.write(key_pem)
    return cert_path, key_path
