"""CSR approver and signer (ref: pkg/controller/certificates/
{certificate_controller,approver,signer}.go): the port's copy of the JAX
package's ``controllers/certificates.py``, the kubelet TLS-bootstrap seam.

A node submits a CertificateSigningRequest.  Auto-approval covers node
client certificates (``system:node:*`` usernames in no group but
system:nodes, created by that node, a bootstrapper or an admin: the
reference's sarApprover posture); anything else waits for a human.  The
signer then writes an x509 certificate, signed with the cluster CA's key
and certificate, into ``status.certificate``; the PEM CSR's subject must
equal the approved identity, and a request that is no PEM CSR is denied
(the JAX signer's HMAC KTPU-CERT credential for it has no caller in the
port, ROADMAP item 18).  The controller manager runs this loop only when
it holds the CA.  Signed CSRs are deleted an hour after signing, unsigned
ones after a day.
"""

from __future__ import annotations

import time

from ..api import types as t
from ..apiserver.admission import CREATED_BY_ANNOTATION, CREATED_BY_GROUPS_ANNOTATION
from ..machinery import ApiError, NotFound, now_iso
from ..machinery.meta import parse_iso
from ..utils import pki
from .base import Controller


class CertificateController(Controller):
    name = "certificate-controller"

    WORKERS = 1

    def __init__(self, clientset, factory, ca_cert_pem: str, ca_key: str):
        super().__init__(clientset, factory)
        self.ca_cert_pem = ca_cert_pem
        self.ca_key = ca_key

    def _sign(self, csr) -> str:
        """The x509 certificate of an approved CSR; ValueError when the
        request is no PEM CSR or asks for another subject than the one
        approved."""
        if not pki.is_pem_csr(csr.spec.request):
            raise ValueError("spec.request is not a PEM certificate signing request")
        # the approver already vetted spec.username/groups; the SIGNER
        # must also pin the CSR's x509 subject to that vetted identity,
        # or a node could smuggle an admin CN past the approver
        cn, orgs = pki.csr_identity(csr.spec.request)
        if cn != csr.spec.username or not set(orgs) <= set(csr.spec.groups):
            raise ValueError(
                f"CSR subject CN={cn!r} O={orgs!r} does not match "
                f"spec.username={csr.spec.username!r}/groups")
        # honor the requested usages (nodes ask for both: the kubelet
        # dials the apiserver AND serves :10250 from one CSR round-trip)
        usages = csr.spec.usages or ["client auth"]
        return pki.sign_csr(self.ca_cert_pem, self.ca_key, csr.spec.request,
                            client="client auth" in usages,
                            server="server auth" in usages)

    def setup(self):
        self.csrs = self.factory.informer("certificatesigningrequests")
        self.csrs.add_handler(
            on_add=self.enqueue, on_update=lambda _o, n: self.enqueue(n)
        )

    @staticmethod
    def _condition(csr, ctype: str) -> bool:
        return any(c.type == ctype for c in csr.status.conditions)

    @staticmethod
    def _creator_may_request(csr) -> bool:
        """The authenticated creator (IdentityStamp annotation) may request
        spec.username if it IS that identity (renewal), holds a bootstrap
        identity, or is a cluster admin (ref: the sarApprover's
        selfnodeclient/nodeclient posture)."""
        creator = csr.metadata.annotations.get(CREATED_BY_ANNOTATION, "")
        groups = set(
            csr.metadata.annotations.get(CREATED_BY_GROUPS_ANNOTATION, "").split(",")
        )
        if not creator:
            # no identity recorded (AlwaysAllow mode) — keep legacy behavior
            return True
        return (
            creator == csr.spec.username
            or creator.startswith("system:bootstrap:")
            or "system:bootstrappers" in groups
            or "system:masters" in groups
        )

    # CSR garbage collection (ref pkg/controller/certificates/cleaner):
    # bootstrap mints a fresh random-named CSR per (re-)join, so without a
    # TTL the store grows one object per join forever
    SIGNED_TTL_S = 3600.0       # issued certs: the node already has it
    PENDING_TTL_S = 24 * 3600.0  # never-approved/denied leftovers

    def _gc(self, csr) -> bool:
        """Delete expired CSRs; returns True when the object is gone.
        Re-enqueues itself for the remaining TTL otherwise."""
        try:
            age = time.time() - parse_iso(csr.metadata.creation_timestamp)
        except (ValueError, TypeError):
            return False
        ttl = (self.SIGNED_TTL_S
               if csr.status.certificate or self._condition(csr, "Denied")
               else self.PENDING_TTL_S)
        if age >= ttl:
            try:
                self.cs.certificatesigningrequests.delete(csr.metadata.name, "")
            except ApiError:
                pass
            return True
        self.enqueue_after(csr.metadata.name, ttl - age + 1.0)
        return False

    def sync(self, key: str):
        cached = self.csrs.get(key)
        if cached is None:
            return
        if self._condition(cached, "Denied"):
            self._gc(cached)
            return
        # Work on a fresh server copy — mutating the informer-cached object
        # would make later syncs see state the server never accepted.
        try:
            csr = self.cs.certificatesigningrequests.get(cached.metadata.name, "")
        except NotFound:
            return
        if self._gc(csr):
            return
        changed = False
        if not self._condition(csr, "Approved"):
            # Auto-approve node client certs only; anything else waits for a
            # human `ktpu certificate approve`. Two spoofing vectors guarded:
            # groups are part of the signed identity (smuggling system:masters
            # would be one-step privilege escalation), and spec.username is
            # client-controlled — the authenticated creator recorded by the
            # IdentityStamp admission plugin must be the node itself renewing,
            # or a bootstrapper, to stop any CSR-creator minting other nodes'
            # identities.
            if (
                csr.spec.username.startswith("system:node:")
                and set(csr.spec.groups) <= {"system:nodes"}
                and self._creator_may_request(csr)
            ):
                csr.status.conditions.append(
                    t.CSRCondition(
                        type="Approved", reason="AutoApproved",
                        message="node client certificate",
                        last_update_time=now_iso(),
                    )
                )
                changed = True
            else:
                return
        if self._condition(csr, "Approved") and not csr.status.certificate:
            try:
                csr.status.certificate = self._sign(csr)
            except ValueError as e:
                reason = ("SubjectMismatch" if pki.is_pem_csr(csr.spec.request)
                          else "NotACertificateRequest")
                csr.status.conditions.append(t.CSRCondition(
                    type="Denied", reason=reason, message=str(e),
                    last_update_time=now_iso()))
            changed = True
        if not changed:
            return
        try:
            self.cs.certificatesigningrequests.update_status(csr)
        except ApiError:
            self.enqueue_after(key, 0.5)  # conflicting write landed; retry
