"""Authentication and authorization: the port's copy of the JAX
package's ``apiserver/auth.py`` (ref: staging/src/k8s.io/apiserver/pkg/
authentication, pkg/registry/rbac, plugin/pkg/auth/authorizer/node).

The filter-chain position mirrors config.go:530-551: authn resolves the
request's UserInfo, then the authorizer chain (union semantics: the first
authorizer to allow wins) gates the verb and resource before admission.

Authenticators (bearer forms; an x509 client certificate is read by the
server from the TLS connection, before any of these):
- static tokens        -> users and groups from a table (``--token``);
- service account HMAC -> system:serviceaccount:<ns>:<name>, while the
                          ServiceAccount exists with the token's uid;
- bootstrap tokens     -> system:bootstrap:<id>, from a live, unexpired
                          kube-system bootstrap-token Secret.

Authorizers:
- system:masters is always allowed (the bootstrap superuser);
- RBACAuthorizer over Role/ClusterRole/(Cluster)RoleBinding objects;
- NodeAuthorizer scoping each kubelet to its own node's objects.

The JAX module's OIDC and webhook authenticators, and its KTPU-CERT
one (the CSR signer's HMAC credential), have no caller in the port
(ROADMAP item 18).
"""

from __future__ import annotations

import hmac as _hmac
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..api import types as t
from ..machinery.meta import parse_iso

GROUP_MASTERS = "system:masters"
GROUP_NODES = "system:nodes"
GROUP_AUTHENTICATED = "system:authenticated"
GROUP_UNAUTHENTICATED = "system:unauthenticated"
GROUP_BOOTSTRAPPERS = "system:bootstrappers"
USER_ANONYMOUS = "system:anonymous"
BOOTSTRAP_TOKEN_SECRET_TYPE = "bootstrap.kubernetes.io/token"


@dataclass
class UserInfo:
    name: str = USER_ANONYMOUS
    groups: List[str] = field(default_factory=list)

    def in_group(self, g: str) -> bool:
        return g in self.groups


ANONYMOUS = UserInfo(name=USER_ANONYMOUS, groups=[GROUP_UNAUTHENTICATED])


# ------------------------------------------------------------------- authn


class StaticTokenAuthenticator:
    """token -> (username, groups) table."""

    def __init__(self, tokens: Dict[str, Tuple[str, List[str]]]):
        self.tokens = tokens

    def authenticate(self, token: str) -> Optional[UserInfo]:
        entry = self.tokens.get(token)
        if entry is None:
            return None
        name, groups = entry
        return UserInfo(name=name, groups=list(groups) + [GROUP_AUTHENTICATED])


class ServiceAccountAuthenticator:
    """Verifies HMAC SA tokens minted by the token controller. A valid
    signature alone is not enough: the backing ServiceAccount must still
    exist and carry the token's uid (the reference's token authenticator
    re-validates the SA and secret, so deleting or recreating a
    ServiceAccount revokes previously issued credentials)."""

    def __init__(self, signing_key: str, get_serviceaccount=None):
        self.signing_key = signing_key
        self._get_sa = get_serviceaccount  # (namespace, name) -> SA | None

    def authenticate(self, token: str) -> Optional[UserInfo]:
        from ..controllers.serviceaccount import verify_token

        claims = verify_token(self.signing_key, token)
        if not claims:
            return None
        sub = claims.get("sub", "")
        if not sub.startswith("system:serviceaccount:"):
            return None
        _, _, ns, _name = sub.split(":", 3)
        if self._get_sa is not None:
            sa = self._get_sa(ns, _name)
            if sa is None:
                return None
            if claims.get("uid") and sa.metadata.uid != claims["uid"]:
                return None  # SA was deleted and recreated; old tokens die
        return UserInfo(
            name=sub,
            groups=[
                "system:serviceaccounts",
                f"system:serviceaccounts:{ns}",
                GROUP_AUTHENTICATED,
            ],
        )



class BootstrapTokenAuthenticator:
    """kubeadm-style join tokens (ref: apiserver bootstrap token authn +
    cmd/kubeadm bootstrap tokens): a token `<id>.<secret>` matches the
    kube-system Secret bootstrap-token-<id> of the bootstrap type and
    authenticates as system:bootstrap:<id> in system:bootstrappers — just
    enough identity to submit a node CSR and nothing else."""

    def __init__(self, get_secret: Callable[[str, str], Optional[t.Secret]]):
        self._get_secret = get_secret  # (namespace, name) -> Secret | None

    def authenticate(self, token: str) -> Optional[UserInfo]:
        token_id, sep, secret = token.partition(".")
        if not sep or not token_id or not secret or "." in secret:
            return None
        obj = self._get_secret("kube-system", f"bootstrap-token-{token_id}")
        if obj is None or obj.type != BOOTSTRAP_TOKEN_SECRET_TYPE:
            return None
        want = obj.data.get("token-secret", "")
        if not want or not _hmac.compare_digest(secret, want):
            return None
        # a staged/disabled token must not authenticate, and tokens expire
        # (ref: bootstrap token authenticator usage + expiration checks)
        if obj.data.get("usage-bootstrap-authentication") != "true":
            return None
        expiry = obj.data.get("expiration", "")
        if expiry:
            try:
                if parse_iso(expiry) < time.time():
                    return None
            except ValueError:
                return None  # unparseable expiry = unusable token
        return UserInfo(
            name=f"system:bootstrap:{token_id}",
            groups=[GROUP_BOOTSTRAPPERS, GROUP_AUTHENTICATED],
        )


class AuthenticatorChain:
    def __init__(self, authenticators: List):
        self.authenticators = authenticators

    def authenticate(self, token: str) -> Optional[UserInfo]:
        """None = bad credential; ANONYMOUS is returned only for NO credential
        (decided by the caller)."""
        for a in self.authenticators:
            user = a.authenticate(token)
            if user is not None:
                return user
        return None


# ------------------------------------------------------------------- authz


def _match(values: List[str], want: str) -> bool:
    return "*" in values or want in values


class RBACAuthorizer:
    """Evaluates RBAC objects live from the store (the reference resolves
    through informer-backed rule caches; the in-memory store makes direct
    reads cheap enough)."""

    def __init__(self, lister: Callable[[str, str], list]):
        self._list = lister  # (resource, namespace) -> [objects]

    def _subject_matches(self, subj: t.Subject, user: UserInfo) -> bool:
        if subj.kind == "User":
            return subj.name == user.name
        if subj.kind == "Group":
            return user.in_group(subj.name)
        if subj.kind == "ServiceAccount":
            return user.name == f"system:serviceaccount:{subj.namespace}:{subj.name}"
        return False

    def _rules_for(self, user: UserInfo, namespace: str) -> List[t.PolicyRule]:
        rules: List[t.PolicyRule] = []
        for crb in self._list("clusterrolebindings", ""):
            if any(self._subject_matches(s, user) for s in crb.subjects):
                role = self._get_cluster_role(crb.role_ref.name)
                if role:
                    rules.extend(role.rules)
        if namespace:
            for rb in self._list("rolebindings", namespace):
                if not any(self._subject_matches(s, user) for s in rb.subjects):
                    continue
                if rb.role_ref.kind == "ClusterRole":
                    role = self._get_cluster_role(rb.role_ref.name)
                else:
                    role = next(
                        (r for r in self._list("roles", namespace)
                         if r.metadata.name == rb.role_ref.name),
                        None,
                    )
                if role:
                    rules.extend(role.rules)
        return rules

    def _get_cluster_role(self, name: str):
        return next(
            (r for r in self._list("clusterroles", "") if r.metadata.name == name),
            None,
        )

    def authorize(self, user: UserInfo, verb: str, resource: str,
                  namespace: str, name: str, sub: str = "") -> bool:
        # upstream semantics: a rule granting "pods" does NOT grant
        # "pods/eviction" or "pods/exec" — subresources are named explicitly
        effective = f"{resource}/{sub}" if sub else resource
        for rule in self._rules_for(user, namespace):
            if not _match(rule.verbs, verb):
                continue
            if not _match(rule.resources, effective):
                continue
            if rule.resource_names and name and name not in rule.resource_names:
                continue
            return True
        return False


class NodeAuthorizer:
    """Scopes kubelets (system:node:<name>, group system:nodes) to their own
    node's objects (ref: plugin/pkg/auth/authorizer/node/node_authorizer.go —
    there a graph; here direct pod lookups). Secrets/configmaps/PVCs are the
    sensitive class: a node may only GET ones referenced by a pod bound to it,
    never list/watch them cluster-wide."""

    READ_RESOURCES = {
        "pods", "services", "endpoints", "persistentvolumes", "nodes",
    }
    REFERENCED_READ_RESOURCES = {"secrets", "configmaps", "persistentvolumeclaims"}

    def __init__(self, get_pod: Callable[[str, str], Optional[t.Pod]],
                 list_pods: Optional[Callable[[], list]] = None,
                 get_serviceaccount: Optional[Callable] = None):
        self._get_pod = get_pod
        self._list_pods = list_pods
        self._get_sa = get_serviceaccount  # (namespace, name) -> SA | None

    def _node_pods(self, node_name: str, namespace: str):
        if self._list_pods is None:
            return
        for pod in self._list_pods():
            if pod.spec.node_name == node_name \
                    and pod.metadata.namespace == namespace:
                yield pod

    def _pod_references(self, node_name: str, resource: str,
                        namespace: str, name: str) -> bool:
        for pod in self._node_pods(node_name, namespace):
            for vol in pod.spec.volumes:
                if resource == "secrets" and vol.secret is not None \
                        and vol.secret.secret_name == name:
                    return True
                if resource == "configmaps" and vol.config_map is not None \
                        and vol.config_map.name == name:
                    return True
                if resource == "persistentvolumeclaims" \
                        and vol.persistent_volume_claim is not None \
                        and vol.persistent_volume_claim.claim_name == name:
                    return True
            # the SA token secret the kubelet automounts (the reference's
            # node-authorizer graph walks pod -> serviceaccount -> secret)
            if resource == "secrets" and self._get_sa is not None:
                sa = self._get_sa(
                    namespace, pod.spec.service_account_name or "default")
                if sa is not None and any(ref.name == name for ref in sa.secrets):
                    return True
        return False

    def _pod_uses_serviceaccount(self, node_name: str, namespace: str,
                                 name: str) -> bool:
        return any(
            (pod.spec.service_account_name or "default") == name
            for pod in self._node_pods(node_name, namespace)
        )

    def authorize(self, user: UserInfo, verb: str, resource: str,
                  namespace: str, name: str, sub: str = "") -> bool:
        if not user.in_group(GROUP_NODES) or not user.name.startswith("system:node:"):
            return False
        if sub and sub != "status":
            # nodes write status subresources; they never bind, evict, or
            # exec through the API
            return False
        node_name = user.name[len("system:node:"):]
        if resource == "configmaps" and namespace == "kube-system" \
                and verb == "get" and name in (
                    f"kubelet-config-{node_name}", "kubelet-config"):
            return True  # dynamic kubelet config source
        if resource == "secrets":
            # its own kubelet-token secret is writable (NodeRestriction
            # admission pins the name on CREATE, where the URL carries none)
            if namespace == "kube-system" and (
                not name or name == f"kubelet-token-{node_name}"
            ) and verb in ("create", "update", "patch"):
                return True
        if resource == "serviceaccounts":
            return verb == "get" and bool(name) \
                and self._pod_uses_serviceaccount(node_name, namespace, name)
        if resource in self.REFERENCED_READ_RESOURCES:
            return verb == "get" and bool(name) and self._pod_references(
                node_name, resource, namespace, name
            )
        if verb in ("get", "list", "watch") and resource in self.READ_RESOURCES:
            return True
        if resource == "nodes":
            # register itself + keep its own status current
            return (verb == "create") or (
                verb in ("update", "patch", "delete") and name == node_name
            )
        if resource == "nodemetrics":
            return verb in ("create", "update", "patch") and (
                not name or name == node_name
            )
        if resource == "events":
            return verb in ("create", "update", "patch")
        if resource == "leases":
            return verb in ("get", "create", "update", "patch")
        if resource == "certificatesigningrequests":
            return verb in ("get", "create")
        if resource in ("pods", "podmetrics", "podcustommetrics"):
            if verb not in ("update", "patch", "create", "delete"):
                return False
            if verb == "create" and resource in ("podmetrics",
                                                 "podcustommetrics"):
                return True
            if resource == "podcustommetrics":
                # the scrape agent updates/GCs metrics objects NAMED
                # after its own pods (publish rides create/update, a
                # vanished pod's object is deleted) — ownership follows
                # the pod of the same name on this node
                pod = self._get_pod(namespace, name)
                return pod is None or pod.spec.node_name == node_name
            pod = self._get_pod(namespace, name)
            # mirror pods (static manifests) are created by the node itself
            if pod is None:
                return verb in ("create", "update", "patch")
            return pod.spec.node_name == node_name
        return False


class AlwaysAllowAuthorizer:
    def authorize(self, *args, **kwargs) -> bool:
        return True


class AuthorizerChain:
    def __init__(self, authorizers: List):
        self.authorizers = authorizers

    def authorize(self, user: UserInfo, verb: str, resource: str,
                  namespace: str, name: str, sub: str = "") -> bool:
        if user.in_group(GROUP_MASTERS):
            return True
        return any(
            a.authorize(user, verb, resource, namespace, name, sub=sub)
            for a in self.authorizers
        )


def verb_for(method: str, name: str, is_watch: bool) -> str:
    if method == "GET":
        if is_watch:
            return "watch"
        return "get" if name else "list"
    return {
        "POST": "create", "PUT": "update", "PATCH": "patch", "DELETE": "delete",
    }.get(method, method.lower())
