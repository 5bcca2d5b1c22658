"""Admission chain (ref: plugin/pkg/admission/): the port's copy of the
JAX package's ``apiserver/admission.py``, with the plugins of its default
chain.  Plugins run in order on CREATE and UPDATE, before validation,
and mutate the incoming object or raise an ApiError to refuse it.

The device seam is ResourceV2 (ref: plugin/pkg/admission/resourcev2/
admission.go:51-92): a plain container limit ``nvidia.com/gpu: N`` is
rewritten into the pod-level ExtendedResources form (a uuid-named
PodExtendedResource and a container.extended_resource_requests entry)
and the raw limit and request are dropped, so a pre-v2 PodSpec runs
unchanged.  The JAX package rewrites ``google.com/`` limits and refuses
``nvidia.com/gpu``; here it is the other way round.  The feature gates
the JAX plugins read are always on.
"""

from __future__ import annotations

import time
import uuid
from typing import List, Optional

from .. import GPU_RESOURCE
from ..api import types as t
from ..machinery.errors import Forbidden, Invalid
from ..utils.quantity import parse_quantity

CREATE = "CREATE"
UPDATE = "UPDATE"
DELETE = "DELETE"

# Container limits under these prefixes are rewritten to the v2 pod-level
# form; a google.com/tpu limit has no card to map to and is refused with
# a pointed message instead of leaving the pod pending forever.
EXTENDED_RESOURCE_PREFIXES = ("nvidia.com/",)
REJECTED_RESOURCES = ("google.com/tpu",)


class AdmissionPlugin:
    name = "base"

    def admit(self, operation: str, resource: str, obj, old=None, user=None):
        """Mutate obj in place or raise ApiError to reject."""


class ResourceV2(AdmissionPlugin):
    """Container-level extended-resource limits -> pod-level v2 requests."""

    name = "ResourceV2"

    def admit(self, operation: str, resource: str, obj, old=None, user=None):
        if resource != "pods" or operation != CREATE:
            return
        for container in list(obj.spec.containers) + list(obj.spec.init_containers):
            limits = container.resources.limits or {}
            for res_name in list(limits):
                if res_name in REJECTED_RESOURCES:
                    raise Invalid(
                        f"resource {res_name!r} is not available on this cluster; "
                        f"use {GPU_RESOURCE!r} (GPU-native equivalent)"
                    )
                if not res_name.startswith(EXTENDED_RESOURCE_PREFIXES):
                    continue
                qty = int(limits.pop(res_name))
                container.resources.requests.pop(res_name, None)
                if qty <= 0:
                    continue
                per = t.PodExtendedResource(name=str(uuid.uuid4()), resource=res_name,
                                            quantity=qty)
                obj.spec.extended_resources.append(per)
                container.extended_resource_requests.append(per.name)


class ExtendedResourceToleration(AdmissionPlugin):
    """Auto-tolerate taints keyed by the extended resources a pod requests
    (ref: plugin/pkg/admission/extendedresourcetoleration/admission.go:31):
    a card pool tainted ``nvidia.com/gpu:NoSchedule`` keeps other pods off
    it, and the pods that ask for cards get the toleration here."""

    name = "ExtendedResourceToleration"

    def admit(self, operation: str, resource: str, obj, old=None, user=None):
        if resource != "pods" or operation != CREATE:
            return
        requested = {per.resource for per in obj.spec.extended_resources}
        # the pre-ResourceV2 form too (plugin order must not matter)
        for c in list(obj.spec.containers) + list(obj.spec.init_containers):
            for res_name in (c.resources.limits or {}):
                if res_name.startswith(EXTENDED_RESOURCE_PREFIXES):
                    requested.add(res_name)
        for res_name in sorted(requested):
            if not any(tol.key == res_name for tol in obj.spec.tolerations):
                obj.spec.tolerations.append(t.Toleration(key=res_name, operator="Exists"))


# ref: cmd/kube-apiserver defaulttolerationseconds: 300 s before the
# node-lifecycle taints evict the pod
DEFAULT_NOT_READY_TOLERATION_SECONDS = 300
TAINT_NODE_NOT_READY = "node.kubernetes.io/not-ready"
TAINT_NODE_UNREACHABLE = "node.kubernetes.io/unreachable"


class DefaultTolerationSeconds(AdmissionPlugin):
    """Every pod tolerates not-ready and unreachable for 300 s (ref:
    plugin/pkg/admission/defaulttolerationseconds/admission.go)."""

    name = "DefaultTolerationSeconds"

    def admit(self, operation: str, resource: str, obj, old=None, user=None):
        if resource != "pods" or operation != CREATE:
            return
        for key in (TAINT_NODE_NOT_READY, TAINT_NODE_UNREACHABLE):
            if not any(tol.key == key for tol in obj.spec.tolerations):
                obj.spec.tolerations.append(t.Toleration(
                    key=key, operator="Exists", effect="NoExecute",
                    toleration_seconds=DEFAULT_NOT_READY_TOLERATION_SECONDS))


class NodeRestriction(AdmissionPlugin):
    """Limits what a node credential (system:node:<name>) may write
    (ref: plugin/pkg/admission/noderestriction/admission.go:48,159-164).
    The NodeAuthorizer alone is not enough: its mirror-pod allowance lets a
    node create pods, and an unconstrained node-created pod bound to itself
    would make _pod_references grant the node GET on any secret/configmap/PVC
    it names — a one-step escalation to all cluster secrets. The reference
    closes this exact hole by pairing the node authorizer with this plugin."""

    name = "NodeRestriction"

    def admit(self, operation: str, resource: str, obj, old=None, user=None):
        if user is None or not user.name.startswith("system:node:"):
            return
        node_name = user.name[len("system:node:"):]
        if resource == "nodes":
            target = obj.metadata.name
            if target and target != node_name:
                raise Forbidden(
                    f"node {node_name!r} may only modify its own Node object"
                )
        if resource == "secrets":
            # a node may publish exactly one secret: its own kubelet token
            # (the authorizer can't pin the name on CREATE — the URL has
            # none — so the name check lives here)
            if (obj.metadata.namespace != "kube-system"
                    or obj.metadata.name != f"kubelet-token-{node_name}"):
                raise Forbidden(
                    f"node {node_name!r} may only write its own kubelet "
                    f"token secret"
                )
        if resource != "pods":
            return
        if operation == CREATE:
            if obj.spec.node_name != node_name:
                raise Forbidden(
                    f"node {node_name!r} may only create mirror pods bound to itself"
                )
            if obj.metadata.annotations.get(t.STATIC_POD_ANNOTATION) != "true":
                raise Forbidden(
                    f"node {node_name!r} may only create mirror (static) pods"
                )
            self._check_pod_refs(obj)
        elif operation == UPDATE and old is not None:
            if old.spec.node_name != node_name:
                raise Forbidden(
                    f"node {node_name!r} may only update pods bound to itself"
                )
            # content checks apply to updates too — otherwise create-clean
            # then PATCH-in-a-secret-volume re-opens the escalation
            self._check_pod_refs(obj)

    @staticmethod
    def _check_pod_refs(obj):
        for vol in obj.spec.volumes:
            if vol.secret is not None or vol.config_map is not None \
                    or vol.persistent_volume_claim is not None:
                raise Forbidden(
                    "node-written pods may not reference secrets, configmaps "
                    "or persistentvolumeclaims"
                )
        if obj.spec.service_account_name and obj.spec.service_account_name != "default":
            raise Forbidden("node-written pods may not use a service account")


POD_NODE_SELECTOR_ANNOTATION = "scheduler.ktpu.io/node-selector"


class PodNodeSelector(AdmissionPlugin):
    """Namespace-scoped placement policy (ref: plugin/pkg/admission/
    podnodeselector/admission.go): a namespace annotated with
    ``scheduler.ktpu.io/node-selector: pool=h100`` has that selector
    merged into every pod; a conflict with the pod's own refuses it."""

    name = "PodNodeSelector"

    def __init__(self, get_namespace):
        self._get_namespace = get_namespace  # name -> Namespace | None

    def admit(self, operation: str, resource: str, obj, old=None, user=None):
        if resource != "pods" or operation != CREATE:
            return
        ns = self._get_namespace(obj.metadata.namespace)
        if ns is None:
            return
        raw = (ns.metadata.annotations or {}).get(POD_NODE_SELECTOR_ANNOTATION)
        if not raw:
            return
        for pair in raw.split(","):
            key, _, value = pair.strip().partition("=")
            if not key:
                continue
            have = obj.spec.node_selector.get(key)
            if have is not None and have != value:
                raise Forbidden(f"pod node selector {key}={have} conflicts with the "
                                f"namespace policy {key}={value}")
            obj.spec.node_selector[key] = value


class NamespaceAutoProvision(AdmissionPlugin):
    """Creates the namespace on first use."""

    name = "NamespaceAutoProvision"

    def __init__(self, ensure_namespace):
        self._ensure = ensure_namespace

    def admit(self, operation: str, resource: str, obj, old=None, user=None):
        if operation != CREATE or resource == "namespaces":
            return
        ns = getattr(obj.metadata, "namespace", "")
        if ns:
            self._ensure(ns)


class PriorityResolver(AdmissionPlugin):
    """Resolves priorityClassName -> spec.priority (ref: priority admission)."""

    name = "PriorityResolver"

    def __init__(self, get_priority_class):
        self._get = get_priority_class

    def admit(self, operation: str, resource: str, obj, old=None, user=None):
        if resource != "pods" or operation != CREATE:
            return
        name = obj.spec.priority_class_name
        if name:
            pc = self._get(name)
            if pc is None:
                raise Invalid(f"priority class {name!r} not found")
            obj.spec.priority = pc.value


class GangDefaulter(AdmissionPlugin):
    """A pod of a scheduling gang must say the gang's size."""

    name = "GangDefaulter"

    def admit(self, operation: str, resource: str, obj, old=None, user=None):
        if resource != "pods" or operation != CREATE:
            return
        if obj.spec.scheduling_gang and obj.spec.gang_size <= 0:
            raise Invalid("scheduling_gang requires gang_size > 0")


class LimitRanger(AdmissionPlugin):
    """Applies LimitRange defaults and enforces min/max per container (ref:
    plugin/pkg/admission/limitranger/admission.go), on UPDATE too, where
    only the values the write changed are judged."""

    name = "LimitRanger"

    def __init__(self, list_limit_ranges):
        self._list = list_limit_ranges  # (namespace) -> [LimitRange]

    def admit(self, operation: str, resource: str, obj, old=None, user=None):
        if resource != "pods" or operation not in (CREATE, UPDATE):
            return
        old_limits: dict = {}
        old_requests: dict = {}
        if operation == UPDATE and old is not None:
            for oc in old.spec.containers:
                old_limits[oc.name] = dict(oc.resources.limits or {})
                old_requests[oc.name] = dict(oc.resources.requests or {})

        def changed(c_name, res, val, old_map):
            # compared as quantities: "2" -> "2000m" is no raise
            old_val = old_map.get(c_name, {}).get(res)
            if old_val is None:
                return val is not None
            try:
                return parse_quantity(old_val) != parse_quantity(val)
            except (ValueError, TypeError):
                return old_val != val

        for lr in self._list(obj.metadata.namespace):
            for item in lr.spec.limits:
                if item.type != "Container":
                    continue
                for c in obj.spec.containers:
                    if operation == CREATE:
                        for res, val in item.default.items():
                            c.resources.limits.setdefault(res, val)
                        for res, val in item.default_request.items():
                            c.resources.requests.setdefault(res, val)
                    for res, val in item.max.items():
                        have = c.resources.limits.get(res)
                        if have is None or parse_quantity(have) <= parse_quantity(val):
                            continue
                        if operation == CREATE or changed(c.name, res, have, old_limits):
                            raise Forbidden(f"container {c.name}: {res} limit {have} exceeds "
                                            f"LimitRange max {val}")
                    for res, val in item.min.items():
                        have = c.resources.requests.get(res)
                        if have is None or parse_quantity(have) >= parse_quantity(val):
                            continue
                        if operation == CREATE or changed(c.name, res, have, old_requests):
                            raise Forbidden(f"container {c.name}: {res} request {have} below "
                                            f"LimitRange min {val}")


class ResourceQuotaAdmission(AdmissionPlugin):
    """Refuses writes that would push a namespace's usage over a
    ResourceQuota's hard limit (ref: plugin/pkg/admission/resourcequota);
    usage is computed live from the store."""

    name = "ResourceQuota"

    COUNTED = {"pods", "services", "configmaps", "secrets", "replicasets",
               "persistentvolumeclaims"}

    def __init__(self, list_quotas, usage_fn):
        self._list = list_quotas  # (namespace) -> [ResourceQuota]
        self._usage = usage_fn    # (namespace) -> {resource: float}

    def admit(self, operation: str, resource: str, obj, old=None, user=None):
        if operation not in (CREATE, UPDATE) or resource not in self.COUNTED:
            return
        ns = obj.metadata.namespace
        quotas = self._list(ns)
        if not quotas:
            return
        delta = compute_object_usage(resource, obj)
        if operation == UPDATE and old is not None:
            # an update is charged only for its increase over the old object
            for res, val in compute_object_usage(resource, old).items():
                delta[res] = delta.get(res, 0.0) - val
        used = self._usage(ns)
        for q in quotas:
            for res, hard in q.spec.hard.items():
                inc = delta.get(res, 0.0)
                if inc <= 0:
                    continue
                if used.get(res, 0.0) + inc > parse_quantity(hard):
                    raise Forbidden(f"exceeded quota {q.metadata.name}: {res} "
                                    f"used {used.get(res, 0.0):g} + requested {inc:g} "
                                    f"> hard {hard}")


def compute_object_usage(resource: str, obj) -> dict:
    """Quota usage contributed by one object (ref: pkg/quota/evaluator/core)."""
    usage = {resource: 1.0, f"count/{resource}": 1.0}
    if resource == "pods":
        for c in obj.spec.containers:
            for res, val in (c.resources.requests or {}).items():
                usage[f"requests.{res}"] = usage.get(f"requests.{res}", 0.0) + parse_quantity(val)
            for res, val in (c.resources.limits or {}).items():
                usage[f"limits.{res}"] = usage.get(f"limits.{res}", 0.0) + parse_quantity(val)
        for per in obj.spec.extended_resources:
            usage[per.resource] = usage.get(per.resource, 0.0) + per.quantity
    return usage


def compute_namespace_usage(lister, namespace: str) -> dict:
    """Usage folded over every counted object of a namespace; ``lister``
    is (resource, namespace) -> objects.  Finished pods count nothing."""
    usage: dict = {}
    for resource in ResourceQuotaAdmission.COUNTED:
        for obj in lister(resource, namespace) or []:
            if resource == "pods" and obj.status.phase in (t.POD_SUCCEEDED, t.POD_FAILED):
                continue
            for res, val in compute_object_usage(resource, obj).items():
                usage[res] = usage.get(res, 0.0) + val
    return usage


class ServiceAccountAdmission(AdmissionPlugin):
    """Defaults pod.spec.serviceAccountName to 'default'
    (ref: plugin/pkg/admission/serviceaccount/admission.go)."""

    name = "ServiceAccount"

    def admit(self, operation: str, resource: str, obj, old=None, user=None):
        if resource != "pods" or operation != CREATE:
            return
        if not obj.spec.service_account_name:
            obj.spec.service_account_name = "default"


class EventRateLimit(AdmissionPlugin):
    """Token-bucket cap on event creation per source component
    (ref: plugin/pkg/admission/eventratelimit)."""

    name = "EventRateLimit"

    QPS = 50.0
    BURST = 100

    def __init__(self):
        self._buckets = {}  # source -> (tokens, last_ts)

    def admit(self, operation: str, resource: str, obj, old=None, user=None):
        if resource != "events" or operation != CREATE:
            return
        src = obj.source_component or "unknown"
        now = time.monotonic()
        tokens, last = self._buckets.get(src, (float(self.BURST), now))
        tokens = min(float(self.BURST), tokens + (now - last) * self.QPS)
        if tokens < 1.0:
            raise Forbidden(f"event rate limit exceeded for {src!r}")
        self._buckets[src] = (tokens - 1.0, now)


CREATED_BY_ANNOTATION = "ktpu.io/created-by"
CREATED_BY_GROUPS_ANNOTATION = "ktpu.io/created-by-groups"


class IdentityStamp(AdmissionPlugin):
    """Records the authenticated creator on CSRs (server-set; values the
    client sent are stripped)."""

    name = "IdentityStamp"

    STAMPED = {"certificatesigningrequests"}

    def admit(self, operation: str, resource: str, obj, old=None, user=None):
        if resource not in self.STAMPED or operation != CREATE:
            return
        obj.metadata.annotations.pop(CREATED_BY_ANNOTATION, None)
        obj.metadata.annotations.pop(CREATED_BY_GROUPS_ANNOTATION, None)
        if user is not None:
            obj.metadata.annotations[CREATED_BY_ANNOTATION] = user.name
            obj.metadata.annotations[CREATED_BY_GROUPS_ANNOTATION] = ",".join(sorted(user.groups))


class AdmissionChain:
    def __init__(self, plugins: Optional[List[AdmissionPlugin]] = None):
        self.plugins = plugins or []

    def admit(self, operation: str, resource: str, obj, old=None, user=None):
        for p in self.plugins:
            p.admit(operation, resource, obj, old, user=user)
        return obj
