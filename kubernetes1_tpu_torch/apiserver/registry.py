"""REST registry: per-resource storage strategies over the MVCC store, the
port's copy of the JAX package's ``apiserver/registry.py`` (ref:
pkg/registry/).  Each resource has a strategy (defaulting, validation)
and shares the generic create, update, delete, list and watch; the pod's
Binding subresource applies the scheduler's placement and its device
assignment in one GuaranteedUpdate (registry/core/pod/storage/
storage.go:138-195), with a device-claim index so that two binds racing
one card cannot both win.

One rule differs from the JAX registry: a pod whose ``spec.nodeName`` is
set refuses any further binding with 409 Conflict (``_apply_binding``).
"""

from __future__ import annotations

import random
import string
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..api import types as t
from ..machinery import labels as labelutil
from ..machinery.errors import (AlreadyExists, BadRequest, Conflict, Forbidden, Invalid,
                                NotFound, TooManyRequests)
from ..machinery.meta import now_iso
from ..machinery.scheme import Scheme, to_dict
from ..storage import StopUpdate, Store
from ..storage.cacher import selector_indexes
from ..utils.cron import parse_cron

_NAME_SUFFIX_ALPHABET = string.ascii_lowercase + string.digits


def _rand_suffix(n=5):
    return "".join(random.choice(_NAME_SUFFIX_ALPHABET) for _ in range(n))


# The scheme leaves default-valued fields out of the wire form, so a field
# selector evaluated on the encoded dict must know each selectable field's
# default per resource: `status.phase=Pending` matches a pod whose phase
# was never written (upstream's per-resource fieldSelectorConversions).
_FIELD_DEFAULTS = {
    ("pods", "status.phase"): "Pending",
    ("persistentvolumeclaims", "status.phase"): "Pending",
    ("namespaces", "status.phase"): "Active",
    ("persistentvolumes", "status.phase"): "Available",
}


def field_get(obj_dict: Dict[str, Any], dotted: str, resource: str = "") -> Any:
    cur: Any = obj_dict
    for part in dotted.split("."):
        if not isinstance(cur, dict):
            cur = None
            break
        cur = cur.get(part)
    if cur is None:
        return _FIELD_DEFAULTS.get((resource, dotted), "")
    return cur


def parse_field_selector(s: str) -> List[Tuple[str, str, str]]:
    """'spec.nodeName=x,status.phase!=Failed' -> [(path, op, value)]."""
    out = []
    for part in (p for p in s.split(",") if p.strip()):
        if "!=" in part:
            k, v = part.split("!=", 1)
            out.append((k.strip(), "!=", v.strip()))
        elif "=" in part:
            k, v = part.split("=", 1)
            out.append((k.strip(), "=", v.strip()))
        else:
            raise BadRequest(f"invalid field selector {part!r}")
    return out


def field_selector_matches(reqs, obj_dict, resource: str = "") -> bool:
    for path, op, val in reqs:
        have = str(field_get(obj_dict, path, resource))
        if op == "=" and have != val:
            return False
        if op == "!=" and have == val:
            return False
    return True


class Strategy:
    """Per-resource defaulting and validation hooks."""

    def prepare_for_create(self, obj):
        pass

    def validate(self, obj):
        if not obj.metadata.name:
            raise Invalid("metadata.name is required")

    def prepare_for_update(self, new, old):
        # immutable system metadata survives client writes
        new.metadata.uid = old.metadata.uid
        new.metadata.creation_timestamp = old.metadata.creation_timestamp


class PodStrategy(Strategy):
    def prepare_for_create(self, obj):
        if not obj.spec.restart_policy:
            obj.spec.restart_policy = "Always"
        for c in obj.spec.containers:
            if not c.name:
                raise Invalid("container name required")

    def validate(self, obj):
        super().validate(obj)
        if not obj.spec.containers:
            raise Invalid("spec.containers must not be empty")
        # unique across init and app containers: the kubelet keys runtime
        # state by (pod, name)
        names = [c.name for c in obj.spec.containers] + [c.name for c in obj.spec.init_containers]
        if len(set(names)) != len(names):
            raise Invalid("duplicate container names")
        seen = set()
        for per in obj.spec.extended_resources:
            if per.name in seen:
                raise Invalid(f"duplicate extended resource {per.name!r}")
            seen.add(per.name)
            if per.quantity <= 0:
                raise Invalid("extended resource quantity must be > 0")
        valid = {per.name for per in obj.spec.extended_resources}
        for c in obj.spec.containers:
            for ref in c.extended_resource_requests:
                if ref not in valid:
                    raise Invalid(f"container {c.name} references unknown extended "
                                  f"resource {ref!r}")
        vol_names = set()
        for v in obj.spec.volumes:
            if v.name in vol_names:
                raise Invalid(f"duplicate volume name {v.name!r}")
            vol_names.add(v.name)
            sources = [s for s in (v.host_path, v.empty_dir, v.config_map, v.secret,
                                   v.persistent_volume_claim, v.downward_api) if s is not None]
            if len(sources) != 1:
                raise Invalid(f"volume {v.name!r} must have exactly one source")
        for c in obj.spec.containers + obj.spec.init_containers:
            for vm in c.volume_mounts:
                if vm.name not in vol_names:
                    raise Invalid(f"container {c.name}: volumeMount {vm.name!r} "
                                  f"references no pod volume")

    def prepare_for_update(self, new, old):
        super().prepare_for_update(new, old)
        # nodeName is write-once outside the binding subresource
        if old.spec.node_name and new.spec.node_name != old.spec.node_name:
            raise Forbidden("pod.spec.nodeName is immutable once set; use the binding "
                            "subresource")
        # the container set is immutable, and resource values may be
        # raised but never removed (ref ValidatePodUpdate)
        for clist in ("containers", "init_containers"):
            old_by_name = {c.name: c for c in getattr(old.spec, clist)}
            new_list = getattr(new.spec, clist)
            if {c.name for c in new_list} != set(old_by_name):
                raise Forbidden(f"pod.spec.{clist} may not be added, removed, or renamed "
                                f"on update")
            for c in new_list:
                oc = old_by_name[c.name]
                for kind in ("limits", "requests"):
                    old_map = getattr(oc.resources, kind) or {}
                    # a None value is a removal too (a replaced containers
                    # array carries nulls through verbatim)
                    new_map = {k: v for k, v in (getattr(c.resources, kind) or {}).items()
                               if v is not None}
                    setattr(c.resources, kind, new_map)
                    gone = set(old_map) - set(new_map)
                    if gone:
                        raise Forbidden(f"container {c.name}: resource {kind} {sorted(gone)} "
                                        f"may not be removed on update")


class JobStrategy(Strategy):
    def prepare_for_create(self, obj):
        if obj.spec.parallelism is None:
            obj.spec.parallelism = 1
        if obj.spec.completion_mode not in ("NonIndexed", "Indexed"):
            raise Invalid("completionMode must be NonIndexed or Indexed")
        if obj.spec.selector is None:
            obj.spec.selector = t.LabelSelector(match_labels={t.JOB_NAME_LABEL: obj.metadata.name})
            obj.spec.template.metadata.labels.setdefault(t.JOB_NAME_LABEL, obj.metadata.name)


class ReplicaSetStrategy(Strategy):
    def prepare_for_create(self, obj):
        if obj.spec.replicas is None:
            obj.spec.replicas = 1

    def validate(self, obj):
        super().validate(obj)
        if obj.spec.selector is None or (
                not obj.spec.selector.match_labels and not obj.spec.selector.match_expressions):
            raise Invalid("spec.selector is required")
        if not labelutil.label_selector_matches(obj.spec.selector,
                                                obj.spec.template.metadata.labels):
            raise Invalid("selector does not match template labels")


class StatefulSetStrategy(ReplicaSetStrategy):
    def validate(self, obj):
        super().validate(obj)
        if obj.spec.pod_management_policy not in ("OrderedReady", "Parallel"):
            raise Invalid("podManagementPolicy must be OrderedReady or Parallel")
        if obj.spec.update_strategy.type not in ("RollingUpdate", "OnDelete"):
            raise Invalid("updateStrategy.type must be RollingUpdate or OnDelete")


class ServiceStrategy(Strategy):
    def validate(self, obj):
        super().validate(obj)
        if obj.spec.type not in ("ClusterIP", "NodePort"):
            raise Invalid("service type must be ClusterIP or NodePort")
        if not obj.spec.ports and obj.spec.cluster_ip != "None":
            raise Invalid("spec.ports is required")
        names = [p.name for p in obj.spec.ports]
        if len(obj.spec.ports) > 1 and len(set(names)) != len(names):
            raise Invalid("port names must be unique")
        for p in obj.spec.ports:
            if not (0 < p.port < 65536):
                raise Invalid(f"invalid port {p.port}")

    def prepare_for_update(self, new, old):
        super().prepare_for_update(new, old)
        if old.spec.cluster_ip and new.spec.cluster_ip != old.spec.cluster_ip:
            raise Forbidden("spec.clusterIP is immutable")


class CSRStrategy(Strategy):
    """A CSR's spec and the server-stamped creator identity are immutable
    after create (ref: pkg/registry/certificates)."""

    def prepare_for_update(self, new, old):
        super().prepare_for_update(new, old)
        new.spec = old.spec
        from .admission import CREATED_BY_ANNOTATION, CREATED_BY_GROUPS_ANNOTATION

        for ann in (CREATED_BY_ANNOTATION, CREATED_BY_GROUPS_ANNOTATION):
            if ann in old.metadata.annotations:
                new.metadata.annotations[ann] = old.metadata.annotations[ann]
            else:
                new.metadata.annotations.pop(ann, None)


class CronJobStrategy(Strategy):
    def validate(self, obj):
        super().validate(obj)
        try:
            parse_cron(obj.spec.schedule)
        except ValueError as e:
            raise Invalid(f"spec.schedule: {e}")
        if obj.spec.concurrency_policy not in ("Allow", "Forbid", "Replace"):
            raise Invalid("concurrencyPolicy must be Allow, Forbid or Replace")


_STRATEGIES = {
    "pods": PodStrategy(),
    "jobs": JobStrategy(),
    "replicasets": ReplicaSetStrategy(),
    "deployments": ReplicaSetStrategy(),
    "statefulsets": StatefulSetStrategy(),
    "cronjobs": CronJobStrategy(),
    "services": ServiceStrategy(),
    "certificatesigningrequests": CSRStrategy(),
}
_DEFAULT_STRATEGY = Strategy()


def strategy_for(resource: str) -> Strategy:
    return _STRATEGIES.get(resource, _DEFAULT_STRATEGY)


class Registry:
    """All-resource REST storage over the store, used by the HTTP server."""

    # Service VIP and NodePort allocation (ref: pkg/registry/core/service/
    # ipallocator + portallocator): a scan of the service list under
    # _svc_lock, which also covers the store write.
    SERVICE_CIDR_PREFIX = "10.96."  # /16
    NODE_PORT_RANGE = (30000, 32767)
    # PDB CAS retries against the disruption controller (ref eviction.go:57)
    EVICTION_PDB_RETRIES = 10
    # A fresh device claim is "in flight" until its bind commits: within
    # this window it is trusted without a store read.
    CLAIM_PENDING_GRACE_SECONDS = 30.0

    def __init__(self, store: Store, scheme: Scheme):
        self.store = store
        self.scheme = scheme
        self._ns_lock = threading.Lock()
        self._svc_lock = threading.Lock()
        # the cards a bound pod owns, (node, resource, card id) -> (pod key,
        # pod uid, pending-until): the bind path claims cards here first and
        # answers a loser Conflict with the DEVICE_CLAIM_CONFLICT marker.
        # Stale entries are checked against the store on collision.
        self._claims_lock = threading.Lock()
        self._device_claims: Dict[tuple, tuple] = {}
        self._claims_seeded = False

    # ------------------------------------------------------------------ keys

    def key(self, resource: str, namespace: str, name: str) -> str:
        if self.scheme.namespaced.get(resource, True):
            if not namespace:
                raise BadRequest(f"{resource} is namespaced; namespace required")
            return f"/registry/{resource}/{namespace}/{name}"
        return f"/registry/{resource}/{name}"

    def prefix(self, resource: str, namespace: str = "") -> str:
        if namespace and self.scheme.namespaced.get(resource, True):
            return f"/registry/{resource}/{namespace}/"
        return f"/registry/{resource}/"

    # ------------------------------------------------------------- namespace

    def ensure_namespace(self, name: str):
        with self._ns_lock:
            key = self.key("namespaces", "", name)
            if self.store.get_or_none(key) is None:
                ns = t.Namespace()
                ns.metadata.name = name
                try:
                    self.store.create(key, ns)
                except AlreadyExists:
                    pass

    def check_namespace_active(self, name: str):
        ns = self.store.get_or_none(self.key("namespaces", "", name))
        if ns is not None and ns.status.phase == "Terminating":
            raise Forbidden(f"namespace {name} is terminating")

    # ------------------------------------------------------------ operations

    def create(self, resource: str, namespace: str, obj):
        if self.scheme.namespaced.get(resource, True):
            obj.metadata.namespace = namespace or obj.metadata.namespace or "default"
        else:
            obj.metadata.namespace = ""
        if not obj.metadata.name and obj.metadata.generate_name:
            obj.metadata.name = obj.metadata.generate_name + _rand_suffix()
        strat = strategy_for(resource)
        strat.prepare_for_create(obj)
        strat.validate(obj)
        if self.scheme.namespaced.get(resource, True):
            self.check_namespace_active(obj.metadata.namespace)
        key = self.key(resource, obj.metadata.namespace, obj.metadata.name)
        if resource == "services":
            # allocation and commit are one critical section
            with self._svc_lock:
                self._allocate_service_fields(obj)
                return self.store.create(key, obj)
        return self.store.create(key, obj)

    def _allocate_service_fields(self, obj):
        """Allocate or check clusterIP and nodePorts; the caller holds
        _svc_lock.  The object's own earlier allocations are free."""
        items, _ = self.store.list(self.prefix("services"))
        items = [s for s in items
                 if not (s.metadata.namespace == obj.metadata.namespace
                         and s.metadata.name == obj.metadata.name)]
        used_ips = {s.spec.cluster_ip for s in items}
        used_ports = {p.node_port for s in items for p in s.spec.ports if p.node_port}
        if not obj.spec.cluster_ip:  # "None" = headless; a user-set IP is kept
            for i in range(1, 255 * 255):
                ip = f"{self.SERVICE_CIDR_PREFIX}{i // 255}.{i % 255 + 1}"
                if ip not in used_ips:
                    obj.spec.cluster_ip = ip
                    break
            else:
                raise Invalid("service IP range exhausted")
        elif obj.spec.cluster_ip != "None":
            if obj.spec.cluster_ip in used_ips:
                raise Invalid(f"clusterIP {obj.spec.cluster_ip} already allocated")
            if not obj.spec.cluster_ip.startswith(self.SERVICE_CIDR_PREFIX):
                raise Invalid(f"clusterIP must be in {self.SERVICE_CIDR_PREFIX}0.0/16")
        if obj.spec.type == "NodePort":
            lo, hi = self.NODE_PORT_RANGE
            nxt = lo
            seen_here = set()
            for p in obj.spec.ports:
                if p.node_port:
                    if (p.node_port in used_ports or p.node_port in seen_here
                            or not lo <= p.node_port <= hi):
                        raise Invalid(f"nodePort {p.node_port} unavailable")
                    seen_here.add(p.node_port)
            for p in obj.spec.ports:
                if not p.node_port:
                    while nxt in used_ports or nxt in seen_here:
                        nxt += 1
                    if nxt > hi:
                        raise Invalid("nodePort range exhausted")
                    p.node_port = nxt
                    seen_here.add(nxt)
        else:
            for p in obj.spec.ports:
                p.node_port = 0

    def get(self, resource: str, namespace: str, name: str):
        try:
            return self.store.get(self.key(resource, namespace, name))
        except NotFound:
            raise NotFound(f'{resource} "{name}" not found') from None

    def update(self, resource: str, namespace: str, name: str, obj):
        strat = strategy_for(resource)
        key = self.key(resource, namespace, name)
        old = self.store.get(key)
        strat.prepare_for_update(obj, old)
        if obj.metadata.generation or old.metadata.generation:
            if to_dict(getattr(obj, "spec", None)) != to_dict(getattr(old, "spec", None)):
                obj.metadata.generation = old.metadata.generation + 1
            else:
                obj.metadata.generation = old.metadata.generation
        if resource == "services":
            with self._svc_lock:
                self._allocate_service_fields(obj)
                strat.validate(obj)
                return self.store.update_cas(key, obj)
        strat.validate(obj)
        return self.store.update_cas(key, obj)

    def update_status(self, resource: str, namespace: str, name: str, obj):
        """Status subresource: only .status lands."""
        key = self.key(resource, namespace, name)

        def apply(cur):
            if obj.metadata.resource_version and (
                    obj.metadata.resource_version != cur.metadata.resource_version):
                raise Conflict(f"{name}: resourceVersion mismatch on status update")
            if hasattr(cur, "status"):
                cur.status = obj.status
            return cur

        return self.store.guaranteed_update(key, apply)

    def patch(self, resource: str, namespace: str, name: str, patch: Dict[str, Any],
              admit: Optional[Callable[[Any, Any], Any]] = None):
        """RFC 7386 JSON merge patch in a GuaranteedUpdate; ``admit`` runs
        the admission chain on the merged object."""
        key = self.key(resource, namespace, name)

        def apply(cur):
            obj = self.scheme.decode(_merge_patch(self.scheme.encode(cur), patch))
            if obj is None:
                raise BadRequest("the patch changes the object's kind")
            obj.metadata.resource_version = cur.metadata.resource_version
            if admit is not None:
                obj = admit(obj, cur) or obj
            strat = strategy_for(resource)
            strat.prepare_for_update(obj, cur)
            if resource == "services":
                self._allocate_service_fields(obj)
            strat.validate(obj)  # a patch must not persist an invalid object
            return obj

        if resource == "services":
            with self._svc_lock:
                return self.store.guaranteed_update(key, apply)
        return self.store.guaranteed_update(key, apply)

    def delete(self, resource: str, namespace: str, name: str,
               grace_seconds: Optional[int] = None):
        key = self.key(resource, namespace, name)
        obj = self.store.get(key)
        if resource == "pods":
            return self._delete_pod(key, obj, grace_seconds)
        if resource == "namespaces":
            # grace 0 finalizes (the namespace controller's last step);
            # otherwise the namespace is marked Terminating
            if grace_seconds == 0:
                return self.store.delete(key)
            return self._delete_namespace(obj)
        return self.store.delete(key)

    def _delete_pod(self, key, pod, grace_seconds):
        """Graceful pod deletion: a scheduled, unfinished pod gets its
        deletionTimestamp and the kubelet finalizes it with grace 0;
        unscheduled or finished pods go at once."""
        if grace_seconds is None:
            grace_seconds = pod.spec.termination_grace_period_seconds
        finished = pod.status.phase in (t.POD_SUCCEEDED, t.POD_FAILED)
        if grace_seconds == 0 or not pod.spec.node_name or finished:
            deleted = self.store.delete(key)
            # the cards stop blocking replacements now; released from the
            # committed object, which a racing bind may have changed
            self._release_claims(self._chips_of(deleted), deleted.metadata.uid)
            return deleted

        def mark(cur):
            if cur.metadata.deletion_timestamp:
                raise StopUpdate()
            cur.metadata.deletion_timestamp = now_iso()
            return cur

        try:
            return self.store.guaranteed_update(key, mark)
        except StopUpdate:
            return pod

    def delete_batch(self, resource: str, namespace: str,
                     items: List[Dict[str, Any]]) -> List[Optional[Exception]]:
        """N deletions through one store commit per round, each item with
        the singleton path's rules; items fail independently.  Each item is
        {"name", "namespace" (optional), "grace_seconds" (int or None),
        "resource_version" (an optional precondition: a mismatch is a
        terminal Conflict)}.  Returns None or the ApiError per item."""
        if resource == "namespaces":
            raise BadRequest("namespaces cannot be batch-deleted (Terminating flow)")
        results: List[Optional[Exception]] = [None] * len(items)
        keys: Dict[int, str] = {}
        for i, it in enumerate(items):
            name = (it.get("name") or "").strip()
            if not name:
                results[i] = BadRequest("delete item requires a name")
                continue
            try:
                keys[i] = self.key(resource, it.get("namespace") or namespace or "default", name)
            except BadRequest as e:
                results[i] = e
        pending = list(keys)
        while pending:
            raws = self.store.get_raw_many([keys[i] for i in pending])
            ops, op_idx = [], []
            pod_deletes: set = set()
            for i, raw in zip(pending, raws):
                if raw is None:
                    results[i] = NotFound(f'{resource} "{items[i].get("name")}" not found')
                    continue
                expect = items[i].get("resource_version") or ""
                rv = (raw.get("metadata") or {}).get("resourceVersion", "")
                if expect and expect != rv:
                    results[i] = Conflict(f'{items[i].get("name")}: resourceVersion mismatch '
                                          f'(have {rv}, want {expect})')
                    continue
                if resource != "pods":
                    ops.append({"op": "delete", "key": keys[i], "expect_rv": expect})
                    op_idx.append(i)
                    continue
                pod = self.scheme.decode(raw)
                grace = items[i].get("grace_seconds")
                if grace is None:
                    grace = pod.spec.termination_grace_period_seconds
                finished = pod.status.phase in (t.POD_SUCCEEDED, t.POD_FAILED)
                if grace == 0 or not pod.spec.node_name or finished:
                    ops.append({"op": "delete", "key": keys[i], "expect_rv": expect})
                    op_idx.append(i)
                    pod_deletes.add(i)
                    continue
                if pod.metadata.deletion_timestamp:
                    results[i] = None  # already terminating: a no-op success
                    continue
                pod.metadata.deletion_timestamp = now_iso()
                ops.append({"op": "update_cas", "key": keys[i],
                            "obj": self.scheme.encode(pod), "expect_rv": rv})
                op_idx.append(i)
            if not ops:
                break
            outs = self.store.commit_batch(ops)
            retry = []
            for i, out in zip(op_idx, outs):
                err = out.get("error")
                if err is None:
                    results[i] = None
                    if i in pod_deletes:
                        committed = out.get("obj") or {}
                        self._release_claims(self._chips_of_raw(committed),
                                             (committed.get("metadata") or {}).get("uid", ""))
                elif isinstance(err, Conflict) and not items[i].get("resource_version"):
                    retry.append(i)  # a CAS race on a graceful mark: re-read
                else:
                    results[i] = err
            pending = retry
        return results

    def evict(self, namespace: str, name: str, eviction: Optional[t.Eviction] = None):
        """Eviction subresource: delete the pod only if no matching
        PodDisruptionBudget would be violated, consuming the budget with a
        CAS decrement (ref: pkg/registry/core/pod/storage/eviction.go:57)."""
        pod = self.store.get(self.key("pods", namespace, name))
        # a terminating or finished pod's disruption has happened already
        charging = (not pod.metadata.deletion_timestamp
                    and pod.status.phase not in (t.POD_SUCCEEDED, t.POD_FAILED))
        if charging:
            pdbs, _ = self.list("poddisruptionbudgets", namespace)
            matching = [p for p in pdbs if p.spec.selector is not None
                        and labelutil.label_selector_matches(p.spec.selector,
                                                             pod.metadata.labels)]
            if len(matching) > 1:
                raise Invalid(f"pod {name} matches multiple PodDisruptionBudgets; "
                              f"eviction cannot arbitrate")
            if matching:
                self._consume_disruption(matching[0])
        grace = eviction.grace_period_seconds if eviction is not None else None
        return self.delete("pods", namespace, name, grace_seconds=grace)

    def _consume_disruption(self, pdb: t.PodDisruptionBudget):
        ns, pdb_name = pdb.metadata.namespace, pdb.metadata.name
        for _ in range(self.EVICTION_PDB_RETRIES):
            fresh = self.get("poddisruptionbudgets", ns, pdb_name)
            if (fresh.metadata.generation
                    and fresh.status.observed_generation < fresh.metadata.generation):
                raise TooManyRequests(f"pod disruption budget {pdb_name} is stale "
                                      f"(status lags spec); retry later")
            if fresh.status.disruptions_allowed <= 0:
                raise TooManyRequests(f"cannot evict pod as it would violate the pod "
                                      f"disruption budget {pdb_name}")
            fresh.status.disruptions_allowed -= 1
            try:
                self.update_status("poddisruptionbudgets", ns, pdb_name, fresh)
                return
            except Conflict:
                continue  # the disruption controller or a parallel eviction won
        raise TooManyRequests(f"too many concurrent evictions against {pdb_name}; retry")

    def _delete_namespace(self, ns):
        """Mark Terminating; the namespace controller empties it and then
        finalizes it with grace 0."""
        def mark(cur):
            cur.status.phase = "Terminating"
            if not cur.metadata.deletion_timestamp:
                cur.metadata.deletion_timestamp = now_iso()
            return cur

        return self.store.guaranteed_update(self.key("namespaces", "", ns.metadata.name), mark)

    def list(self, resource: str, namespace: str = "", label_selector: str = "",
             field_selector: str = ""):
        entries, rev = self.list_entries(self.store, resource, namespace,
                                         label_selector=label_selector,
                                         field_selector=field_selector)
        return [self.scheme.decode(d) for _k, _r, d in entries], rev

    def select_entries(self, via, resource: str, namespace: str = "",
                       label_selector: str = "", field_selector: str = ""):
        """(entries, rev, match): key-sorted candidate (key, rev, obj)
        entries from ``via`` (the watch cache or the store), and a
        predicate of every selector requirement (None when unfiltered).
        An equality field requirement on a declared index is answered from
        the cache's index; ``match`` re-checks everything, so the result
        is the scan's."""
        lreqs = labelutil.parse_selector(label_selector) if label_selector else None
        freqs = parse_field_selector(field_selector) if field_selector else None
        prefix = self.prefix(resource, namespace)
        entries = rev = None
        if freqs:
            lookup = getattr(via, "list_raw_indexed", None)
            if lookup is not None:
                for path, op, val in freqs:
                    if op != "=":
                        continue  # indexes answer equality only
                    got = lookup(prefix, path, val)
                    if got is not None:
                        entries, rev = got
                        break
        if entries is None:
            entries, rev = via.list_raw(prefix)
        if lreqs is None and freqs is None:
            return entries, rev, None

        def match(d) -> bool:
            if lreqs is not None and not labelutil.selector_matches(
                    lreqs, (d.get("metadata") or {}).get("labels") or {}):
                return False
            return freqs is None or field_selector_matches(freqs, d, resource)

        return entries, rev, match

    def list_entries(self, via, resource: str, namespace: str = "",
                     label_selector: str = "", field_selector: str = ""):
        """Selector-filtered (key, rev, obj) entries and the revision."""
        entries, rev, match = self.select_entries(via, resource, namespace,
                                                  label_selector=label_selector,
                                                  field_selector=field_selector)
        if match is not None:
            entries = [e for e in entries if match(e[2])]
        return entries, rev

    def watch(self, resource: str, namespace: str = "", since_rev: int = 0,
              label_selector: str = "", field_selector: str = "", via=None):
        """A watcher from ``via`` (the watch cache, else the store), with
        ``event_matches``, its selectors' predicate, attached for the
        serving loop.  An equality requirement on a declared index buckets
        the watcher in the cache's dispatch index."""
        source = via if via is not None else self.store
        kw = {}
        lreqs = labelutil.parse_selector(label_selector) if label_selector else None
        freqs = parse_field_selector(field_selector) if field_selector else None
        if freqs and via is not None:
            declared = selector_indexes(resource)
            for path, op, val in freqs:
                if op == "=" and path in declared:
                    kw["index_hint"] = (path, val)
                    break
        w = source.watch(self.prefix(resource, namespace), since_rev, **kw)

        def event_matches(obj_dict) -> bool:
            if lreqs is not None and not labelutil.selector_matches(
                    lreqs, (obj_dict.get("metadata") or {}).get("labels") or {}):
                return False
            return freqs is None or field_selector_matches(freqs, obj_dict, resource)

        w.event_matches = event_matches
        return w

    # ---------------------------------------------------------------- binding

    @staticmethod
    def _apply_binding(pod, pod_name: str, binding: t.Binding):
        """Fold one Binding into a pod (the singleton and bulk paths share
        it).  A pod that is already bound refuses every binding, to its own
        node too: the JAX registry accepts a same-node rebinding
        (``registry.py:991``), which overwrites the pod's cards, where the
        reference refuses any binding of an assigned pod
        (pkg/registry/core/pod/storage/storage.go:138-195) and the
        apiserver's contract says "re-bind must 409" (the verify skill's
        flow 3)."""
        if pod.spec.node_name:
            raise Conflict(f"pod {pod_name} already bound to {pod.spec.node_name}")
        pod.spec.node_name = binding.target_node
        by_name = {per.name: per for per in pod.spec.extended_resources}
        for req_name, ids in binding.extended_resource_assignments.items():
            per = by_name.get(req_name)
            if per is None:
                raise Invalid(f"unknown extended resource {req_name!r} in binding")
            if len(ids) != per.quantity:
                raise Invalid(f"binding assigns {len(ids)} devices to {req_name}, "
                              f"want {per.quantity}")
            per.assigned = list(ids)
        pod.metadata.annotations.pop(t.NOMINATED_NODE_ANNOTATION, None)
        # the binding's observability stamps are merged (prefix-gated), and
        # the commit is the authoritative bound-at instant
        for k, v in (binding.metadata.annotations or {}).items():
            if k.startswith(("slo.ktpu.io/", "trace.ktpu.io/")):
                pod.metadata.annotations[k] = v
        pod.metadata.annotations[t.BOUND_AT_ANNOTATION] = f"{time.time():.6f}"
        return pod

    @staticmethod
    def _chips_of(pod) -> List[tuple]:
        """(node, resource, card id) triples a bound pod owns."""
        node = pod.spec.node_name
        return [(node, per.resource or per.name, cid)
                for per in pod.spec.extended_resources for cid in (per.assigned or [])]

    @staticmethod
    def _chips_of_raw(d: Dict[str, Any]) -> List[tuple]:
        """_chips_of over an encoded wire dict."""
        spec = d.get("spec") or {}
        node = spec.get("nodeName")
        if not node:
            return []
        return [(node, per.get("resource") or per.get("name") or "", cid)
                for per in spec.get("extendedResources") or []
                for cid in per.get("assigned") or []]

    def _seed_claims_locked(self):
        """The first claim after startup rebuilds the index from every
        bound pod in the store."""
        entries, _rev = self.store.list_raw(self.prefix("pods"))
        for key, _r, d in entries:
            uid = (d.get("metadata") or {}).get("uid", "")
            for claim in self._chips_of_raw(d):
                self._device_claims[claim] = (key, uid, 0.0)
        self._claims_seeded = True

    def _claim_is_live(self, claim_key: tuple, holder_key: str, holder_uid: str,
                       pending_until: float) -> bool:
        """Does the recorded holder still hold this card?  An in-flight
        claim does; a committed one is checked against the store."""
        if time.monotonic() < pending_until:
            return True
        raw = self.store.get_raw_many([holder_key])[0]
        if raw is None or (raw.get("metadata") or {}).get("uid") != holder_uid:
            return False
        return claim_key in self._chips_of_raw(raw)

    def _claim_devices(self, pod, pod_key: str) -> List[tuple]:
        """Claim every card a just-applied binding assigns, all or nothing:
        Conflict (DEVICE_CLAIM_CONFLICT) when a live claim of another pod
        holds one; stale claims are purged and the claim retried."""
        wanted = self._chips_of(pod)
        if not wanted:
            return wanted
        uid = pod.metadata.uid
        while True:
            with self._claims_lock:
                if not self._claims_seeded:
                    self._seed_claims_locked()
                conflicts = [(k, self._device_claims[k]) for k in wanted
                             if self._device_claims.get(k) is not None
                             and self._device_claims[k][1] != uid]
                if not conflicts:
                    deadline = time.monotonic() + self.CLAIM_PENDING_GRACE_SECONDS
                    for k in wanted:
                        self._device_claims[k] = (pod_key, uid, deadline)
                    return wanted
            for k, (holder_key, holder_uid, pend) in conflicts:
                if self._claim_is_live(k, holder_key, holder_uid, pend):
                    raise Conflict(f"{t.DEVICE_CLAIM_CONFLICT}: {k[1]} chip {k[2]} "
                                   f"on node {k[0]} is held by pod {holder_key}")
            with self._claims_lock:
                for k, cur in conflicts:
                    if self._device_claims.get(k) == cur:
                        del self._device_claims[k]

    def _release_claims(self, claim_keys: List[tuple], uid: str):
        """Undo this pod's claims (a racer may have re-claimed a purged key)."""
        with self._claims_lock:
            for k in claim_keys:
                if self._device_claims.get(k, ("", "", 0.0))[1] == uid:
                    del self._device_claims[k]

    def _confirm_claims(self, claim_keys: List[tuple], uid: str):
        """The bind committed: the store now proves the claim."""
        with self._claims_lock:
            for k in claim_keys:
                cur = self._device_claims.get(k)
                if cur is not None and cur[1] == uid:
                    self._device_claims[k] = (cur[0], uid, 0.0)

    def bind(self, namespace: str, pod_name: str, binding: t.Binding):
        """Apply the scheduler's placement in one GuaranteedUpdate (ref:
        storage.go:147,181-186), the cards claimed before the commit."""
        key = self.key("pods", namespace, pod_name)
        claimed: dict = {}

        def update(pod):
            updated = self._apply_binding(pod, pod_name, binding)
            if "keys" not in claimed:
                claimed["keys"] = self._claim_devices(updated, key)
                claimed["uid"] = updated.metadata.uid
            return updated

        try:
            bound = self.store.guaranteed_update(key, update)
        except Exception:
            self._release_claims(claimed.get("keys") or [], claimed.get("uid", ""))
            raise
        self._confirm_claims(claimed.get("keys") or [], claimed.get("uid", ""))
        return bound

    def bind_batch(self, namespace: str,
                   bindings: List[t.Binding]) -> List[Optional[Exception]]:
        """Bind N pods (a gang, or a burst of the scheduler's bind queue)
        through one store commit per round; members fail independently.
        Returns None or the ApiError per binding.  CAS races re-read and
        re-apply; real conflicts are errors."""
        results: List[Optional[Exception]] = [None] * len(bindings)
        keys: Dict[int, str] = {}
        claims: Dict[int, tuple] = {}
        for i, b in enumerate(bindings):
            try:
                keys[i] = self.key("pods", b.metadata.namespace or namespace or "default",
                                   b.metadata.name)
            except BadRequest as e:
                results[i] = e
        pending = list(keys)
        committed: set = set()
        try:
            while pending:
                raws = self.store.get_raw_many([keys[i] for i in pending])
                ops, op_idx = [], []
                for i, raw in zip(pending, raws):
                    b = bindings[i]
                    if raw is None:
                        results[i] = NotFound(f'pods "{b.metadata.name}" not found')
                        continue
                    pod = self.scheme.decode(raw)
                    try:
                        pod = self._apply_binding(pod, b.metadata.name, b)
                        if i not in claims:
                            claims[i] = (self._claim_devices(pod, keys[i]), pod.metadata.uid)
                    except (Conflict, Invalid) as e:
                        results[i] = e
                        continue
                    ops.append({"op": "update_cas", "key": keys[i],
                                "obj": self.scheme.encode(pod),
                                "expect_rv": raw["metadata"]["resourceVersion"]})
                    op_idx.append(i)
                if not ops:
                    break
                outs = self.store.commit_batch(ops)
                retry = []
                for i, out in zip(op_idx, outs):
                    err = out.get("error")
                    if err is None:
                        results[i] = None
                        committed.add(i)
                    elif isinstance(err, Conflict):
                        retry.append(i)
                    else:
                        results[i] = err
                pending = retry
        finally:
            # committed items keep their claims; the rest release them
            for i, (claim_keys, uid) in claims.items():
                if i in committed:
                    self._confirm_claims(claim_keys, uid)
                else:
                    self._release_claims(claim_keys, uid)
        return results


def _merge_patch(target: Any, patch: Any) -> Any:
    if not isinstance(patch, dict):
        return patch
    if not isinstance(target, dict):
        target = {}
    out = dict(target)
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        else:
            out[k] = _merge_patch(out.get(k), v)
    return out
