"""Namespace + garbage controllers.

NamespaceController (ref: pkg/controller/namespace/): Terminating
namespaces get emptied of every namespaced resource, then finalized.

GarbageCollector (ref: pkg/controller/garbagecollector/): objects whose
controller owner reference no longer resolves are deleted — how pods die
when their Job/ReplicaSet is removed.

The port's copy of the JAX package's ``controllers/namespace.py``, over
the namespaced kinds the port's apiserver serves: JAX's leases,
podpresets, roles and rolebindings are not among them.  The namespace
controller empties a namespace through the wire-form client, by name.
"""

from __future__ import annotations

import threading
from typing import Dict

from ..machinery import ApiError, NotFound
from .base import Controller

NAMESPACED_RESOURCES = (
    "pods", "jobs", "cronjobs", "replicasets", "deployments", "daemonsets",
    "statefulsets", "services", "endpoints", "configmaps", "events",
    "secrets", "serviceaccounts", "persistentvolumeclaims",
    "resourcequotas", "limitranges", "horizontalpodautoscalers",
    "poddisruptionbudgets",
)


class NamespaceController(Controller):
    name = "namespace-controller"

    def setup(self):
        self.namespaces = self.factory.informer("namespaces")
        self.namespaces.add_handler(
            on_add=self.enqueue,
            on_update=lambda _o, n: self.enqueue(n),
        )

    def sync(self, key: str):
        ns = self.namespaces.get(key)
        if ns is None or ns.status.phase != "Terminating":
            return
        remaining = 0
        for resource in NAMESPACED_RESOURCES:
            rc = self.cs.client.resource(resource)
            items, _ = rc.list(ns.metadata.name)
            for obj in items:
                remaining += 1
                try:
                    rc.delete(
                        obj["metadata"]["name"], ns.metadata.name,
                        grace_seconds=0 if resource == "pods" else None,
                    )
                except ApiError:
                    pass
        if remaining == 0:
            try:
                self.cs.namespaces.delete(ns.metadata.name, "", grace_seconds=0)
            except ApiError:
                pass
        else:
            self.enqueue_after(key, 0.5)


# The reference's GC is fully KIND-GENERIC (graph built from every
# resource's ownerReferences, pkg/controller/garbagecollector); this
# covers the kinds that participate in ownership in practice — the
# controller-owned chain plus the config/service kinds users hang off
# their workloads (a ConfigMap owned by its Job dies with the Job).
OWNED_RESOURCES = ("pods", "replicasets", "jobs", "configmaps", "secrets",
                   "services", "persistentvolumeclaims")
OWNER_RESOURCES = ("jobs", "replicasets", "deployments", "daemonsets",
                   "statefulsets", "cronjobs", "pods", "configmaps",
                   "services", "secrets")


class GarbageCollector(Controller):
    name = "garbage-collector"

    OWNER_RESOURCE = {
        "Job": "jobs",
        "ReplicaSet": "replicasets",
        "Deployment": "deployments",
        "DaemonSet": "daemonsets",
        "StatefulSet": "statefulsets",
        "CronJob": "cronjobs",
        "Pod": "pods",
        "ConfigMap": "configmaps",
        "Service": "services",
        "Secret": "secrets",
    }

    def setup(self):
        self.informers: Dict[str, object] = {}
        # owner uid -> owned "<resource>|<key>"s: an owner's deletion
        # enqueues exactly its dependents (the reference's GC builds the
        # same dependency graph, pkg/controller/garbagecollector/graph.go)
        # — a full-cluster rescan per delete would be O(deletes x objects)
        # at 30k-pod density
        self._by_owner: Dict[str, set] = {}
        self._owner_lock = threading.Lock()
        for resource in set(OWNED_RESOURCES + OWNER_RESOURCES):
            self.informers[resource] = self.factory.informer(resource)
        for resource in OWNED_RESOURCES:
            inf = self.informers[resource]
            inf.add_handler(
                on_add=lambda o, r=resource: self._owned_added(r, o),
                on_delete=lambda o, r=resource: self._owned_removed(r, o),
            )
        for owner in OWNER_RESOURCES:
            self.informers[owner].add_handler(
                on_delete=self._owner_deleted
            )

    def _owned_added(self, resource: str, obj):
        key = f"{resource}|{obj.key()}"
        with self._owner_lock:
            for ref in obj.metadata.owner_references:
                self._by_owner.setdefault(ref.uid, set()).add(key)
        self.queue.add(key)

    def _owned_removed(self, resource: str, obj):
        key = f"{resource}|{obj.key()}"
        with self._owner_lock:
            for ref in obj.metadata.owner_references:
                deps = self._by_owner.get(ref.uid)
                if deps is not None:
                    deps.discard(key)
                    if not deps:
                        del self._by_owner[ref.uid]

    def _owner_deleted(self, obj):
        with self._owner_lock:
            deps = self._by_owner.pop(obj.metadata.uid, ())
        for key in deps:
            self.queue.add(key)

    def sync(self, key: str):
        resource, obj_key = key.split("|", 1)
        obj = self.informers[resource].get(obj_key)
        if obj is None or obj.metadata.deletion_timestamp:
            return
        for ref in obj.metadata.owner_references:
            owner_resource = self.OWNER_RESOURCE.get(ref.kind)
            if owner_resource is None:
                continue
            try:
                owner = self.cs.resource(owner_resource).get(
                    ref.name, obj.metadata.namespace
                )
                if owner.metadata.uid != ref.uid:
                    raise NotFound("uid changed")
            except NotFound:
                try:
                    self.cs.resource(resource).delete(
                        obj.metadata.name, obj.metadata.namespace,
                        grace_seconds=0 if resource == "pods" else None,
                    )
                except ApiError:
                    pass
                return
