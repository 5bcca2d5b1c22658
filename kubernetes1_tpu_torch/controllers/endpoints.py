"""Endpoints controller (ref: pkg/controller/endpoint/): services select
ready pods into Endpoints objects — the discovery substrate kube-proxy and
the serving balancers resolve against.  The port's copy of the JAX
package's ``controllers/endpoints.py``.

Churn fan-out (the endpointslice-batching analog): by default every pod
event touching a service's selector triggers one full Endpoints rewrite —
under actor-swarm churn that is one write per service per pod event, and
the writes (each a full-object PUT bumping resourceVersion) become the
dominant control-plane load.  With ``coalesce_window > 0`` the controller
keeps a per-service DIRTY set instead: the first event arms one delayed
flush, every further event inside the window is absorbed
(``ktpu_endpoints_coalesced_total``), and the flush recomputes the object
from the informers — level-triggered, so the final object always equals
what the uncoalesced controller would have written.  ``coalesce_window=0``
(the default) keeps today's immediate enqueue byte-for-byte.

The propagation-lag SLI (``ktpu_endpoints_propagation_seconds``) measures
the OLDEST unserved pod event to the Endpoints write that folds it in —
the staleness a consumer resolving the service can actually observe; it
is measured at window 0 too, so a coalescing A/B compares like for like.
"""

from __future__ import annotations

import threading
import time
from typing import Dict

from ..api import types as t
from ..machinery import AlreadyExists, ApiError, NotFound
from ..machinery.labels import match_labels
from ..utils.metrics import Counter, Histogram
from .base import Controller

# Module-level (the utils/retry retries_total pattern): one process-wide
# surface regardless of controller instances; the controller manager
# process exports them from its own /metrics.
endpoints_writes_total = Counter(
    "ktpu_endpoints_writes_total",
    "Endpoints object writes (update/create) committed")
endpoints_coalesced_total = Counter(
    "ktpu_endpoints_coalesced_total",
    "pod churn events absorbed by an already-armed coalesced flush")
endpoints_propagation_seconds = Histogram(
    "ktpu_endpoints_propagation_seconds",
    "oldest unserved pod event to the Endpoints write folding it in",
    buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
             10.0))


class EndpointsController(Controller):
    name = "endpoints-controller"

    def __init__(self, clientset, factory, coalesce_window: float = 0.0):
        super().__init__(clientset, factory)
        # seconds one service's flush waits to absorb more churn; 0 =
        # immediate enqueue (today's wire, byte-identical)
        self.coalesce_window = max(0.0, float(coalesce_window))
        self._dirty_lock = threading.Lock()
        # svc key -> monotonic time of the OLDEST event not yet folded
        # into a committed write (the propagation-lag numerator)
        self._dirty_since: Dict[str, float] = {}
        # svc keys with a delayed flush armed (window > 0 only): events
        # landing while armed are the coalesced ones
        self._armed: set = set()

    def setup(self):
        self.services = self.factory.informer("services")
        self.pods = self.factory.informer("pods")
        self.services.add_handler(
            on_add=self.enqueue,
            on_update=lambda _o, n: self.enqueue(n),
            on_delete=self._service_deleted,
        )
        self.pods.add_handler(
            on_add=self._pod_event,
            on_update=lambda _o, n: self._pod_event(n),
            on_delete=self._pod_event,
        )

    def _service_deleted(self, svc: t.Service):
        key = svc.key()
        with self._dirty_lock:
            self._armed.discard(key)
            self._dirty_since.pop(key, None)
        try:
            self.cs.endpoints.delete(svc.metadata.name, svc.metadata.namespace)
        except ApiError:
            pass

    def _pod_event(self, pod: t.Pod):
        for svc in self.services.list():
            if svc.metadata.namespace == pod.metadata.namespace and match_labels(
                svc.spec.selector, pod.metadata.labels
            ):
                self._mark_dirty(svc)

    def _mark_dirty(self, svc: t.Service):
        key = svc.key()
        with self._dirty_lock:
            self._dirty_since.setdefault(key, time.monotonic())
            if self.coalesce_window > 0:
                if key in self._armed:
                    # a flush is already armed for this window: this
                    # event rides it — one write absorbs N churn events
                    endpoints_coalesced_total.inc()
                    return
                self._armed.add(key)
        if self.coalesce_window > 0:
            self.enqueue_after(key, self.coalesce_window)
        else:
            self.queue.add(key)

    def sync(self, key: str):
        with self._dirty_lock:
            self._armed.discard(key)
            dirty_t0 = self._dirty_since.pop(key, None)
        svc = self.services.get(key)
        if svc is None:
            return
        if not svc.spec.selector:
            # selector-less service: endpoints are managed manually
            # (ref: endpoints_controller.go skips services w/o selector)
            return
        selected = [
            p
            for p in self.pods.list()
            if p.metadata.namespace == svc.metadata.namespace
            and match_labels(svc.spec.selector, p.metadata.labels)
            and p.status.phase == t.POD_RUNNING
        ]
        ready_pods = [
            p
            for p in selected
            if not p.metadata.deletion_timestamp
            and any(
                c.type == "Ready" and c.status == "True" for c in p.status.conditions
            )
        ]
        # the DRAIN signal, made explicit: terminating or not-Ready pods
        # leave `addresses` (no new traffic) but stay visible in
        # `not_ready_addresses` so an L7 balancer can tell "draining"
        # from "gone" and keep in-flight responses alive
        ready_names = {p.metadata.name for p in ready_pods}
        draining_pods = [p for p in selected
                         if p.metadata.name not in ready_names]
        subset = t.EndpointSubset(
            addresses=[
                t.EndpointAddress(ip=p.status.pod_ip or p.status.host_ip, node_name=p.spec.node_name,
                                  target_ref=p.metadata.name)
                for p in sorted(ready_pods, key=lambda p: p.metadata.name)
            ],
            not_ready_addresses=[
                t.EndpointAddress(ip=p.status.pod_ip or p.status.host_ip, node_name=p.spec.node_name,
                                  target_ref=p.metadata.name)
                for p in sorted(draining_pods, key=lambda p: p.metadata.name)
            ],
            ports=[
                t.EndpointPort(name=sp.name, port=sp.target_port or sp.port, protocol=sp.protocol)
                for sp in svc.spec.ports
            ],
        )
        eps = t.Endpoints(subsets=[subset] if subset.addresses
                          or subset.not_ready_addresses else [])
        eps.metadata.name = svc.metadata.name
        eps.metadata.namespace = svc.metadata.namespace
        wrote = True
        try:
            try:
                existing = self.cs.endpoints.get(svc.metadata.name, svc.metadata.namespace)
                eps.metadata.resource_version = existing.metadata.resource_version
                eps.metadata.uid = existing.metadata.uid
                eps.metadata.creation_timestamp = existing.metadata.creation_timestamp
                self.cs.endpoints.update(eps)
            except NotFound:
                try:
                    self.cs.endpoints.create(eps, svc.metadata.namespace)
                except AlreadyExists:
                    # a PEER's create landed, not ours: no write to
                    # count, and its content may predate our dirty
                    # event — re-sync to fold it in
                    wrote = False
        except Exception:
            # failed write: the informer state is still dirty — restore
            # the stamp so the retry's eventual write reports the true
            # (longer) propagation lag instead of dropping the sample
            if dirty_t0 is not None:
                with self._dirty_lock:
                    cur = self._dirty_since.get(key)
                    self._dirty_since[key] = (
                        dirty_t0 if cur is None else min(cur, dirty_t0))
            raise
        if not wrote:
            if dirty_t0 is not None:
                with self._dirty_lock:
                    cur = self._dirty_since.get(key)
                    self._dirty_since[key] = (
                        dirty_t0 if cur is None else min(cur, dirty_t0))
            self.queue.add(key)
            return
        endpoints_writes_total.inc()
        if dirty_t0 is not None:
            endpoints_propagation_seconds.observe(
                time.monotonic() - dirty_t0)
