"""ReplicaSet controller (ref: pkg/controller/replicaset/replica_set.go):
level-triggered replica reconciliation with owner-reference adoption.  The
port's copy of the JAX package's ``controllers/replicaset.py``, with two
repairs the JAX controller lacks:

- **Expectations** (ref: pkg/controller/controller_utils.go,
  ``ControllerExpectations``): a sync records the creates and deletes it
  sent, and the pods informer's events count them off as the cache sees
  them.  Until a ReplicaSet's expectations are met (or have expired) its
  sync creates and deletes nothing: a cache that lags the controller's own
  writes reads as short of pods, or over, and acting on it creates (or
  deletes) the same pods twice.
- **Scale-down order** (ref: ``controller.ActivePods``): the pods to
  delete are unscheduled ones first, then Pending before Unknown before
  Running, then not Ready before Ready, then the newest first; the JAX
  controller takes unscheduled pods and then the oldest.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List

from ..api import types as t
from ..machinery import ApiError, NotFound
from ..machinery.labels import label_selector_matches
from ..machinery.scheme import from_dict, to_dict
from .base import Controller, delete_pods_batch, write_status_if_changed

BURST = 50  # the most creates one sync makes, like the reference
_PHASE_RANK = {t.POD_PENDING: 0, t.POD_UNKNOWN: 1, t.POD_RUNNING: 2}


def owned_by(pod: t.Pod, kind: str, uid: str) -> bool:
    return any(
        ref.kind == kind and ref.uid == uid and ref.controller
        for ref in pod.metadata.owner_references
    )


def is_ready(pod: t.Pod) -> bool:
    return any(c.type == "Ready" and c.status == "True" for c in pod.status.conditions)


def scale_down_order(pods: List[t.Pod]) -> List[t.Pod]:
    """``pods`` in the order a scale-down deletes them (the reference's
    ActivePods): unscheduled, then by phase (Pending, Unknown, Running),
    then not Ready, then the newest first (the name breaks a tie)."""
    newest_first = sorted(pods, key=lambda p: (p.metadata.creation_timestamp, p.metadata.name),
                          reverse=True)
    return sorted(newest_first, key=lambda p: (
        bool(p.spec.node_name), _PHASE_RANK.get(p.status.phase, 3), is_ready(p)))


class Expectations:
    """Per ReplicaSet key: the creates not yet seen by the cache (a count)
    and the deletes not yet seen (the pods' uids), with the time they were
    set."""
    # An expectation that is not met in this long (s) is dropped (the
    # reference's ExpectationsTimeout): a lost watch event must not wedge
    # a ReplicaSet.
    TIMEOUT = 300.0

    def __init__(self):
        self._lock = threading.Lock()
        self._adds: Dict[str, int] = {}
        self._dels: Dict[str, set] = {}
        self._since: Dict[str, float] = {}

    def satisfied(self, key: str) -> bool:
        with self._lock:
            if key not in self._since:
                return True
            if (self._adds.get(key, 0) <= 0 and not self._dels.get(key)) or \
                    time.monotonic() - self._since[key] > self.TIMEOUT:
                self._forget(key)
                return True
            return False

    def expect(self, key: str, adds: int = 0, dels=()):
        with self._lock:
            self._adds[key] = adds
            self._dels[key] = set(dels)
            self._since[key] = time.monotonic()

    def creation_observed(self, key: str):
        with self._lock:
            if key in self._adds:
                self._adds[key] -= 1

    def deletion_observed(self, key: str, uid: str):
        with self._lock:
            self._dels.get(key, set()).discard(uid)

    def forget(self, key: str):
        with self._lock:
            self._forget(key)

    def _forget(self, key: str):
        self._adds.pop(key, None)
        self._dels.pop(key, None)
        self._since.pop(key, None)


class ReplicaSetController(Controller):
    name = "replicaset-controller"

    def setup(self):
        self.expectations = Expectations()
        self.rsets = self.factory.informer("replicasets")
        self.pods = self.factory.informer("pods")
        self.rsets.add_handler(
            on_add=self.enqueue,
            on_update=lambda _o, n: self.enqueue(n),
            on_delete=self._rs_deleted,
        )
        self.pods.add_handler(
            on_add=self._pod_added,
            on_update=self._pod_updated,
            on_delete=self._pod_deleted,
        )

    def _rs_deleted(self, rs: t.ReplicaSet):
        self.expectations.forget(rs.key())
        self.enqueue(rs)

    @staticmethod
    def _owner_keys(pod: t.Pod) -> List[str]:
        return [f"{pod.metadata.namespace}/{ref.name}" for ref in pod.metadata.owner_references
                if ref.kind == "ReplicaSet" and ref.controller]

    def _pod_added(self, pod: t.Pod):
        for key in self._owner_keys(pod):
            if pod.metadata.deletion_timestamp:
                self.expectations.deletion_observed(key, pod.metadata.uid)
            else:
                self.expectations.creation_observed(key)
            self.queue.add(key)

    def _pod_updated(self, old: t.Pod, pod: t.Pod):
        for key in self._owner_keys(pod):
            if pod.metadata.deletion_timestamp and not old.metadata.deletion_timestamp:
                self.expectations.deletion_observed(key, pod.metadata.uid)
            self.queue.add(key)

    def _pod_deleted(self, pod: t.Pod):
        for key in self._owner_keys(pod):
            self.expectations.deletion_observed(key, pod.metadata.uid)
            self.queue.add(key)

    def _select_pods(self, rs: t.ReplicaSet) -> List[t.Pod]:
        return [
            p
            for p in self.pods.list()
            if p.metadata.namespace == rs.metadata.namespace
            and not p.metadata.deletion_timestamp
            and label_selector_matches(rs.spec.selector, p.metadata.labels)
            and (
                owned_by(p, "ReplicaSet", rs.metadata.uid)
                or not p.metadata.owner_references  # adoptable orphan
            )
        ]

    def sync(self, key: str):
        rs = self.rsets.get(key)
        if rs is None:
            self.expectations.forget(key)
            return
        pods = self._select_pods(rs)
        alive = [p for p in pods if p.status.phase not in (t.POD_FAILED, t.POD_SUCCEEDED)]
        want = rs.spec.replicas if rs.spec.replicas is not None else 1
        diff = want - len(alive)
        if diff and self.expectations.satisfied(key):
            if diff > 0:
                self._create_pods(key, rs, min(diff, BURST))
            else:
                # the whole scale-down ships as ONE pods/delete:batch group
                # commit; a delete that failed (NotFound included, as the
                # reference does) is no longer waited for
                doomed = scale_down_order(alive)[:-diff]
                self.expectations.expect(key, dels=[p.metadata.uid for p in doomed])
                for p, err in zip(doomed, delete_pods_batch(
                        self.cs, doomed, reason="replicaset_scale_down")):
                    if err is not None:
                        self.expectations.deletion_observed(key, p.metadata.uid)
        self._update_status(rs, alive)

    def _create_pods(self, key: str, rs: t.ReplicaSet, n: int):
        self.expectations.expect(key, adds=n)
        for made in range(n):
            pod = t.Pod()
            pod.metadata.namespace = rs.metadata.namespace
            pod.metadata.generate_name = f"{rs.metadata.name}-"
            pod.metadata.labels = dict(rs.spec.template.metadata.labels)
            pod.metadata.annotations = dict(rs.spec.template.metadata.annotations)
            pod.metadata.owner_references = [
                t.OwnerReference(
                    api_version=rs.API_VERSION, kind="ReplicaSet",
                    name=rs.metadata.name, uid=rs.metadata.uid, controller=True,
                )
            ]
            pod.spec = from_dict(t.PodSpec, to_dict(rs.spec.template.spec))
            try:
                self.cs.pods.create(pod)
            except ApiError:
                # this create and the ones not tried are no longer expected
                for _ in range(n - made):
                    self.expectations.creation_observed(key)
                break

    def _update_status(self, rs: t.ReplicaSet, alive: List[t.Pod]):
        try:
            fresh = self.cs.replicasets.get(rs.metadata.name, rs.metadata.namespace)
        except NotFound:
            return
        ready = [p for p in alive if is_ready(p)]

        def apply(st):
            st.replicas = len(alive)
            st.ready_replicas = len(ready)
            st.available_replicas = len(ready)
            st.fully_labeled_replicas = len(alive)
            st.observed_generation = fresh.metadata.generation

        try:
            write_status_if_changed(self.cs.replicasets, fresh, apply)
        except ApiError:
            pass
