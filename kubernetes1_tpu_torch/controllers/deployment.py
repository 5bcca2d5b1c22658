"""Deployment controller (ref: pkg/controller/deployment/): rollout via
template-hashed ReplicaSets — RollingUpdate scales the new RS up and old
ones down within maxSurge/maxUnavailable; Recreate kills old first.  The
port's copy of the JAX package's ``controllers/deployment.py``: the same
``pod-template-hash`` (sha1 of the template's sorted JSON) for the same
template."""

from __future__ import annotations

import hashlib
import json
import math
from typing import List, Optional

from ..api import types as t
from ..client.errors import retry_on_conflict
from ..machinery import AlreadyExists, ApiError, NotFound
from ..machinery.scheme import from_dict, to_dict
from .base import Controller, write_status_if_changed

HASH_LABEL = "pod-template-hash"


REVISION_ANNOTATION = "deployment.ktpu.io/revision"


def revision_of(rs) -> int:
    """The RS's stamped rollout revision; 0 = not yet stamped by the
    controller."""
    try:
        return int((rs.metadata.annotations or {})
                   .get(REVISION_ANNOTATION, "0"))
    except ValueError:
        return 0


def template_hash(spec: t.PodTemplateSpec) -> str:
    canon = json.dumps(to_dict(spec), sort_keys=True)
    return hashlib.sha1(canon.encode()).hexdigest()[:10]


def resolve_portion(value, total: int, round_up: bool) -> int:
    if isinstance(value, str) and value.endswith("%"):
        frac = float(value[:-1]) / 100.0
        return math.ceil(frac * total) if round_up else math.floor(frac * total)
    return int(value)


class DeploymentController(Controller):
    name = "deployment-controller"

    def setup(self):
        self.deployments = self.factory.informer("deployments")
        self.rsets = self.factory.informer("replicasets")
        self.deployments.add_handler(
            on_add=self.enqueue,
            on_update=lambda _o, n: self.enqueue(n),
            on_delete=self.enqueue,
        )
        self.rsets.add_handler(
            on_add=self._rs_event,
            on_update=lambda _o, n: self._rs_event(n),
            on_delete=self._rs_event,
        )

    def _rs_event(self, rs: t.ReplicaSet):
        for ref in rs.metadata.owner_references:
            if ref.kind == "Deployment" and ref.controller:
                self.queue.add(f"{rs.metadata.namespace}/{ref.name}")

    def _owned_rsets(self, dep: t.Deployment) -> List[t.ReplicaSet]:
        return [
            rs
            for rs in self.rsets.list()
            if rs.metadata.namespace == dep.metadata.namespace
            and any(
                ref.kind == "Deployment" and ref.uid == dep.metadata.uid
                for ref in rs.metadata.owner_references
            )
        ]

    def sync(self, key: str):
        dep = self.deployments.get(key)
        if dep is None or dep.spec.paused:
            return
        want_hash = template_hash(dep.spec.template)
        owned = self._owned_rsets(dep)
        new_rs = next(
            (rs for rs in owned if rs.metadata.labels.get(HASH_LABEL) == want_hash),
            None,
        )
        old = [rs for rs in owned if rs is not new_rs]
        replicas = dep.spec.replicas if dep.spec.replicas is not None else 1

        if new_rs is None:
            new_rs = self._create_rs(dep, want_hash, initial=0 if old else replicas)
            if new_rs is None:
                return
        new_rs = self._ensure_revision(new_rs, old)

        if dep.spec.strategy.type == "Recreate":
            if any((rs.spec.replicas or 0) > 0 for rs in old):
                for rs in old:
                    self._scale(rs, 0)
                return
            self._scale(new_rs, replicas)
        else:
            self._rolling(dep, new_rs, old, replicas)
        self._cleanup_old(dep, old)
        self._update_status(dep, new_rs, owned)

    def _ensure_revision(self, new_rs: t.ReplicaSet,
                         old: List[t.ReplicaSet]) -> t.ReplicaSet:
        """Revision bookkeeping (ref: deployment_util.go maxRevision/
        SetNewReplicaSetAnnotations): the active RS always carries the
        highest revision — a rollback reuses an OLD RS, which then gets a
        fresh max+1 number rather than its historical one."""
        max_old = max([revision_of(rs) for rs in old] or [0])
        if revision_of(new_rs) > max_old:
            return new_rs
        # a failed stamp must propagate: the worker requeues with backoff,
        # so the active RS never silently stays at revision 0
        return self.cs.replicasets.patch(
            new_rs.metadata.name,
            {"metadata": {"annotations": {
                REVISION_ANNOTATION: str(max_old + 1)}}},
            new_rs.metadata.namespace)

    def _create_rs(self, dep: t.Deployment, hash_: str, initial: int) -> Optional[t.ReplicaSet]:
        rs = t.ReplicaSet()
        rs.metadata.name = f"{dep.metadata.name}-{hash_}"
        rs.metadata.namespace = dep.metadata.namespace
        rs.metadata.labels = {**dep.spec.template.metadata.labels, HASH_LABEL: hash_}
        rs.metadata.owner_references = [
            t.OwnerReference(
                api_version=dep.API_VERSION, kind="Deployment",
                name=dep.metadata.name, uid=dep.metadata.uid, controller=True,
            )
        ]
        rs.spec.replicas = initial
        sel = from_dict(t.LabelSelector, to_dict(dep.spec.selector)) if dep.spec.selector else t.LabelSelector()
        sel.match_labels = {**sel.match_labels, HASH_LABEL: hash_}
        rs.spec.selector = sel
        rs.spec.template = from_dict(t.PodTemplateSpec, to_dict(dep.spec.template))
        rs.spec.template.metadata.labels = dict(rs.metadata.labels)
        try:
            return self.cs.replicasets.create(rs)
        except AlreadyExists:
            try:
                return self.cs.replicasets.get(rs.metadata.name, rs.metadata.namespace)
            except NotFound:
                return None

    def _scale(self, rs: t.ReplicaSet, replicas: int):
        if (rs.spec.replicas or 0) == replicas:
            return

        def attempt():
            fresh = self.cs.replicasets.get(rs.metadata.name, rs.metadata.namespace)
            fresh.spec.replicas = replicas
            return self.cs.replicasets.update(fresh)

        try:
            retry_on_conflict(attempt)
        except ApiError:
            pass  # re-enqueued by the next RS event

    def _rolling(self, dep, new_rs, old: List[t.ReplicaSet], replicas: int):
        ru = dep.spec.strategy.rolling_update
        max_surge = resolve_portion(ru.max_surge, replicas, round_up=True)
        max_unavail = resolve_portion(ru.max_unavailable, replicas, round_up=False)
        if max_surge == 0 and max_unavail == 0:
            max_unavail = 1
        old_total = sum(rs.spec.replicas or 0 for rs in old)
        new_want = rs_replicas = new_rs.spec.replicas or 0

        # scale new up within surge budget
        total_allowed = replicas + max_surge
        headroom = total_allowed - (old_total + rs_replicas)
        if headroom > 0 and rs_replicas < replicas:
            self._scale(new_rs, min(replicas, rs_replicas + headroom))
            return  # next event continues the rollout
        # scale old down within availability budget (ready count proxies
        # availability; informer status lags one beat, acceptable here)
        new_ready = (self.rsets.get(new_rs.key()) or new_rs).status.ready_replicas
        min_available = replicas - max_unavail
        can_remove = (new_ready + old_total) - min_available
        if can_remove > 0:
            for rs in sorted(old, key=lambda r: r.metadata.creation_timestamp):
                cur = rs.spec.replicas or 0
                if cur == 0:
                    continue
                step = min(cur, can_remove)
                self._scale(rs, cur - step)
                break

    def _cleanup_old(self, dep, old: List[t.ReplicaSet]):
        zeroed = [
            rs
            for rs in old
            if (rs.spec.replicas or 0) == 0 and rs.status.replicas == 0
        ]
        keep = dep.spec.revision_history_limit
        for rs in zeroed[: max(0, len(zeroed) - keep)]:
            try:
                self.cs.replicasets.delete(rs.metadata.name, rs.metadata.namespace)
            except ApiError:
                pass

    def _update_status(self, dep, new_rs, owned):
        try:
            fresh = self.cs.deployments.get(dep.metadata.name, dep.metadata.namespace)
        except NotFound:
            return
        live = [self.rsets.get(rs.key()) or rs for rs in owned]
        new_live = self.rsets.get(new_rs.key()) or new_rs

        def apply(st):
            st.replicas = sum(rs.status.replicas for rs in live)
            st.ready_replicas = sum(rs.status.ready_replicas for rs in live)
            st.available_replicas = st.ready_replicas
            st.updated_replicas = new_live.status.replicas
            st.unavailable_replicas = max(
                0, (fresh.spec.replicas or 1) - st.ready_replicas
            )
            st.observed_generation = fresh.metadata.generation

        try:
            write_status_if_changed(self.cs.deployments, fresh, apply)
        except ApiError:
            pass
