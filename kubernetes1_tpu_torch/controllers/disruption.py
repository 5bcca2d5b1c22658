"""Disruption controller (ref: pkg/controller/disruption/disruption.go):
maintains PodDisruptionBudget status so voluntary evictions (the eviction
subresource) know how many pods they may remove.  A PDB over a multi-card
gang keeps maintenance from silently breaking a training job's world
membership.  The port's copy of the JAX package's
``controllers/disruption.py``."""

from __future__ import annotations

from ..api import types as t
from ..machinery import ApiError, NotFound
from ..machinery.labels import label_selector_matches
from .base import Controller


def _is_healthy(pod: t.Pod) -> bool:
    return (
        not pod.metadata.deletion_timestamp
        and pod.status.phase == t.POD_RUNNING
        and any(c.type == "Ready" and c.status == "True" for c in pod.status.conditions)
    )


class DisruptionController(Controller):
    name = "disruption-controller"

    def setup(self):
        self.pdbs = self.factory.informer("poddisruptionbudgets")
        self.pods = self.factory.informer("pods")
        self.pdbs.add_handler(
            on_add=self.enqueue, on_update=lambda _o, n: self.enqueue(n)
        )
        self.pods.add_handler(
            on_add=self._pod_event,
            on_update=lambda _o, n: self._pod_event(n),
            on_delete=self._pod_event,
        )

    def _pod_event(self, pod: t.Pod):
        for pdb in self.pdbs.list():
            if pdb.metadata.namespace == pod.metadata.namespace and (
                pdb.spec.selector is not None
                and label_selector_matches(pdb.spec.selector, pod.metadata.labels)
            ):
                self.enqueue(pdb)

    def sync(self, key: str):
        pdb = self.pdbs.get(key)
        if pdb is None or pdb.spec.selector is None:
            return
        matching = [
            p for p in self.pods.list()
            if p.metadata.namespace == pdb.metadata.namespace
            and label_selector_matches(pdb.spec.selector, p.metadata.labels)
        ]
        expected = len([p for p in matching if not p.metadata.deletion_timestamp])
        healthy = len([p for p in matching if _is_healthy(p)])
        if pdb.spec.min_available is not None:
            desired_healthy = pdb.spec.min_available
        elif pdb.spec.max_unavailable is not None:
            desired_healthy = max(0, expected - pdb.spec.max_unavailable)
        else:
            desired_healthy = expected
        allowed = max(0, healthy - desired_healthy)
        st = pdb.status
        if (
            st.current_healthy == healthy
            and st.desired_healthy == desired_healthy
            and st.expected_pods == expected
            and st.disruptions_allowed == allowed
        ):
            return
        try:
            fresh = self.cs.poddisruptionbudgets.get(
                pdb.metadata.name, pdb.metadata.namespace
            )
            fresh.status.current_healthy = healthy
            fresh.status.desired_healthy = desired_healthy
            fresh.status.expected_pods = expected
            fresh.status.disruptions_allowed = allowed
            fresh.status.observed_generation = fresh.metadata.generation
            self.cs.poddisruptionbudgets.update_status(fresh)
        except (NotFound, ApiError):
            pass  # requeued on the next pod event
