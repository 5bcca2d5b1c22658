"""Pod garbage collector (ref: pkg/controller/podgc/gc_controller.go):
(1) deletes pods bound to nodes that no longer exist (orphaned pods — the
elastic-recovery path after a host is replaced), (2) caps the number of
terminated pods kept around for inspection.  The port's copy of the JAX
package's ``controllers/podgc.py``."""

from __future__ import annotations

import time

from ..api import types as t
from .base import Controller, delete_pods_batch

RESYNC = 5.0  # the reference's gcCheckPeriod is 20s


class PodGCController(Controller):
    name = "podgc-controller"
    WORKERS = 1
    TERMINATED_POD_THRESHOLD = 100  # finished pods kept for inspection
    # A node must be missing this long (s) before its pods are deleted — the
    # pods and nodes informers are independent watch streams, so a
    # just-registered node can briefly be absent from our cache while its
    # first bound pod is already present (upstream quarantines likewise).
    QUARANTINE = 2 * RESYNC

    def __init__(self, clientset, factory):
        super().__init__(clientset, factory)
        self._missing_since: dict = {}  # node_name -> monotonic first-seen-missing
        self._tick_key = "podgc/tick"

    def setup(self):
        self.pods = self.factory.informer("pods")
        self.nodes = self.factory.informer("nodes")
        self.queue.add(self._tick_key)

    def sync(self, key: str):
        try:
            self._gc_orphaned()
            self._gc_terminated()
        finally:
            self.enqueue_after(self._tick_key, RESYNC)

    def _gc_orphaned(self):
        if not self.nodes.has_synced():
            return
        node_names = {n.metadata.name for n in self.nodes.list()}
        now = time.monotonic()
        for known in [n for n in self._missing_since if n in node_names]:
            del self._missing_since[known]
        doomed = []
        for p in self.pods.list():
            node = p.spec.node_name
            if not node or node in node_names or p.metadata.deletion_timestamp:
                continue
            first = self._missing_since.setdefault(node, now)
            if now - first < self.QUARANTINE:
                continue
            doomed.append(p)
        # the whole orphan sweep finalizes through ONE delete:batch group
        # commit (a replaced host orphans its pods all at once)
        for p, err in zip(doomed, delete_pods_batch(
                self.cs, doomed, grace_seconds=0, reason="podgc_orphaned")):
            if err is None:
                self.recorder.event(
                    p, "Normal", "PodGC",
                    f"deleted orphaned pod bound to missing node "
                    f"{p.spec.node_name}",
                )

    def _gc_terminated(self):
        terminated = [
            p for p in self.pods.list()
            if p.status.phase in (t.POD_SUCCEEDED, t.POD_FAILED)
            and not p.metadata.deletion_timestamp
            and not p.metadata.owner_references  # keep controller-owned history
        ]
        excess = len(terminated) - self.TERMINATED_POD_THRESHOLD
        if excess <= 0:
            return
        terminated.sort(key=lambda p: p.metadata.creation_timestamp)
        # one batch for the whole cap sweep (outcomes ignored: the next
        # resync re-lists and retries anything that didn't land)
        delete_pods_batch(self.cs, terminated[:excess], grace_seconds=0,
                          reason="podgc_terminated")
