"""Controller base: informer-fed, workqueue-driven reconcilers.  The port's
copy of the JAX package's ``controllers/base.py``.

Ref: the universal controller shape in pkg/controller/ — informer events
enqueue keys into a rate-limited workqueue; N workers pop and call a
level-triggered sync that compares desired vs actual and writes the
difference through the API (never acting on the event payload itself).
"""

from __future__ import annotations

import threading
import traceback
from typing import List

from ..client.clientset import Clientset
from ..client.errors import ApiError, is_transient
from ..client.events import EventRecorder
from ..client.informer import InformerFactory
from ..machinery.scheme import to_dict
from ..utils.retry import call_with_retries
from ..utils.workqueue import RateLimitingQueue


def delete_pods_batch(cs: Clientset, pods, grace_seconds=None,
                      reason: str = "pod_delete_batch"):
    """Delete N pods through ONE pods/delete:batch request per namespace
    (the deletion half of the group-commit write path) — the shared leg
    for every hot delete caller (gang teardown, replicaset scale-down,
    podgc sweeps, node-lifecycle eviction).

    Per-pod outcomes come back aligned with `pods`: None on success or
    the ApiError that sank that member (NotFound comes back as the error
    so exactly-once accounting callers can tell "I deleted it" from
    "already gone").  An ENVELOPE-level failure (transport fault, an apiserver
    without the batch leg) falls back to singleton deletes through the
    shared retry policy, so a controller on a degraded wire degrades to
    exactly the pre-batch behavior instead of dropping the pass."""
    if not pods:
        return []
    outcomes = [None] * len(pods)
    by_ns = {}
    for i, p in enumerate(pods):
        by_ns.setdefault(p.metadata.namespace, []).append(i)
    for ns, idxs in by_ns.items():
        items = [{"name": pods[i].metadata.name} for i in idxs]
        try:
            results = cs.delete_batch(ns, items, grace_seconds=grace_seconds)
            if len(results) != len(idxs):
                raise ApiError(
                    f"malformed delete:batch response: {len(results)} "
                    f"results for {len(items)} items")
        except (ApiError, OSError):
            # envelope failed: per-pod fallback (idempotent — a delete
            # that DID land answers NotFound, which is success here)
            for i in idxs:
                p = pods[i]
                try:
                    call_with_retries(
                        lambda p=p: cs.pods.delete(
                            p.metadata.name, p.metadata.namespace,
                            grace_seconds=grace_seconds),
                        is_transient, steps=3, reason=reason)
                except (ApiError, OSError) as e:
                    outcomes[i] = e  # NotFound included: caller decides
            continue
        for i, err in zip(idxs, results):
            outcomes[i] = err
    return outcomes


def write_status_if_changed(client, obj, mutate) -> bool:
    """Apply mutate(obj.status) and PUT the status subresource only when it
    actually changed. A no-op status write still bumps resourceVersion and
    fires a MODIFIED event, which re-triggers the writing controller's own
    informer (an infinite write storm) and conflicts every other writer out
    of its get→update window — the replicaset/deployment livelock."""
    before = to_dict(obj.status)
    mutate(obj.status)
    if to_dict(obj.status) == before:
        return False
    client.update_status(obj)
    return True


class Controller:
    name = "controller"
    WORKERS = 2  # threads popping the queue

    def __init__(self, clientset: Clientset, factory: InformerFactory):
        self.cs = clientset
        self.factory = factory
        self.queue = RateLimitingQueue()
        self.recorder = EventRecorder(clientset, self.name)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    # subclasses wire informer handlers in setup() and implement sync(key)

    def setup(self):
        raise NotImplementedError

    def sync(self, key: str):
        raise NotImplementedError

    def enqueue(self, obj):
        self.queue.add(obj.key())

    def enqueue_after(self, key: str, delay: float):
        self.queue.add_after(key, delay)

    def start_workers(self):
        for i in range(self.WORKERS):
            th = threading.Thread(
                target=self._worker, daemon=True, name=f"{self.name}-{i}"
            )
            th.start()
            self._threads.append(th)
        return self

    def start(self):
        self.setup()
        return self.start_workers()

    def stop(self):
        self._stop.set()
        self.queue.shut_down()

    def _worker(self):
        while not self._stop.is_set():
            key = self.queue.get(timeout=0.5)
            if key is None:
                continue
            try:
                self.sync(key)
                self.queue.forget(key)
            except Exception:  # noqa: BLE001 - a failed sync retries with backoff
                traceback.print_exc()
                self.queue.add_rate_limited(key)
            finally:
                self.queue.done(key)
