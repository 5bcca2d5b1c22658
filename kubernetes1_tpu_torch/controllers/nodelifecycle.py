"""Node lifecycle controller: heartbeat-based failure detection + eviction.

Ref: pkg/controller/node/node_controller.go with the reference's defaults
(options.go:96-97): a node whose Ready heartbeat is older than
monitor_grace goes NotReady; after eviction_timeout its pods are deleted so
their controllers recreate them elsewhere — the elastic-restart primitive
for preemptible hosts (a reclaimed host's workers re-form on new hosts via
the Job controller's gang failure policy).

Every API mutation routes through client/retry's shared policy (standing
invariant): transient failures — link faults, overload sheds, 5xx — back
off with full jitter and retry in place; Conflict re-runs the
read-modify-write closure; errors that outlive the budget are COUNTED
(errors_total) and retried by the next monitor pass, which recomputes the
world from the informer (the loop is level-triggered, so a dropped write
is delayed, never lost).  Evictions are counted exactly once per pod
(evictions_total) with an Event on each.

The port's copy of the JAX package's ``controllers/nodelifecycle.py``,
with its ``TaintBasedEvictions`` gate off as it is by default: a failing
node's pods fall after the flat eviction timeout, and a recovered node
still loses a NotReady taint it carries.
"""

from __future__ import annotations

import calendar
import threading
import time
import traceback

from ..api import types as t
from ..client.clientset import Clientset
from ..client.errors import is_transient, retry_on_conflict
from ..client.events import EventRecorder
from ..client.informer import InformerFactory
from ..machinery import ApiError, Conflict, NotFound, now_iso
from ..utils.metrics import Counter
from ..utils.retry import call_with_retries
from .base import delete_pods_batch


def parse_iso(ts: str) -> float:
    """Seconds since the epoch of a UTC timestamp of second or finer
    resolution (the JAX package's ``machinery.meta.parse_iso``)."""
    if "." in ts:
        base, frac = ts.rstrip("Z").split(".", 1)
        return calendar.timegm(time.strptime(base, "%Y-%m-%dT%H:%M:%S")) + float("0." + frac)
    return calendar.timegm(time.strptime(ts, "%Y-%m-%dT%H:%M:%SZ"))


class NodeLifecycleController:
    name = "node-lifecycle-controller"
    MONITOR_INTERVAL = 5.0  # s between monitor passes

    def __init__(
        self,
        clientset: Clientset,
        factory: InformerFactory,
        monitor_grace: float = 40.0,
        eviction_timeout: float = 300.0,
    ):
        self.cs = clientset
        self.factory = factory
        self.nodes = factory.informer("nodes")
        self.pods = factory.informer("pods")
        self.recorder = EventRecorder(clientset, self.name)
        self.monitor_grace = monitor_grace
        self.eviction_timeout = eviction_timeout
        self._not_ready_since: dict = {}
        # uids whose eviction was already counted+evented: the informer may
        # not deliver the deletion_timestamp before the next monitor pass,
        # and the exactly-once contract must not ride on watch latency.
        # Pruned against the live pod list each pass (a gone pod can never
        # be re-evicted), so it stays bounded under churn.
        self._evicted_uids: set = set()
        self._stop = threading.Event()
        self._thread = None
        # instance-level counters, which the controller manager process
        # serves on its /metrics
        self.evictions_total = Counter(
            "ktpu_node_evictions_total", "pods evicted off failed nodes")
        self.errors_total = Counter(
            "ktpu_nodelifecycle_errors_total",
            "API errors surviving the retry budget + monitor-pass crashes")
        self.not_ready_total = Counter(
            "ktpu_node_not_ready_transitions_total",
            "Ready->Unknown transitions this controller marked")

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    def _loop(self):
        while not self._stop.wait(self.MONITOR_INTERVAL):
            try:
                self._monitor()
            except Exception:  # noqa: BLE001 — monitor must survive; counted + next pass retries
                self.errors_total.inc()
                traceback.print_exc()

    def _mutate(self, closure):
        """One read-modify-write through the shared retry policy: transient
        failures back off with jitter, Conflict re-runs the closure against
        a fresh read.  Returns the closure's result, or None once the
        budget runs out / the object is gone — the next monitor pass
        recomputes and retries, so None is a delay, not a loss."""
        try:
            return call_with_retries(
                lambda: retry_on_conflict(closure),
                is_transient, steps=3, reason="nodelifecycle")
        except NotFound:
            return None  # already gone: the desired state holds
        except Conflict:
            return None  # persistent write race: next pass re-reads
        except (ApiError, OSError):
            self.errors_total.inc()
            return None

    def _delete_pods_batched(self, pods, grace_seconds=None,
                             reason="nodelifecycle"):
        """One pods/delete:batch per pass instead of a round-trip per
        evicted pod (a dead 110-pod node's eviction storm is the hot
        case).  Returns one bool per pod — True only when THIS pass's
        delete landed (NotFound = already gone = False, for the
        exactly-once accounting); transient per-item failures are counted
        and left to the next monitor pass."""
        if not pods:
            return []
        out = []
        for err in delete_pods_batch(self.cs, pods,
                                     grace_seconds=grace_seconds,
                                     reason=reason):
            if err is None:
                out.append(True)
            elif isinstance(err, (NotFound, Conflict)):
                out.append(False)  # already gone / write race: next pass
            else:
                self.errors_total.inc()
                out.append(False)
        return out

    def _ready_condition(self, node: t.Node):
        for cond in node.status.conditions:
            if cond.type == t.NODE_READY:
                return cond
        return None

    def _monitor(self):
        now = time.time()  # ktpulint: ignore[KTPU005] vs heartbeat API timestamps
        if self._evicted_uids:
            self._evicted_uids &= {p.metadata.uid for p in self.pods.list()}
        for node in self.nodes.list():
            name = node.metadata.name
            cond = self._ready_condition(node)
            stale = True
            if cond and cond.last_heartbeat_time:
                try:
                    stale = (now - parse_iso(cond.last_heartbeat_time)) > self.monitor_grace
                except ValueError:
                    stale = True
            if not stale and cond and cond.status == "True":
                self._not_ready_since.pop(name, None)
                # removal keys off the LISTED node's taints, not in-memory
                # state — a restarted controller must still untaint
                # recovered nodes (and skip the GET when no taint shows)
                if any(tt.key == self.NOT_READY_TAINT for tt in node.spec.taints):
                    self._remove_not_ready_taint(node)
                continue
            # node is failing: mark NotReady (if kubelet isn't doing it) and
            # start the eviction clock
            since = self._not_ready_since.setdefault(name, now)
            if stale and cond and cond.status == "True":
                self._mark_not_ready(node)
            if now - since > self.eviction_timeout:
                self._evict_pods(node)

    NOT_READY_TAINT = "node.kubernetes.io/not-ready"

    def _remove_not_ready_taint(self, node: t.Node):
        name = node.metadata.name

        def remove():
            fresh = self.cs.nodes.get(name, "")
            kept = [tt for tt in fresh.spec.taints
                    if tt.key != self.NOT_READY_TAINT]
            if len(kept) != len(fresh.spec.taints):
                fresh.spec.taints = kept
                self.cs.nodes.update(fresh)
            return True

        self._mutate(remove)

    def _mark_not_ready(self, node: t.Node):
        name = node.metadata.name

        def mark():
            fresh = self.cs.nodes.get(name, "")
            cond = self._ready_condition(fresh)
            if cond is None:
                cond = t.NodeCondition(type=t.NODE_READY)
                fresh.status.conditions.append(cond)
            if cond.status == "Unknown":
                return None  # someone (or a prior pass) already marked it
            cond.status = "Unknown"
            cond.reason = "NodeStatusUnknown"
            cond.message = "kubelet stopped posting node status"
            cond.last_transition_time = now_iso()
            self.cs.nodes.update_status(fresh)
            return fresh

        fresh = self._mutate(mark)
        if fresh is not None:
            self.not_ready_total.inc()
            self.recorder.event(
                fresh, "Warning", "NodeNotReady",
                f"node {name} heartbeat stale",
            )

    def _evict_pods(self, node: t.Node):
        finalize, fresh = [], []
        for pod in self.pods.list():
            if pod.spec.node_name != node.metadata.name:
                continue
            if pod.status.phase in (t.POD_SUCCEEDED, t.POD_FAILED):
                continue  # finished pods hold no resources; leave the record
            if pod.metadata.deletion_timestamp:
                # kubelet is gone and can't finalize: force delete so the
                # controller can replace the pod (not a new eviction — it
                # was counted when the graceful delete landed)
                finalize.append(pod)
                continue
            if pod.metadata.uid in self._evicted_uids:
                continue  # counted; waiting on the watch to show the delete
            fresh.append(pod)
        # a dead node's whole pod set evicts/finalizes as TWO batch
        # requests (graceful + grace-0) instead of a round-trip per pod
        self._delete_pods_batched(finalize, grace_seconds=0,
                                  reason="nodelifecycle_finalize")
        for pod, landed in zip(fresh, self._delete_pods_batched(
                fresh, reason="nodelifecycle_evict")):
            if landed:
                self._evicted_uids.add(pod.metadata.uid)
                self.evictions_total.inc()
                self.recorder.event(
                    pod, "Warning", "NodeEviction",
                    f"evicted: node {node.metadata.name} unreachable",
                )
