"""The scheduler control loop: watch unbound pods, place, bind.

The port's copy of the JAX package's ``scheduler/scheduler.py`` (ref:
plugin/pkg/scheduler/scheduler.go:430 scheduleOne +
core/generic_scheduler.go:109-161 Schedule (findNodesThatFit ->
device allocation -> PrioritizeNodes -> selectHost), scheduler.go:365
assume, :482-496 async bind, :209-250 preemption), over the port's typed
client.  Beyond the reference:
- Gang scheduling: pods carrying (namespace, scheduling_gang, gang_size)
  are placed all-or-nothing.  Placement is simulated on cloned NodeInfos
  (a partial allocation rolls back by dropping the simulation); the gang
  first tries one NVLink domain that holds it whole, so its collectives
  stay on NVLink, then any node set.
- Device-ID allocation with attribute affinity is part of filtering (a
  node without matching healthy cards is infeasible), best fit by NVLink
  domain (``devices.py``).

Left out of the JAX scheduler, with their flags: policy extenders, shards
and shard leases, leader election, the persistent bind stream and the
``pybin1`` bind codec.  The bind pool's size and the scheduler's name are
constants, and gangs are always placed all or nothing (the JAX
scheduler's ``--bind-workers``, ``--scheduler-name`` and GangScheduling
gate).
"""

from __future__ import annotations

import json
import queue
import threading
import time
import traceback
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from ..api import types as t
from ..client.clientset import Clientset
from ..client.events import EventRecorder
from ..machinery import ApiError, Conflict, NotFound, TooManyRequests
from ..machinery.labels import label_selector_matches
from ..machinery.scheme import to_dict
from ..utils import retry as _retry
from ..utils.logutil import RateLimitedReporter
from ..utils.metrics import Histogram, MetricsServer, Registry
from ..utils.spans import SpanCollector
from ..utils.trace import Trace
from .cache import NodeInfo, SchedulerCache
from .devices import allocate_for_pod, domain_of, fits_devices
from .predicates import EquivalenceCache, PodAffinityChecker, run_predicates
from .priorities import prioritize
from .queue import SchedulingQueue

# Feasibility sampling (upstream percentageOfNodesToScore): on big clusters
# stop the filter scan once this many feasible nodes are found — scoring 100
# candidates instead of 1000 loses almost nothing (scores are local to a
# node) and caps schedule() at O(feasible) instead of O(cluster).
MIN_FEASIBLE_TO_FIND = 100
FEASIBLE_PERCENT = 0.05

# Op tracing (ref generic_scheduler.go:110-112 utiltrace usage): a
# scheduling attempt slower than this logs its per-step breakdown.
TRACE_THRESHOLD_S = 0.1


def _json_key(obj) -> str:
    return json.dumps(obj, sort_keys=True, default=str)


class ScheduleResult:
    def __init__(self, node: str, assignments: Dict[str, List[str]]):
        self.node = node
        self.assignments = assignments


class _BindItem:
    """One queued bind: everything a bind worker needs to ship it, alone
    or as part of a bulk request (the greedy bind-queue drain groups items
    by namespace and POSTs them as one pods/bindings:batch).  ``single``
    marks an item re-queued by a failed bulk envelope: it ships as a
    singleton (never in a bulk request that would fail the same way), but
    through the worker pool, so the fallback drains in parallel."""

    __slots__ = ("pod", "assumed", "binding", "result", "tid", "single")

    def __init__(self, pod, assumed, binding, result, tid, single=False):
        self.pod = pod
        self.assumed = assumed
        self.binding = binding
        self.result = result
        self.tid = tid
        self.single = single


class Scheduler:
    # an incomplete gang waits this long before its GangIncomplete event
    GANG_WAIT_SECONDS = 30.0
    MAX_BIND_BATCH = 128  # per-request cap on bulk binds
    BIND_WORKERS = 8  # bind pool size
    # the pods this scheduler places: those whose spec names it
    NAME = "default-scheduler"

    def __init__(
        self,
        clientset: Clientset,
        metrics_port: Optional[int] = None,  # None = no endpoint; 0 = ephemeral
    ):
        self.cs = clientset
        self.cache = SchedulerCache()
        self.queue = SchedulingQueue()
        self.factory = clientset.informers()
        self.pods = self.factory.informer("pods")
        self.nodes = self.factory.informer("nodes")
        self.pdbs = self.factory.informer("poddisruptionbudgets")
        self.recorder = EventRecorder(clientset, "scheduler")
        self._gang_first_seen: Dict[Tuple[str, str], float] = {}
        self._gang_victims: Dict[Tuple[str, str], set] = {}
        self._gang_lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self.equiv_cache = EquivalenceCache()
        self._scan_offset = 0  # rotates so sampling spreads over the cluster
        # persistent bind workers (ref scheduler.go:482 async bind): a pool
        # reuses per-thread HTTP connections instead of a thread per bind.
        # Each worker drains the queue greedily: everything queued when it
        # wakes ships as ONE bulk pods/bindings:batch request (gang members
        # land together: _assume_and_bind enqueues them back to back).
        self._bind_q: "queue.Queue" = queue.Queue()
        # /metrics surface (ref plugin/pkg/scheduler/metrics/): queue wait
        # under a create burst is not attempt latency, so both are kept
        self.metrics = Registry()
        self.e2e_latency = self.metrics.register(
            Histogram("scheduler_e2e_scheduling_seconds",
                      "queue-pop to bind-enqueued per successful attempt"))
        self.algorithm_latency = self.metrics.register(
            Histogram("scheduler_scheduling_algorithm_seconds",
                      "predicate+priority+allocate time per attempt"))
        self.binding_latency = self.metrics.register(
            Histogram("scheduler_binding_seconds", "bind POST round-trip"))
        self.bind_batch_size = self.metrics.register(
            Histogram("scheduler_bind_batch_size",
                      "binds shipped per bulk request (greedy queue drain)",
                      buckets=(1, 2, 4, 8, 16, 32, 64, 128)))
        # bulk-envelope failures falling back to per-pod binds: nonzero
        # means batching is NOT engaging (authz gap, old apiserver) — the
        # rate-limited log says why
        self._bulk_fallbacks_ctr = self.metrics.counter(
            "scheduler_bulk_bind_fallbacks_total")
        self._bulk_fallback_reporter = RateLimitedReporter(
            "scheduler-bulk-bind", window=30.0)
        # device races lost at bind (the apiserver's device-claim guard):
        # each re-queues with backoff and retries on a refreshed cache
        self._bind_conflicts_ctr = self.metrics.counter(
            "scheduler_bind_conflicts_total")
        self._attempts_ctr = self.metrics.counter(
            "scheduler_schedule_attempts_total")
        self._failures_ctr = self.metrics.counter(
            "scheduler_schedule_failures_total")
        self._preemptions_ctr = self.metrics.counter(
            "scheduler_preemption_victims_total")
        # churn hygiene: pods deleted while Pending, purged from the queue
        # and its backoff timers before costing an attempt or a bind
        self._queue_churn_purges_ctr = self.metrics.counter(
            "scheduler_queue_churn_purges_total")
        self.metrics_server: Optional[MetricsServer] = None
        self._metrics_port = metrics_port
        # per-attempt spans under the pod's trace id (utils/spans), served
        # at /debug/traces next to /metrics
        self.spans = SpanCollector("scheduler")
        # node -> (pod_key, priority, expiry): devices freed by preemption
        # are reserved for the preemptor until it binds or the claim expires
        # (ref: NominatedNodeAnnotationKey + the later PodNominator)
        self._nominations: Dict[str, Tuple[str, int, float]] = {}
        self._nominations_lock = threading.Lock()
        self.nomination_ttl = 60.0
        # the pods alive that carry required anti-affinity: inter-pod
        # affinity's symmetry check costs an O(pods) pass per attempt, paid
        # only while at least one such pod exists
        self._anti_affinity_uids: set = set()
        # Bind-failure backoff attempts, apart from the queue's schedule-
        # failure counter: a successful schedule forgets the queue counter
        # before the async bind resolves, so a failing bind would otherwise
        # re-queue at the flat base delay forever.  GIL-atomic dict ops; a
        # lost increment only shortens one backoff step.
        self._bind_fail_counts: Dict[str, int] = {}

    # ---------------------------------------------------------------- wiring

    def start(self):
        if self._metrics_port is not None and self.metrics_server is None:
            try:
                self.metrics_server = MetricsServer(
                    self.metrics, port=self._metrics_port,
                    extra={"scheduler_pending_pods": self.queue.depth,
                           "scheduler_bind_queue_depth": self._bind_q.qsize},
                    spans=self.spans,
                    ready_fn=lambda: (self.pods.has_synced()
                                      and self.nodes.has_synced()),
                ).start()
            except OSError as e:
                # a busy port must not take down the scheduling loop
                print(f"scheduler: metrics endpoint unavailable "
                      f"(port {self._metrics_port}): {e}", flush=True)
                self.metrics_server = None

        def node_add(n):
            self.cache.update_node(n)
            self.queue.flush_backoffs()

        def node_update(_o, n):
            self.cache.update_node(n)
            self.queue.flush_backoffs()

        self.nodes.add_handler(
            on_add=node_add,
            on_update=node_update,
            on_delete=lambda n: self.cache.remove_node(n.metadata.name),
        )
        self.pods.add_handler(
            on_add=self._on_pod_add,
            on_update=self._on_pod_update,
            on_delete=self._on_pod_delete,
        )
        self.factory.start_all()
        self.factory.wait_for_sync()
        worker = threading.Thread(target=self._loop, daemon=True, name="scheduleOne")
        worker.start()
        self._threads.append(worker)
        janitor = threading.Thread(target=self._janitor, daemon=True)
        janitor.start()
        self._threads.append(janitor)
        for i in range(self.BIND_WORKERS):
            b = threading.Thread(target=self._bind_loop, daemon=True, name=f"bind-{i}")
            b.start()
            self._threads.append(b)
        return self

    def stop(self):
        self._stop.set()
        self.queue.shut_down()
        for _ in range(self.BIND_WORKERS):
            self._bind_q.put(None)
        if self.metrics_server is not None:
            self.metrics_server.stop()
        self.factory.stop_all()

    # --------------------------------------------------------- pod handlers

    def _schedulable(self, pod: t.Pod) -> bool:
        return (
            not pod.spec.node_name
            and pod.spec.scheduler_name == self.NAME
            and not pod.metadata.deletion_timestamp
            and pod.status.phase in (t.POD_PENDING, "")
        )

    def _note_affinity(self, pod: t.Pod):
        """Track which pods carry required anti-affinity: the O(pods)
        PodAffinityChecker build is paid only while one such pod lives."""
        if (pod.spec.affinity is not None
                and pod.spec.affinity.pod_anti_affinity_required):
            self._anti_affinity_uids.add(pod.metadata.uid)
        else:
            self._anti_affinity_uids.discard(pod.metadata.uid)

    def _on_pod_add(self, pod: t.Pod):
        self._note_affinity(pod)
        if self._schedulable(pod):
            self.queue.add(pod.key(), pod.spec.priority)
        elif pod.spec.node_name:
            self.cache.add_pod(pod)

    def _on_pod_update(self, old: t.Pod, pod: t.Pod):
        self._note_affinity(pod)
        if self._schedulable(pod):
            self.queue.add(pod.key(), pod.spec.priority)
        elif pod.spec.node_name:
            self.cache.add_pod(pod)

    def _on_pod_delete(self, pod: t.Pod):
        self._anti_affinity_uids.discard(pod.metadata.uid)
        self._bind_fail_counts.pop(pod.key(), None)
        # a pod deleted while Pending must not cost a schedule attempt,
        # a bind round-trip, or a live backoff timer
        if self.queue.purge(pod.key()):
            self._queue_churn_purges_ctr.inc()
        self.cache.remove_pod(pod)
        # freed resources may unblock backing-off pods
        self.queue.flush_backoffs()

    def _janitor(self):
        while not self._stop.wait(5.0):
            self.cache.cleanup_expired_assumes()
            now = time.monotonic()
            with self._nominations_lock:
                for node in [n for n, (_, _, exp) in self._nominations.items()
                             if exp < now]:
                    self._nominations.pop(node, None)

    # ---------------------------------------------------------- nominations

    def _nominate(self, node: str, pod: t.Pod):
        with self._nominations_lock:
            self._nominations[node] = (
                pod.key(), pod.spec.priority,
                time.monotonic() + self.nomination_ttl,
            )

    def _clear_nomination_for(self, pod_key: str):
        with self._nominations_lock:
            for node in [n for n, (k, _, _) in self._nominations.items()
                         if k == pod_key]:
                self._nominations.pop(node, None)

    def _node_reserved_against(self, node: str, pod: t.Pod) -> bool:
        """True when `node`'s freed capacity is nominated to a DIFFERENT pod
        of >= priority: otherwise any pending pod would take the devices
        the preemption just freed."""
        with self._nominations_lock:
            nom = self._nominations.get(node)
        if nom is None:
            return False
        key, prio, exp = nom
        if exp < time.monotonic() or key == pod.key():
            return False
        return prio >= pod.spec.priority

    # ------------------------------------------------------------ main loop

    def _loop(self):
        while not self._stop.is_set():
            key = self.queue.pop(timeout=0.5)
            if key is None:
                continue
            try:
                self._schedule_one(key)
            except Exception:  # noqa: BLE001
                traceback.print_exc()

    @staticmethod
    def _pod_trace_id(pod: t.Pod) -> str:
        return (pod.metadata.annotations or {}).get(t.TRACE_ID_ANNOTATION, "")

    def _schedule_one(self, key: str):
        pod = self.pods.get(key)
        if pod is None or not self._schedulable(pod):
            return
        if self.cache.is_assumed(key):
            # placed, its bind in flight (ref: kube-scheduler's
            # skipPodSchedule): a second placement would race the first's
            # bind.  The JAX scheduler places such a pod again: the second
            # member of a gang whose members were all queued re-places the
            # whole gang beside the first placement's assumed devices.
            return
        start = time.monotonic()
        self._attempts_ctr.inc()
        tid = self._pod_trace_id(pod)
        if pod.spec.scheduling_gang:
            # the latency histograms see gangs too, not just singleton pods
            with self.spans.start_span("scheduler.schedule_gang",
                                       trace_id=tid, pod=key):
                self._schedule_gang(pod, start)
            return
        # the span is active for the whole attempt, so the Trace below (and
        # its slow-op step log) carries this pod's trace id
        with self.spans.start_span("scheduler.schedule",
                                   trace_id=tid, pod=key) as sp:
            tr = Trace("scheduling", threshold=TRACE_THRESHOLD_S,
                       pod=key, attempts=int(self._attempts_ctr.value))
            result, failure = self.schedule(pod, trace=tr)
            self.algorithm_latency.observe(time.monotonic() - start)
            if result is None:
                self._failures_ctr.inc()
                sp.annotate(failure=failure)
                tr.step("schedule failed")
                tr.log_if_long()
                self.recorder.event(pod, "Warning", "FailedScheduling", failure)
                if pod.spec.priority > 0:
                    self._try_preempt(pod)
                self.queue.add_backoff(key, pod.spec.priority)
                return
            sp.annotate(node=result.node,
                        devices=sum(len(v) for v in result.assignments.values()))
            self._assume_and_bind(pod, result)
            tr.step("assumed and queued bind")
            tr.log_if_long()
            self.queue.forget(key)
            self.e2e_latency.observe(time.monotonic() - start)

    # ------------------------------------------------------------- schedule

    def _needs_affinity_check(self, pod: t.Pod) -> bool:
        aff = pod.spec.affinity
        return bool(self._anti_affinity_uids) or (
            aff is not None and bool(
                aff.pod_affinity_required or aff.pod_anti_affinity_required)
        )

    def schedule(
        self, pod: t.Pod, nodes: Optional[Dict[str, NodeInfo]] = None,
        affinity_checker: Optional[PodAffinityChecker] = None,
        trace: Optional[Trace] = None,
    ) -> Tuple[Optional[ScheduleResult], str]:
        """One-pod placement over the cache snapshot (or a simulation map).
        `affinity_checker` lets gang placement reuse one O(pods) context
        across members; when the simulation map is node-restricted, callers
        MUST pass a checker built over the full world (a subset view would
        miss matching pods on excluded nodes)."""
        tr = trace or Trace("schedule")  # unthresholded no-op unless slow-path caller set one
        snapshot = nodes if nodes is not None else self.cache.snapshot()
        tr.step(f"snapshot of {len(snapshot)} nodes")
        if not snapshot:
            return None, "no nodes registered"
        if affinity_checker is None and self._needs_affinity_check(pod):
            affinity_checker = PodAffinityChecker(pod, snapshot)
        feasible: List[NodeInfo] = []
        reasons: Dict[str, int] = defaultdict(int)
        node_list = list(snapshot.values())
        enough = max(MIN_FEASIBLE_TO_FIND, int(len(node_list) * FEASIBLE_PERCENT))
        # start each scan at a rotating offset: with early termination a
        # fixed order would pile all pods onto the first feasible nodes
        start = self._scan_offset % max(1, len(node_list))
        self._scan_offset += 1
        # the preemptor returns to its nominated node first: the devices
        # were freed for it, so a feasible nominated node wins outright
        nominated = (pod.metadata.annotations or {}).get(t.NOMINATED_NODE_ANNOTATION)
        if nominated and nominated in snapshot and snapshot[nominated].node is not None:
            ni = snapshot[nominated]
            ok, _ = run_predicates(pod, ni, self.equiv_cache)
            if ok and affinity_checker is not None:
                ok, _ = affinity_checker.check(ni)
            if ok:
                assignments, _ = allocate_for_pod(pod, ni)
                if assignments is not None:
                    return ScheduleResult(nominated, assignments), ""
        for idx in range(len(node_list)):
            ni = node_list[(start + idx) % len(node_list)]
            if ni.node is None:
                continue
            if self._node_reserved_against(ni.node.metadata.name, pod):
                reasons["node reserved for a nominated preemptor"] += 1
                continue
            # device fit FIRST: it is the cheapest check (O(1) availability
            # counters) and the dominant rejector on a filling cluster
            ok, why = fits_devices(pod, ni)
            if not ok:
                reasons[why] += 1
                continue
            ok, why = run_predicates(pod, ni, self.equiv_cache)
            if not ok:
                reasons[why[0] if why else "predicate failed"] += 1
                continue
            if affinity_checker is not None:
                ok, why_a = affinity_checker.check(ni)
                if not ok:
                    reasons[why_a] += 1
                    continue
            feasible.append(ni)
            if len(feasible) >= enough:
                break
        tr.step(f"predicates done: {len(feasible)} feasible")
        if not feasible:
            summary = "; ".join(f"{n} node(s): {r}" for r, n in sorted(reasons.items()))
            return None, f"0/{len(snapshot)} nodes available: {summary}"
        scores = prioritize(pod, feasible)
        tr.step("prioritized")
        # full device allocation runs only on the winner (domain best fit
        # and the minor sort are O(devices log devices), too hot per
        # candidate); on the rare count-check/allocator disagreement, fall
        # to the next best
        for ni in sorted(
            feasible,
            key=lambda n: (scores[n.node.metadata.name], n.node.metadata.name),
            reverse=True,
        ):
            assignments, why = allocate_for_pod(pod, ni)
            if assignments is not None:
                return ScheduleResult(ni.node.metadata.name, assignments), ""
            reasons[why] += 1
        summary = "; ".join(f"{n} node(s): {r}" for r, n in sorted(reasons.items()))
        return None, f"0/{len(snapshot)} nodes available: {summary}"

    def _assume_and_bind(self, pod: t.Pod, result: ScheduleResult):
        assumed = pod.clone()  # clone-before-mutate: pod is an informer snapshot
        assumed.spec.node_name = result.node
        by_name = {per.name: per for per in assumed.spec.extended_resources}
        for name, ids in result.assignments.items():
            by_name[name].assigned = list(ids)
        self.cache.assume_pod(assumed, result.node)
        binding = t.Binding(
            target_node=result.node,
            extended_resource_assignments=result.assignments,
        )
        binding.metadata.name = pod.metadata.name
        binding.metadata.namespace = pod.metadata.namespace
        # SLI stamp: the algorithm (incl. device-ID pick) finished NOW; the
        # binding carries it so the apiserver persists it onto the pod
        binding.metadata.annotations[t.SCHEDULED_AT_ANNOTATION] = \
            f"{time.time():.6f}"  # a wall-clock stamp that other processes read
        # async bind (ref scheduler.go:482): don't block the scheduling
        # loop.  Gang members enqueue back-to-back, so the greedy drain
        # ships a gang as one bulk request.
        self._bind_q.put(_BindItem(pod, assumed, binding, result,
                                   self._pod_trace_id(pod)))

    # ---------------------------------------------------------- bind workers

    def _bind_success(self, item: _BindItem):
        self._bind_fail_counts.pop(item.pod.key(), None)
        self._clear_nomination_for(item.pod.key())
        devices = (f" devices={item.result.assignments}"
                   if item.result.assignments else "")
        self.recorder.event(item.pod, "Normal", "Scheduled",
                            f"assigned to {item.result.node}{devices}")
        print(f"scheduler: bound {item.pod.key()} to {item.result.node}{devices}",
              flush=True)

    def _bind_failed(self, item: _BindItem, err, sp=None):
        """Shared failure handling for singleton and bulk binds: forget the
        assumption; terminal placement races (Conflict/NotFound) stay
        forgotten, while retryable failures (5xx, transport: the bind may
        or may not have landed, and a re-bind racing a landed one answers
        Conflict) also re-queue with backoff.

        One Conflict is retryable: the apiserver's device-claim guard
        answering that another pod just took a device this placement
        wanted (the DEVICE_CLAIM_CONFLICT marker).  The pod itself is still
        unbound: it re-queues, and by the time its backoff expires the
        informer has delivered the winner's bind."""
        self.cache.forget_pod(item.assumed)
        if sp is not None:
            sp.annotate(failure=str(err))
        self.recorder.event(item.pod, "Warning", "FailedBinding", str(err))
        key = item.pod.key()
        if isinstance(err, Conflict) \
                and t.DEVICE_CLAIM_CONFLICT in str(err):
            self._bind_conflicts_ctr.inc()
            _retry.note_retry("bind_conflict")
            self._requeue_failed_bind(key, item.pod.spec.priority)
        elif not isinstance(err, (Conflict, NotFound)):
            # a 429 here means the apiserver shed the bind under overload;
            # the re-queue with backoff is the scheduler's half of that
            _retry.note_retry(
                "bind_shed" if getattr(err, "code", 0) == 429
                else "bind_requeue")
            self._requeue_failed_bind(key, item.pod.spec.priority)

    def _requeue_failed_bind(self, key: str, priority: int):
        """Backoff scaled by CONSECUTIVE bind failures for this pod (the
        queue's own counter was forgotten when the schedule succeeded)."""
        n = self._bind_fail_counts.get(key, 0)
        self._bind_fail_counts[key] = n + 1
        self.queue.add_backoff(key, priority, attempts=n)

    def _bind_one(self, item: _BindItem):
        """Ship one bind alone: a batch of one, or the per-item fallback
        when a bulk request's envelope failed."""
        pod, result = item.pod, item.result
        bind_t0 = time.monotonic()
        # span active across the POST so the apiserver's bind handling
        # joins this pod's trace via the propagated header
        with self.spans.start_span("scheduler.bind", trace_id=item.tid,
                                   pod=pod.key(), node=result.node) as sp:
            try:
                self.cs.bind(pod.metadata.namespace, pod.metadata.name,
                             item.binding)
                self.binding_latency.observe(time.monotonic() - bind_t0)
                self._bind_success(item)
            except ApiError as e:
                self._bind_failed(item, e, sp)
            except Exception as e:  # noqa: BLE001
                # connection-level failure (the apiserver went away mid-
                # request): retryable, or the assumed-but-unbound pod
                # would wedge forever
                self._bind_failed(item, f"transport: {e}", sp)

    def _bind_many(self, namespace: str, items: List[_BindItem]):
        """Ship a drained batch as ONE bulk request; outcomes are per-item.
        An envelope-level failure (transport, authz, or an apiserver
        without the batch endpoint) falls back to singleton binds; item
        state is untouched until its own outcome lands, and the fallback is
        loud (a counter and a rate-limited log line)."""
        import contextlib

        bind_t0 = time.monotonic()
        fallback_err = None
        with contextlib.ExitStack() as stack:
            # one span per pod (each under its own trace id) around the
            # shared POST
            sps = [stack.enter_context(self.spans.start_span(
                "scheduler.bind", trace_id=it.tid, pod=it.pod.key(),
                node=it.result.node, batched=len(items))) for it in items]
            try:
                outcomes = self.cs.bind_batch(
                    namespace, [it.binding for it in items])
            except Exception as e:  # noqa: BLE001 - envelope, not the binds
                fallback_err = e
                outcomes = None
            if outcomes is not None and len(outcomes) != len(items):
                fallback_err = RuntimeError(
                    f"malformed bulk response: {len(outcomes)} results "
                    f"for {len(items)} bindings")
                outcomes = None
            if outcomes is not None:
                self.binding_latency.observe(time.monotonic() - bind_t0)
                for it, sp, err in zip(items, sps, outcomes):
                    if err is None:
                        self._bind_success(it)
                    else:
                        self._bind_failed(it, err, sp)
                return
            for sp in sps:
                sp.annotate(failure=f"bulk envelope: {fallback_err}")
        # the batch spans are closed here: the per-item fallback opens its
        # own scheduler.bind spans
        self._bulk_fallbacks_ctr.inc()
        self._bulk_fallback_reporter.report(
            f"scheduler: bulk bind of {len(items)} pods failed "
            f"({fallback_err}); falling back to per-pod binds")
        # drain the fallback through the worker pool, not inline, so that
        # one bad envelope does not serialize the batch behind this worker;
        # `single` keeps the items out of any later bulk envelope
        for it in items:
            it.single = True
            self._bind_q.put(it)

    def _bind_loop(self):
        while True:
            item = self._bind_q.get()
            if item is None or self._stop.is_set():
                return
            batch = [item]
            # greedy drain: everything already queued ships together, so
            # the batch size follows the backlog
            while len(batch) < self.MAX_BIND_BATCH:
                try:
                    nxt = self._bind_q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._bind_q.put(None)  # keep shutdown sentinel for peers
                    break
                batch.append(nxt)
            self.bind_batch_size.observe(len(batch))
            try:
                singles = [it for it in batch if it.single]
                bulk = [it for it in batch if not it.single]
                for it in singles:
                    self._bind_one(it)
                if len(bulk) == 1:
                    # one singleton POST beats a one-item bulk envelope
                    self._bind_one(bulk[0])
                elif bulk:
                    by_ns: Dict[str, List[_BindItem]] = defaultdict(list)
                    for it in bulk:
                        by_ns[it.pod.metadata.namespace].append(it)
                    for ns, group in by_ns.items():
                        if len(group) == 1:
                            self._bind_one(group[0])
                        else:
                            self._bind_many(ns, group)
            except Exception:  # noqa: BLE001
                traceback.print_exc()

    # ----------------------------------------------------------------- gang

    def _gang_members(self, pod: t.Pod) -> List[t.Pod]:
        # finished pods are not members: a Failed-but-bound member counting
        # toward `bound` would let a partial gang look complete exactly when
        # the Job controller is about to tear it down
        return [
            p
            for p in self.pods.list()
            if p.metadata.namespace == pod.metadata.namespace
            and p.spec.scheduling_gang == pod.spec.scheduling_gang
            and not p.metadata.deletion_timestamp
            and p.status.phase not in (t.POD_SUCCEEDED, t.POD_FAILED)
        ]

    def _schedule_gang(self, pod: t.Pod, start: Optional[float] = None):
        """All-or-nothing over gang_size pods, one NVLink domain first."""
        start = start if start is not None else time.monotonic()
        gang_key = (pod.metadata.namespace, pod.spec.scheduling_gang)
        members = self._gang_members(pod)
        # a member assumed in the cache counts as bound: its bind is in flight
        unbound = sorted(
            (p for p in members
             if not p.spec.node_name and not self.cache.is_assumed(p.key())),
            key=lambda p: p.metadata.name,
        )
        bound = [p for p in members
                 if p.spec.node_name or self.cache.is_assumed(p.key())]
        want = pod.spec.gang_size
        if len(bound) + len(unbound) < want:
            with self._gang_lock:
                first = self._gang_first_seen.setdefault(gang_key, time.monotonic())
            if time.monotonic() - first > self.GANG_WAIT_SECONDS:
                self.recorder.event(
                    pod, "Warning", "GangIncomplete",
                    f"gang {gang_key[1]}: {len(bound) + len(unbound)}/{want} pods exist "
                    f"after {self.GANG_WAIT_SECONDS}s",
                )
            self.queue.add_backoff(pod.key(), pod.spec.priority)
            return
        if not unbound:
            return  # fully bound already
        with self._gang_lock:
            self._gang_first_seen.pop(gang_key, None)

        placements = self._place_gang(unbound)
        self.algorithm_latency.observe(time.monotonic() - start)
        if placements is None:
            self._failures_ctr.inc()
            self.recorder.event(
                pod, "Warning", "FailedScheduling",
                f"gang {gang_key[1]}: no all-or-nothing placement for "
                f"{len(unbound)} pods",
            )
            # gangs preempt as a unit: the whole gang's worth of victims
            # goes, or none does
            if pod.spec.priority > 0:
                self._try_preempt_gang(unbound)
            self.queue.add_backoff(pod.key(), pod.spec.priority)
            return
        for member, result in placements:
            self._assume_and_bind(member, result)
            self.queue.forget(member.key())
        self.e2e_latency.observe(time.monotonic() - start)

    def _place_gang(
        self, members: List[t.Pod],
        base: Optional[Dict[str, NodeInfo]] = None,
    ) -> Optional[List[Tuple[t.Pod, ScheduleResult]]]:
        """Simulate whole-gang placement on cloned NodeInfos.

        Tries each NVLink domain that could hold the gang first (the nodes
        whose cards carry that domain), then the unrestricted node set.
        Returns None unless every member fits.
        """
        if base is None:
            base = self.cache.snapshot()
        need_affinity = any(self._needs_affinity_check(m) for m in members)
        domains = self._candidate_domains(members, base)
        for domain in domains + [None]:
            # clone-on-write: share the live NodeInfos for reading and clone
            # a node only when the simulation places a member on it
            if domain is not None:
                sim = {
                    name: ni
                    for name, ni in base.items()
                    if ni.node is not None and self._node_in_domain(ni, domain)
                }
            else:
                sim = dict(base)
            # the affinity context must see the FULL world: a domain-
            # restricted view would miss matching pods on excluded nodes.
            # One checker per member class per attempt (gang templates share
            # labels and terms), fed each shadow placement in turn.
            affinity_view = dict(base) if need_affinity else None
            checkers: Dict[tuple, PodAffinityChecker] = {}
            cloned: set = set()
            placements: List[Tuple[t.Pod, ScheduleResult]] = []
            ok = True
            for member in members:
                checker = None
                if need_affinity:
                    ckey = (
                        member.metadata.namespace,
                        _json_key(member.metadata.labels),
                        _json_key(to_dict(member.spec.affinity)
                                  if member.spec.affinity else None),
                    )
                    checker = checkers.get(ckey)
                    if checker is None:
                        checker = PodAffinityChecker(member, affinity_view)
                        checkers[ckey] = checker
                result, _ = self.schedule(member, nodes=sim,
                                          affinity_checker=checker)
                if result is None:
                    ok = False
                    break
                # deduct in simulation so the next member sees it
                shadow = member.clone()  # member is an informer/queue snapshot
                shadow.spec.node_name = result.node
                by_name = {per.name: per for per in shadow.spec.extended_resources}
                for name, ids in result.assignments.items():
                    by_name[name].assigned = list(ids)
                if result.node not in cloned:
                    sim[result.node] = sim[result.node].clone()
                    cloned.add(result.node)
                sim[result.node].add_pod(shadow)
                if need_affinity:
                    affinity_view[result.node] = sim[result.node]
                    for c in checkers.values():
                        c.note_added_pod(shadow, sim[result.node])
                placements.append((member, result))
            if ok:
                return placements
        return None

    @staticmethod
    def _node_in_domain(ni: NodeInfo, domain: str) -> bool:
        for info in ni.extended.values():
            for d in info.devices.values():
                if domain_of(d) == domain:
                    return True
        return False

    def _candidate_domains(
        self, members: List[t.Pod], nodes: Dict[str, NodeInfo]
    ) -> List[str]:
        """NVLink domains with room for the whole gang's cards, fewest free
        cards first (best fit)."""
        need = 0
        for m in members:
            for per in m.spec.extended_resources:
                need += per.quantity
        if need == 0:
            return []
        cap: Dict[str, int] = defaultdict(int)
        for ni in nodes.values():
            for info in ni.extended.values():
                for domain, n in info.domain_available().items():
                    if domain:
                        cap[domain] += n
        return sorted((d for d, n in cap.items() if n >= need), key=lambda d: cap[d])

    # ----------------------------------------------------------- preemption

    def _pdb_budgets(self) -> List[Tuple[t.PodDisruptionBudget, int]]:
        """Live PDBs with their remaining voluntary-disruption budget."""
        return [(pdb, pdb.status.disruptions_allowed) for pdb in self.pdbs.list()]

    def _victim_filter(self) -> "callable":
        """Returns may_evict(victim) that tracks PDB budgets across picks:
        a victim whose PDB has no budget left is untouchable (preemption
        never violates a budget; the eviction subresource would refuse)."""
        budgets = self._pdb_budgets()
        remaining = {id(pdb): allowed for pdb, allowed in budgets}

        def may_evict(victim: t.Pod) -> bool:
            if victim.metadata.deletion_timestamp:
                # already terminating: its resources free regardless, and the
                # eviction registry charges no budget for it
                return True
            matched = []
            for pdb, _ in budgets:
                if pdb.metadata.namespace != victim.metadata.namespace:
                    continue
                if pdb.spec.selector is None or not label_selector_matches(
                    pdb.spec.selector, victim.metadata.labels
                ):
                    continue
                if remaining[id(pdb)] <= 0:
                    return False
                matched.append(pdb)
            for pdb in matched:
                remaining[id(pdb)] -= 1
            return True

        return may_evict

    def _evict_victims(self, victims: List[t.Pod], preemptor: t.Pod) -> None:
        """Victims go through the eviction subresource, so the PDB budget is
        consumed transactionally even against concurrent drains."""
        for victim in victims:
            if victim.metadata.deletion_timestamp:
                continue  # already on its way out
            try:
                self.cs.evict(victim.metadata.namespace, victim.metadata.name)
                self._preemptions_ctr.inc()
                self.recorder.event(
                    victim, "Normal", "Preempted",
                    f"preempted by {preemptor.key()} "
                    f"(priority {preemptor.spec.priority})",
                )
            except TooManyRequests as e:
                # lost a race with another disruption: the preemptor retries
                self.recorder.event(
                    victim, "Warning", "PreemptionBlocked", str(e))
            except ApiError:
                pass

    def _try_preempt_gang(self, members: List[t.Pod]) -> bool:
        """Gang preemption: simulate the whole gang's placement on a world
        where the lower-priority pods are gone, then evict the victims on
        the nodes the placement actually uses.  All-or-nothing: no victim
        falls unless the entire gang fits afterward.  PDB budgets are
        charged only for the used nodes' victims; if those do not fit the
        budget, they are frozen and the placement re-runs.  (Victims on a
        used node are evicted wholesale: devices are the scarce resource,
        and per-node minimization would re-run the allocator per victim.)"""
        if not members:
            return False
        prio = members[0].spec.priority
        base = self.cache.snapshot()
        # re-entry guard: while victims of this gang's previous preemption
        # are still terminating, wait instead of felling a second set
        gang_key = (members[0].metadata.namespace, members[0].spec.scheduling_gang)
        with self._gang_lock:
            prev = self._gang_victims.get(gang_key, set())
        if prev:
            alive = {
                p.key()
                for ni in base.values()
                for p in ni.pods.values()
                if p.metadata.deletion_timestamp
            }
            if prev & alive:
                return False
            with self._gang_lock:
                self._gang_victims.pop(gang_key, None)

        frozen: set = set()  # pod keys placement may not remove
        for _ in range(3):
            sim: Dict[str, NodeInfo] = {}
            victims_by_node: Dict[str, List[t.Pod]] = {}
            for name, ni in base.items():
                if ni.node is None:
                    continue
                removable = [
                    p for p in sorted(ni.pods.values(), key=lambda p: p.spec.priority)
                    if p.spec.priority < prio and p.key() not in frozen
                ]
                if removable:
                    clone = ni.clone()
                    for p in removable:
                        clone.remove_pod(p)
                    sim[name] = clone
                    victims_by_node[name] = removable
                else:
                    sim[name] = ni
            placements = self._place_gang(members, base=sim)
            if placements is None:
                return False
            used = {r.node for _, r in placements}
            victims = [v for n in used for v in victims_by_node.get(n, [])]
            if not victims:
                return False  # placement failure wasn't about preemptable load
            # charge PDB budgets against the actually-used victims only
            may_evict = self._victim_filter()
            blocked = [v for v in victims if not may_evict(v)]
            if blocked:
                frozen.update(v.key() for v in blocked)
                continue
            self._evict_victims(victims, members[0])
            with self._gang_lock:
                self._gang_victims[gang_key] = {v.key() for v in victims}
            return True
        return False

    def _try_preempt(self, pod: t.Pod) -> bool:
        """Evict lower-priority pods to make room (ref: scheduler.go:209-250).

        Picks the node where preemption frees enough resources while evicting
        the fewest, lowest-priority victims, never violating a
        PodDisruptionBudget; then evicts through the eviction subresource,
        records the nominated node on the preemptor, and reserves it."""
        base = self.cache.snapshot()
        # eligibility guard (ref podEligibleToPreemptOthers): while victims
        # of a previous preemption are still terminating on the nominated
        # node, this pod waits instead of preempting a fresh set elsewhere
        nominated = (pod.metadata.annotations or {}).get(t.NOMINATED_NODE_ANNOTATION)
        if not nominated:
            with self._nominations_lock:
                for node, (k, _, exp) in self._nominations.items():
                    if k == pod.key() and exp >= time.monotonic():
                        nominated = node
                        break
        if nominated:
            ni = base.get(nominated)
            if ni is not None and any(
                p.metadata.deletion_timestamp
                and p.spec.priority < pod.spec.priority
                for p in ni.pods.values()
            ):
                return False  # backoff; devices free once victims finish dying
            # informer lag may hide the deletion_timestamp for a beat: a
            # nominated preemptor only ever re-preempts ON its nominated
            # node, so a stale retry cannot fell a second victim set elsewhere
            if ni is not None:
                base = {nominated: ni}
        best: Optional[Tuple[str, List[t.Pod]]] = None
        for name, ni in base.items():
            if ni.node is None:
                continue
            may_evict = self._victim_filter()  # budgets are per-candidate-node
            victims_pool = sorted(
                (
                    p
                    for p in ni.pods.values()
                    if p.spec.priority < pod.spec.priority
                ),
                key=lambda p: p.spec.priority,
            )
            if not victims_pool:
                continue
            sim = ni.clone()
            victims: List[t.Pod] = []
            placed = False
            needs_affinity = self._needs_affinity_check(pod)
            for victim in victims_pool:
                if not may_evict(victim):
                    continue
                sim.remove_pod(victim)
                victims.append(victim)
                ok, _ = run_predicates(pod, sim)
                if ok and needs_affinity:
                    # the affinity world changes as victims fall: judge on
                    # the modified full snapshot, or preemption evicts
                    # innocents for a placement that can never succeed
                    modified = dict(base)
                    modified[name] = sim
                    ok, _ = PodAffinityChecker(pod, modified).check(sim)
                if ok:
                    assignments, _ = allocate_for_pod(pod, sim)
                    if assignments is not None:
                        placed = True
                        break
            if placed and (best is None or len(victims) < len(best[1])):
                best = (name, victims)
        if best is None:
            return False
        node_name, victims = best
        self._evict_victims(victims, pod)
        self._nominate(node_name, pod)
        try:
            self.cs.pods.patch(
                pod.metadata.name,
                {"metadata": {"annotations": {t.NOMINATED_NODE_ANNOTATION: node_name}}},
                namespace=pod.metadata.namespace,
            )
        except ApiError:
            pass
        return True
