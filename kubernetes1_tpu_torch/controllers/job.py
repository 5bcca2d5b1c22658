"""Job controller: run-to-completion workloads — the training primitive.
The port's copy of the JAX package's ``controllers/job.py``.

Ref: pkg/controller/job/job_controller.go (syncJob :425, manageJob :633-700,
completion counting :523-545), extended with the two capabilities SURVEY.md
§2.1 identifies as reference gaps that multi-host TPU training requires:

1. **Indexed completion mode** — each pod carries a stable completion index
   0..completions-1 (annotation batch.ktpu.io/completion-index and pod name
   suffix "<job>-<index>"), which the GPU device plugin turns into RANK.
   A multi-card Job runs as N indexed workers whose processes learn their
   rank from the index.
2. **Gang scheduling** — spec.gang_scheduling=True stamps every pod with
   (scheduling_gang=<job uid>, gang_size=parallelism) so the scheduler binds
   the whole worker set atomically on one NVLink domain.

The controller also injects the multi-host bootstrap annotations the plugin
consumes: worker id, coordinator address (index-0 worker, port 8476), and
the full worker hostname list, under the port's keys
(``gpu.ktpu.io/worker-id``, ``/coordinator-address``,
``/worker-hostnames``) where the JAX controller writes ``tpu.ktpu.io/*``.

Elastic restart (the preemptible config): failed/deleted worker pods are
recreated with the SAME completion index until backoff_limit, so a
preempted gang re-forms and training resumes from the job's own
checkpoints.

Gang failure policy (node & slice failure domain): for gang-scheduled jobs
the slice is all-or-nothing on the FAILURE path too, not just at
placement.  When any member of the current gang attempt dies — pod Failed
(chip gone unhealthy, pressure eviction), deletion (node-lifecycle
eviction), or vanishing outright (force finalize off a dead node) — the
controller tears down EVERY member, waits a capped exponential backoff,
and recreates the whole gang as a new attempt (GANG_ATTEMPT_LABEL on the
pods, the same key as an annotation on the Job) whose fresh scheduling_gang
id makes the scheduler re-place it as a unit on healthy devices.
backoff_limit caps ATTEMPTS for gang jobs (counting failed pods is
meaningless when teardown deletes the evidence).  The
ktpu_gang_recovery_seconds histogram measures member-death to
all-members-Running MTTR — the goodput denominator.

The gang policy is always on (the JAX package's ``GangScheduling`` gate
has no off branch here, as in the port's scheduler), and the JAX
controller's flight-recorder notes are left out.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Set

from ..api import types as t
from ..client.errors import is_transient
from ..deviceplugin.gpu_plugin import (
    ANN_COORDINATOR,
    ANN_WORKER_HOSTNAMES,
    ANN_WORKER_ID,
)
from ..machinery import AlreadyExists, ApiError, NotFound, now_iso
from ..machinery.labels import label_selector_matches
from ..machinery.scheme import from_dict, to_dict
from ..utils.metrics import Counter, Histogram
from ..utils.retry import call_with_retries
from .base import Controller, delete_pods_batch, write_status_if_changed

COORDINATOR_PORT = 8476

# Gang recovery MTTR: first observation of a member death -> every member
# of the replacement attempt Running.  Module-level (the client/retry
# retries_total pattern) so one process-wide distribution aggregates every
# controller instance; the controller manager process serves it on its
# /metrics.
gang_recovery_seconds = Histogram(
    "ktpu_gang_recovery_seconds",
    "gang member death to all-members-Running recovery time",
    buckets=(0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 120.0, 300.0),
)
gang_attempts_total = Counter(
    "ktpu_gang_attempts_total", "whole-gang recreate attempts")


def format_indexes(indexes: Set[int]) -> str:
    """{0,1,2,5} -> '0-2,5' (compact completedIndexes form)."""
    if not indexes:
        return ""
    xs = sorted(indexes)
    parts, start, prev = [], xs[0], xs[0]
    for x in xs[1:]:
        if x == prev + 1:
            prev = x
            continue
        parts.append(f"{start}-{prev}" if prev > start else str(start))
        start = prev = x
    parts.append(f"{start}-{prev}" if prev > start else str(start))
    return ",".join(parts)


class JobController(Controller):
    name = "job-controller"
    # capped exponential backoff between gang recreate attempts (class
    # attrs so tests/chaos can retune an instance before setup())
    gang_backoff_base = 1.0
    gang_backoff_cap = 30.0

    def setup(self):
        # gang bookkeeping (all reconstructible from the API after a
        # controller restart; only the MTTR window and the live backoff
        # deadline are in-memory best-effort)
        self._gang_broken_at: Dict[str, float] = {}  # job key -> monotonic
        self._gang_retry_at: Dict[str, float] = {}
        self._gang_notified: Set[str] = set()
        self.jobs = self.factory.informer("jobs")
        self.pods = self.factory.informer("pods")
        self.jobs.add_handler(
            on_add=self.enqueue,
            on_update=lambda _o, n: self.enqueue(n),
            on_delete=self.enqueue,
        )
        self.pods.add_handler(
            on_add=self._pod_event,
            on_update=lambda _o, n: self._pod_event(n),
            on_delete=self._pod_event,
        )

    def _pod_event(self, pod: t.Pod):
        job_name = pod.metadata.labels.get(t.JOB_NAME_LABEL)
        if job_name:
            self.queue.add(f"{pod.metadata.namespace}/{job_name}")

    # ------------------------------------------------------------------ sync

    def sync(self, key: str):
        job = self.jobs.get(key)
        if job is None or self._finished(job):
            self._gang_forget(key)
            return
        ns = job.metadata.namespace
        pods = [
            p
            for p in self.pods.list()
            if p.metadata.namespace == ns
            and label_selector_matches(job.spec.selector, p.metadata.labels)
        ]
        if job.spec.gang_scheduling:
            self._sync_gang(job, pods)
            return
        active = [p for p in pods if not self._pod_finished(p) and not p.metadata.deletion_timestamp]
        succeeded = [p for p in pods if p.status.phase == t.POD_SUCCEEDED]
        failed = [p for p in pods if p.status.phase == t.POD_FAILED]

        if job.spec.completion_mode == "Indexed":
            self._manage_indexed(job, active, succeeded, failed)
        else:
            self._manage_nonindexed(job, active, succeeded, failed)
        self._update_status(job, active, succeeded, failed)

    @staticmethod
    def _pod_finished(pod: t.Pod) -> bool:
        return pod.status.phase in (t.POD_SUCCEEDED, t.POD_FAILED)

    @staticmethod
    def _finished(job: t.Job) -> bool:
        return any(
            c.type in ("Complete", "Failed") and c.status == "True"
            for c in job.status.conditions
        )

    # ------------------------------------------------------------- indexed

    def _pod_index(self, pod: t.Pod) -> Optional[int]:
        raw = pod.metadata.annotations.get(t.COMPLETION_INDEX_ANNOTATION)
        try:
            return int(raw) if raw is not None else None
        except ValueError:
            return None

    def _manage_indexed(self, job: t.Job, active, succeeded, failed):
        completions = job.spec.completions or job.spec.parallelism or 1
        have: Set[int] = set()
        for p in active:
            idx = self._pod_index(p)
            if idx is not None:
                have.add(idx)
        done: Set[int] = set()
        for p in succeeded:
            idx = self._pod_index(p)
            if idx is not None:
                done.add(idx)
        if len(failed) > job.spec.backoff_limit:
            return  # status update will mark Failed
        missing = [
            i for i in range(completions) if i not in have and i not in done
        ]
        # cap concurrency at parallelism
        budget = (job.spec.parallelism or completions) - len(active)
        for idx in missing[: max(0, budget)]:
            self._create_indexed_pod(job, idx, completions)

    def _create_indexed_pod(self, job: t.Job, index: int, completions: int,
                            attempt: int = 0):
        pod = self._pod_from_template(job)
        pod.metadata.name = f"{job.metadata.name}-{index}"
        pod.metadata.generate_name = ""
        pod.metadata.annotations[t.COMPLETION_INDEX_ANNOTATION] = str(index)
        # multi-host bootstrap (consumed by the GPU device plugin)
        pod.metadata.annotations[ANN_WORKER_ID] = str(index)
        coordinator = f"{job.metadata.name}-0.{job.metadata.namespace}"
        pod.metadata.annotations[ANN_COORDINATOR] = f"{coordinator}:{COORDINATOR_PORT}"
        pod.metadata.annotations[ANN_WORKER_HOSTNAMES] = ",".join(
            f"{job.metadata.name}-{i}.{job.metadata.namespace}"
            for i in range(completions)
        )
        if job.spec.gang_scheduling:
            self._stamp_gang_member(job, pod, completions, attempt)
        try:
            self.cs.pods.create(pod)
            self.recorder.event(
                job, "Normal", "SuccessfulCreate", f"created pod {pod.metadata.name}"
            )
        except AlreadyExists:
            pass

    # ---------------------------------------------------------- nonindexed

    def _manage_nonindexed(self, job: t.Job, active, succeeded, failed):
        parallelism = job.spec.parallelism or 1
        completions = job.spec.completions
        if len(failed) > job.spec.backoff_limit:
            return
        if completions is not None:
            want_active = min(parallelism, max(0, completions - len(succeeded)))
        else:
            want_active = parallelism
        need = want_active - len(active)
        for _ in range(max(0, need)):
            pod = self._pod_from_template(job)
            pod.metadata.generate_name = f"{job.metadata.name}-"
            try:
                self.cs.pods.create(pod)
            except ApiError:
                break
        for pod in active[: max(0, -need)]:
            try:
                self.cs.pods.delete(pod.metadata.name, pod.metadata.namespace)
            except ApiError:
                pass

    def _pod_from_template(self, job: t.Job) -> t.Pod:
        tmpl = job.spec.template
        pod = t.Pod()
        pod.metadata.namespace = job.metadata.namespace
        pod.metadata.labels = dict(tmpl.metadata.labels)
        pod.metadata.labels.setdefault(t.JOB_NAME_LABEL, job.metadata.name)
        pod.metadata.annotations = dict(tmpl.metadata.annotations)
        pod.metadata.owner_references = [
            t.OwnerReference(
                api_version=job.API_VERSION,
                kind="Job",
                name=job.metadata.name,
                uid=job.metadata.uid,
                controller=True,
            )
        ]
        pod.spec = from_dict(t.PodSpec, to_dict(tmpl.spec))  # deep copy
        if not pod.spec.restart_policy or pod.spec.restart_policy == "Always":
            pod.spec.restart_policy = "Never"  # job pods must terminate
        return pod

    # ------------------------------------------------------- gang lifecycle

    def _gang_forget(self, key: str):
        self._gang_broken_at.pop(key, None)
        self._gang_retry_at.pop(key, None)
        self._gang_notified.discard(key)

    @staticmethod
    def _gang_id(job: t.Job, attempt: int) -> str:
        # a fresh id per attempt: the scheduler sees each recreate as a new
        # gang, so stale first-seen state and any straggler pods of a prior
        # attempt can never satisfy (or starve) the replacement's placement
        return f"job-{job.metadata.uid}-a{attempt}"

    def _stamp_gang_member(self, job: t.Job, pod: t.Pod, size: int,
                           attempt: int):
        pod.metadata.labels[t.GANG_ATTEMPT_LABEL] = str(attempt)
        pod.spec.scheduling_gang = self._gang_id(job, attempt)
        pod.spec.gang_size = size

    def _gang_size(self, job: t.Job) -> int:
        if job.spec.completion_mode == "Indexed":
            return job.spec.completions or job.spec.parallelism or 1
        return job.spec.parallelism or 1

    @staticmethod
    def _attempt_of(obj_meta_map: Optional[Dict[str, str]]) -> int:
        raw = (obj_meta_map or {}).get(t.GANG_ATTEMPT_LABEL)
        try:
            return int(raw) if raw else 0
        except ValueError:
            return 0

    def _sync_gang(self, job: t.Job, pods: List[t.Pod]):
        """All-or-nothing failure handling for one gang job (see module
        docstring).  Level-triggered: every decision is recomputed from the
        listed pods, so a controller restart resumes mid-recovery."""
        key = job.key()
        attempt = self._attempt_of(job.metadata.annotations)
        size = self._gang_size(job)
        indexed = job.spec.completion_mode == "Indexed"
        cur = [p for p in pods
               if self._attempt_of(p.metadata.labels) == attempt]
        stale = [p for p in pods
                 if self._attempt_of(p.metadata.labels) != attempt]
        # previous attempts tear down unconditionally — a broken gang's
        # survivors hold the chips the replacement needs
        self._force_delete_many(stale)

        succeeded = [p for p in cur if p.status.phase == t.POD_SUCCEEDED]
        failed = [p for p in cur if p.status.phase == t.POD_FAILED]
        active = [p for p in cur if not self._pod_finished(p)
                  and not p.metadata.deletion_timestamp]
        deleting = [p for p in cur if p.metadata.deletion_timestamp
                    and not self._pod_finished(p)]
        bound = [p for p in cur if p.spec.node_name]

        broken = ""
        if failed:
            broken = (f"member {failed[0].metadata.name} failed: "
                      f"{failed[0].status.reason or failed[0].status.message or 'unknown'}")
        elif deleting:
            broken = f"member {deleting[0].metadata.name} is being deleted"
        elif bound and len(cur) < size:
            # a bound member proves the gang was fully created and placed
            # (placement is all-or-nothing), so a missing member was
            # force-finalized — node eviction's end state
            broken = f"{size - len(cur)} member(s) vanished"
        if broken:
            self._gang_broken(job, attempt, cur, broken)
            return

        # recovery bookkeeping: a previously-broken gang whose replacement
        # attempt is fully Running closes the MTTR window
        if (key in self._gang_broken_at and len(active) == size
                and all(p.status.phase == t.POD_RUNNING for p in active)):
            dt = time.monotonic() - self._gang_broken_at.pop(key)
            self._gang_retry_at.pop(key, None)
            self._gang_notified.discard(key)
            gang_recovery_seconds.observe(dt)
            self.recorder.event(
                job, "Normal", "GangRecovered",
                f"gang attempt {attempt}: all {size} members Running "
                f"{dt:.2f}s after member death")

        if stale:
            # old-attempt teardown still finalizing: its chips aren't free
            # yet, so re-check shortly instead of racing the replacement
            self.enqueue_after(key, 0.2)
            self._update_status(job, active, succeeded, failed,
                                fail_override=False)
            return
        retry_at = self._gang_retry_at.get(key)
        if retry_at is not None and len(cur) < size:
            now = time.monotonic()
            if now < retry_at:  # capped-backoff window before the recreate
                self.enqueue_after(key, retry_at - now)
                self._update_status(job, active, succeeded, failed,
                                    fail_override=False)
                return
        if len(cur) < size:
            # About to create members from a view that may be STALE in the
            # worst way: the exhausted path force-deletes the survivors and
            # commits the Failed verdict, and those very deletion events
            # re-enqueue this sync — if it runs before the Failed status
            # event is delivered, cur is empty, nothing looks broken (no
            # bound member left to prove a vanish), and the create loop
            # would resurrect the gang as attempt-N pods no sync will ever
            # manage again (observed: orphaned Running pods holding chips
            # forever).  The verdict was committed through our own
            # apiserver, so ONE authoritative read closes the window.
            try:
                fresh = self.cs.jobs.get(job.metadata.name,
                                         job.metadata.namespace)
            except NotFound:
                self._gang_forget(key)
                return
            except (ApiError, OSError):
                self.enqueue_after(key, 0.5)  # transient: re-judge shortly
                return
            if self._finished(fresh):
                self._gang_forget(key)
                return
        if indexed:
            have: Set[int] = set()
            for p in active:
                idx = self._pod_index(p)
                if idx is not None:
                    have.add(idx)
            done: Set[int] = set()
            for p in succeeded:
                idx = self._pod_index(p)
                if idx is not None:
                    done.add(idx)
            for idx in [i for i in range(size)
                        if i not in have and i not in done]:
                self._create_indexed_pod(job, idx, size, attempt=attempt)
        else:
            for _ in range(max(0, size - len(active) - len(succeeded))):
                pod = self._pod_from_template(job)
                pod.metadata.generate_name = f"{job.metadata.name}-"
                self._stamp_gang_member(job, pod, size, attempt)
                try:
                    self.cs.pods.create(pod)
                    self.recorder.event(job, "Normal", "SuccessfulCreate",
                                        f"created pod (gang attempt {attempt})")
                except ApiError:
                    break
        self._update_status(job, active, succeeded, failed,
                            fail_override=False)

    def _gang_broken(self, job: t.Job, attempt: int, cur: List[t.Pod],
                     why: str):
        """One member died: tear the whole attempt down, then either give
        up (attempts exhausted) or schedule the recreate behind a capped
        exponential backoff."""
        key = job.key()
        self._gang_broken_at.setdefault(key, time.monotonic())
        if key not in self._gang_notified:
            self._gang_notified.add(key)
            self.recorder.event(
                job, "Warning", "GangMemberFailed",
                f"gang attempt {attempt}: {why}; tearing down all "
                f"{len(cur)} member(s)")
        if attempt + 1 > job.spec.backoff_limit:
            # exhausted: kill the remains (a broken slice's survivors hold
            # chips) but keep finished pod records for debugging
            self._force_delete_many(
                [p for p in cur if not self._pod_finished(p)])
            active = [p for p in cur if not self._pod_finished(p)
                      and not p.metadata.deletion_timestamp]
            succeeded = [p for p in cur if p.status.phase == t.POD_SUCCEEDED]
            failed = [p for p in cur if p.status.phase == t.POD_FAILED]
            self._update_status(
                job, active, succeeded, failed, fail_override=True,
                fail_reason="GangBackoffLimitExceeded",
                fail_message=(f"gang attempt {attempt} broken ({why}) with "
                              f"all backoff_limit={job.spec.backoff_limit} "
                              f"recreate attempts used"))
            self._gang_retry_at.pop(key, None)
            return
        delay = min(self.gang_backoff_base * (2 ** attempt),
                    self.gang_backoff_cap)
        self._gang_retry_at[key] = time.monotonic() + delay
        nxt = attempt + 1
        try:
            # persist the attempt on the Job FIRST: the bump is what moves
            # every old member into the stale sweep, so a controller crash
            # right here resumes with teardown, never a half-recreate
            self.cs.jobs.patch(
                job.metadata.name,
                {"metadata": {"annotations": {t.GANG_ATTEMPT_LABEL: str(nxt)}}},
                namespace=job.metadata.namespace)
        except NotFound:
            self._gang_forget(key)
            return
        except (ApiError, OSError):
            # transient: the next sync re-detects the broken gang and
            # retries the bump (broken_at/notified are idempotent)
            self.enqueue_after(key, 0.5)
            return
        gang_attempts_total.inc()
        self.recorder.event(
            job, "Normal", "GangRecreate",
            f"recreating gang as attempt {nxt} after {delay:.1f}s backoff")
        # the patch's MODIFIED event re-enqueues this job; that sync's
        # stale sweep tears the old attempt down and creation waits out
        # the backoff window

    def _force_delete(self, pod: t.Pod):
        """Grace-0 delete through the shared retry policy: gang teardown
        must finalize members on DEAD nodes too — no kubelet will ever
        acknowledge a graceful delete there."""
        try:
            call_with_retries(
                lambda: self.cs.pods.delete(
                    pod.metadata.name, pod.metadata.namespace,
                    grace_seconds=0),
                is_transient, steps=3, reason="gang_teardown")
        except NotFound:
            pass
        except (ApiError, OSError):
            pass  # level-triggered: the next sync retries the survivors

    def _force_delete_many(self, pods: List[t.Pod]):
        """Whole-gang teardown as ONE pods/delete:batch request: a gang's
        members die together by policy, so their deletes should commit as
        one store group commit, not N round-trips.  Same semantics as
        _force_delete per member — grace 0, errors left to the next
        level-triggered sync."""
        if not pods:
            return
        if len(pods) == 1:
            self._force_delete(pods[0])
            return
        delete_pods_batch(self.cs, pods, grace_seconds=0,
                          reason="gang_teardown")

    # --------------------------------------------------------------- status

    def _update_status(self, job: t.Job, active, succeeded, failed,
                       fail_override: Optional[bool] = None,
                       fail_reason: str = "BackoffLimitExceeded",
                       fail_message: str = ""):
        """fail_override: gang jobs count ATTEMPTS, not failed pods (the
        teardown deletes them) — None keeps the failed-pod-count rule,
        True/False forces the verdict."""
        completions = job.spec.completions
        indexed = job.spec.completion_mode == "Indexed"
        done_indexes: Set[int] = set()
        if indexed:
            for p in succeeded:
                idx = self._pod_index(p)
                if idx is not None:
                    done_indexes.add(idx)

        fresh = self.cs.jobs.get(job.metadata.name, job.metadata.namespace)

        complete = False
        if indexed:
            want = completions or job.spec.parallelism or 1
            complete = len(done_indexes) >= want
        elif completions is not None:
            complete = len(succeeded) >= completions
        else:
            complete = len(succeeded) > 0 and len(active) == 0
        newly_complete = complete and not self._finished(fresh)
        newly_failed = (
            not newly_complete
            and not self._finished(fresh)
            and (fail_override if fail_override is not None
                 else len(failed) > job.spec.backoff_limit)
        )

        def apply(st):
            st.active = len(active)
            st.succeeded = len(succeeded)
            st.failed = len(failed)
            if not st.start_time:
                st.start_time = now_iso()
            if indexed:
                st.completed_indexes = format_indexes(done_indexes)
            if newly_complete:
                st.completion_time = now_iso()
                st.conditions.append(
                    t.JobCondition(
                        type="Complete", status="True",
                        last_transition_time=now_iso(),
                    )
                )
            elif newly_failed:
                st.conditions.append(
                    t.JobCondition(
                        type="Failed", status="True",
                        reason=fail_reason,
                        last_transition_time=now_iso(),
                    )
                )

        try:
            write_status_if_changed(self.cs.jobs, fresh, apply)
        except NotFound:
            return
        if newly_complete:
            self.recorder.event(job, "Normal", "Completed", "job completed")
        elif newly_failed:
            self.recorder.event(
                job, "Warning", fail_reason,
                fail_message or f"{len(failed)} failed pods exceed "
                                f"backoffLimit={job.spec.backoff_limit}",
            )
