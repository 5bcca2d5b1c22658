"""TTL-after-finished controller: deletes finished Jobs (and their pods via
the garbage collector) once spec.ttl_seconds_after_finished elapses.

The reference's pkg/controller/ttl manages node annotations; run-to-completion
cleanup did not exist in 1.9 (jobs piled up forever). For a cluster that
churns through training Jobs this is table stakes, so the controller follows
the later upstream ttlafterfinished design instead.  The port's copy of the
JAX package's ``controllers/ttl.py``."""

from __future__ import annotations

import datetime

from ..machinery import ApiError, NotFound
from .base import Controller


def _parse_iso(ts: str):
    try:
        return datetime.datetime.fromisoformat(ts.replace("Z", "+00:00"))
    except ValueError:
        return None


class TTLAfterFinishedController(Controller):
    name = "ttl-after-finished-controller"
    WORKERS = 1

    @staticmethod
    def _now():
        return datetime.datetime.now(datetime.timezone.utc)

    def setup(self):
        self.jobs = self.factory.informer("jobs")
        self.jobs.add_handler(
            on_add=self.enqueue, on_update=lambda _o, n: self.enqueue(n)
        )

    def sync(self, key: str):
        job = self.jobs.get(key)
        if job is None or job.spec.ttl_seconds_after_finished is None:
            return
        finished_at = None
        for cond in job.status.conditions:
            if cond.type in ("Complete", "Failed") and cond.status == "True":
                finished_at = _parse_iso(cond.last_transition_time) or self._now()
        if finished_at is None:
            return
        expiry = finished_at + datetime.timedelta(
            seconds=job.spec.ttl_seconds_after_finished
        )
        remaining = (expiry - self._now()).total_seconds()
        if remaining > 0:
            self.enqueue_after(key, min(remaining, 30.0))
            return
        try:
            self.cs.jobs.delete(job.metadata.name, job.metadata.namespace)
        except (NotFound, ApiError):
            pass
