"""Podracer-style RL actor/learner pairing and the actor-swarm churn driver.

The port's copy of the JAX package's ``workloads/rl_actor``, with the same
names, labels, port, metric names (``ktpu_rl_*``) and result keys.  The
Podracer shape (PAPERS.md): many short-lived actor pods, continuously
created and deleted, stream experience to a long-lived, gang-scheduled
learner.

- ``rollout`` / ``Learner`` / ``run_actor``: REINFORCE on a multi-armed
  bandit.  Actors roll out with the learner's current policy and POST the
  batches over HTTP (to ``KTPU_LEARNER_ADDR``); the learner folds each
  batch into its weights and serves /weights, /stats and /metrics.
  Actors are CPU pods and stay numpy: what the churn driver measures is
  an actor's restart, so this module imports no torch at its top level.
  The learner holds its weights on the card it was given and updates them
  in torch, in float64.
- spec builders (``actor_pod``, ``learner_job``, ``fleet_service``): the
  wire-form dicts (as ``workloads.specs`` builds them) that a driver
  creates; a pod asks for cards in the pod-level form.
- ``ChurnDriver``: recycles an actor fleet at a target rate of creates
  and deletes a second against a live cluster, through the port's
  apiserver client: the deletes of a wave in one ``pods/delete:batch``
  (or one DELETE a pod, the A/B control), the replacements created at
  once under generation-suffixed names.  It measures the ops a second
  achieved and each slot's actor-restart latency (delete issued ->
  replacement Ready).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from ..client.errors import AlreadyExists, ApiError, NotFound
from ..client.informer import SharedInformer
from .specs import gpu_request, pod_ready

ACTOR_APP_LABEL = "rl-actor"
LEARNER_APP_LABEL = "rl-learner"
LEARNER_PORT = 8476
MODULE = "kubernetes1_tpu_torch.workloads.rl_actor"
# The most slots one wave recycles.
RECYCLE_CHUNK = 16
# What a call to the apiserver may fail with: its Status errors, and the
# client's transport failures (ConnectionError, TimeoutError: OSErrors).
CLIENT_ERRORS = (ApiError, OSError)


# ---------------------------------------------------------------- the RL math
#
# A K-armed bandit under a softmax policy: rollouts sample arms, an arm pays
# a Bernoulli reward, and the learner applies REINFORCE (reward-weighted
# log-probability gradients).


def _softmax(w):
    import numpy as np

    z = np.exp(w - w.max())
    return z / z.sum()


def rollout(weights, steps: int = 64, seed: int = 0) -> Dict[str, list]:
    """One experience batch under the policy ``weights``: the sampled arms
    and their rewards, as lists (ready to POST).  Arm i of K pays with
    probability (i + 1) / (K + 1)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    w = np.asarray(weights, dtype=np.float64)
    k = len(w)
    arms = rng.choice(k, size=steps, p=_softmax(w))
    pay = (arms + 1) / (k + 1)
    rewards = (rng.random(steps) < pay).astype(np.float64)
    return {"arms": arms.tolist(), "rewards": rewards.tolist()}


def reinforce_update(weights, batch: Dict[str, list], lr: float = 0.05):
    """One REINFORCE step over a batch, on the weights' device: returns the
    new weights (a float64 tensor) and the batch's mean reward.

    The JAX package's loop adds lr * (r - b) * (onehot(a) - p) a step, with
    the policy p fixed before the loop and b the mean reward, so the sum
    over the batch is one expression: each arm gets its steps' lr * (r - b),
    and p is taken lr * sum(r - b) times.  A batch whose arms and rewards
    differ in length, or whose arm lies outside the policy, is refused
    (ValueError)."""
    import numpy as np
    import torch

    w = torch.as_tensor(weights, dtype=torch.float64)
    arms = np.asarray(batch.get("arms") or [], dtype=np.int64)
    rewards = np.asarray(batch.get("rewards") or [], dtype=np.float64)
    if arms.ndim != 1 or arms.shape != rewards.shape:
        raise ValueError(f"arms {arms.shape} and rewards {rewards.shape} differ")
    if arms.size == 0:
        return w.clone(), 0.0
    if arms.min() < 0 or arms.max() >= w.numel():
        raise ValueError(f"an arm outside 0..{w.numel() - 1}")
    r = torch.from_numpy(rewards).to(w.device)
    baseline = r.mean()
    z = torch.exp(w - w.max())
    probs = z / z.sum()
    adv = lr * (r - baseline)
    step = torch.zeros_like(w).index_add_(0, torch.from_numpy(arms).to(w.device), adv)
    return w + step - adv.sum() * probs, float(baseline)


class Learner:
    """The long-lived half: takes experience over HTTP, updates its policy
    and serves its weights, stats and /metrics.  The weights live on
    ``device``: the card unless ``device="cpu"``; without a card it raises."""

    def __init__(self, arms: int = 8, port: int = 0, lr: float = 0.05, device=None):
        import torch

        from ..obs.appmetrics import AppMetrics
        from .sharding import resolve_device

        self.device = resolve_device(device)
        self.weights = torch.zeros(arms, dtype=torch.float64, device=self.device)
        self.lr = lr
        self.batches = 0
        self.frames = 0
        self.updates = 0
        self.mean_reward = 0.0
        self._lock = threading.Lock()
        self._srv: Optional[ThreadingHTTPServer] = None
        self._port = port
        # the workload's SLIs on its own /metrics (the obs.ktpu.io scrape
        # contract): the ingest rate is what an HPA scales a learner tier on
        self.metrics = AppMetrics()
        self.ingest_total = self.metrics.counter(
            "ktpu_rl_ingest_total", "experience batches ingested")
        self.ingest_inflight = self.metrics.gauge(
            "ktpu_rl_ingest_inflight", "ingest requests in flight")
        self.ingest_latency = self.metrics.histogram(
            "ktpu_rl_ingest_latency_seconds", "ingest handling latency")
        self.ingest_errors_total = self.metrics.counter(
            "ktpu_rl_ingest_errors_total", "rejected experience batches")

    def ingest(self, batch: Dict[str, list]):
        t0 = time.monotonic()
        self.ingest_inflight.inc()
        try:
            with self._lock:
                self.weights, mean_r = reinforce_update(self.weights, batch, lr=self.lr)
                self.batches += 1
                self.frames += len(batch.get("arms") or [])
                self.updates += 1
                self.mean_reward = mean_r
        except Exception:
            # a rejected batch does not count toward the ingest SLIs: an HPA
            # would read a stream of bad requests as load
            self.ingest_errors_total.inc()
            raise
        finally:
            self.ingest_inflight.inc(-1)
        self.ingest_total.inc()
        self.metrics.mark("ktpu_rl_ingest_qps")
        self.ingest_latency.observe(time.monotonic() - t0)

    def weight_list(self) -> List[float]:
        with self._lock:
            return self.weights.tolist()

    def stats(self) -> dict:
        with self._lock:
            return {"batches": self.batches, "frames": self.frames, "updates": self.updates,
                    "mean_reward": round(self.mean_reward, 4),
                    "weights": [round(x, 4) for x in self.weights.tolist()]}

    # -------------------------------------------------------------- server

    def start(self) -> "Learner":
        learner = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, body: bytes, ctype: str = "application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code, obj):
                self._send(code, json.dumps(obj).encode())

            def do_GET(self):
                if self.path.startswith("/stats"):
                    self._json(200, learner.stats())
                elif self.path.startswith("/weights"):
                    self._json(200, {"weights": learner.weight_list()})
                elif self.path.startswith("/metrics"):
                    self._send(200, learner.metrics.render().encode(),
                               "text/plain; version=0.0.4")
                else:
                    self._json(404, {"error": "unknown path"})

            def do_POST(self):
                if not self.path.startswith("/experience"):
                    self._json(404, {"error": "unknown path"})
                    return
                n = int(self.headers.get("Content-Length") or 0)
                try:
                    batch = json.loads(self.rfile.read(n) or b"{}")
                except ValueError:
                    self._json(400, {"error": "bad json"})
                    return
                try:
                    learner.ingest(batch)
                except (ValueError, TypeError, AttributeError):
                    self._json(400, {"error": "bad batch"})
                    return
                self._json(200, {"ok": True})

        self._srv = ThreadingHTTPServer(("127.0.0.1", self._port), Handler)
        self._srv.daemon_threads = True
        threading.Thread(target=self._srv.serve_forever, daemon=True,
                         name="rl-learner").start()
        return self

    @property
    def url(self) -> str:
        host, port = self._srv.server_address[:2]
        return f"http://{host}:{port}"

    def stop(self):
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
        self.metrics.stop()


def run_actor(learner_url: str, lifetime_s: float = 30.0, steps_per_batch: int = 64,
              seed: int = 0, interval_s: float = 0.05) -> dict:
    """The short-lived half: pull the weights, roll out, POST the batch, and
    again until the lifetime ends, then return (recycling is the driver's
    job).  Transport errors are counted, not raised: an actor that outlives
    its learner for a beat must not crash."""
    import urllib.request

    import numpy as np

    w = None
    sent = frames = errors = 0
    deadline = time.monotonic() + lifetime_s
    i = 0
    while time.monotonic() < deadline:
        if w is None:
            try:
                with urllib.request.urlopen(learner_url + "/weights", timeout=2.0) as r:
                    w = np.asarray(json.loads(r.read()).get("weights") or [0.0] * 8)
            except OSError:
                w = np.zeros(8)
        batch = rollout(w, steps=steps_per_batch, seed=seed * 100003 + i)
        i += 1
        req = urllib.request.Request(learner_url + "/experience",
                                     data=json.dumps(batch).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=2.0):
                pass
            sent += 1
            frames += len(batch["arms"])
            w = None  # the next batch takes the updated policy
        except OSError:
            errors += 1
        if interval_s:
            time.sleep(interval_s)
    return {"batches_sent": sent, "frames": frames, "errors": errors}


# ------------------------------------------------------------- spec builders


def actor_pod(slot: int, gen: int = 0, ns: str = "default", app: str = ACTOR_APP_LABEL,
              name_prefix: str = "actor", gpus: int = 0, lifetime_s: float = 30.0,
              learner_addr: str = "", cpu: str = "10m") -> dict:
    """One actor: a generation-suffixed name (recycling a slot never reuses
    a live name), the fleet's label for the Service's selector, and no card
    by default: actors pack on shared hosts, learners own cards."""
    name = f"{name_prefix}-{slot}-g{gen}"
    c = {"name": "actor", "image": "ktpu/rl-actor",
         "command": ["python", "-m", MODULE, "--actor", "--lifetime", str(lifetime_s)],
         "resources": {"requests": {"cpu": cpu}}}
    if learner_addr:
        c["env"] = [{"name": "KTPU_LEARNER_ADDR", "value": learner_addr}]
    spec = {"containers": [c], "restartPolicy": "Never"}
    if gpus:
        gpu_request(spec, gpus, name=f"{name}-gpu")
    return {"metadata": {"name": name, "namespace": ns,
                         "labels": {"app": app, "rl.ktpu.io/slot": str(slot)}},
            "spec": spec}


def learner_job(name: str = "rl-learner", ns: str = "default", workers: int = 2,
                gpus_per_worker: int = 1, gang: bool = True, scrape_port: int = 0,
                scrape_host: str = "") -> dict:
    """The learner: an Indexed Job of ``workers`` pods, gang-scheduled when
    ``gang``, each holding ``gpus_per_worker`` cards in the pod-level form.
    ``scrape_port`` opts the workers into the kubelet's /metrics scrape
    (``scrape_host``: the loopback host of a learner in this process, as
    in-process clusters give pods synthetic IPs)."""
    from ..obs.appmetrics import scrape_annotations

    pod_spec = {"containers": [{"name": "learner", "image": "ktpu/rl-learner",
                                "command": ["python", "-m", MODULE, "--learner"]}]}
    if gpus_per_worker:
        gpu_request(pod_spec, gpus_per_worker)
    tmeta = {"labels": {"app": LEARNER_APP_LABEL}}
    if scrape_port:
        tmeta["annotations"] = scrape_annotations(scrape_port, host=scrape_host)
    spec = {"parallelism": workers, "completions": workers, "backoffLimit": 20,
            "template": {"metadata": tmeta, "spec": pod_spec}, "completionMode": "Indexed"}
    if gang:
        spec["gangScheduling"] = True
    return {"metadata": {"name": name, "namespace": ns}, "spec": spec}


def fleet_service(name: str, ns: str = "default", app: str = ACTOR_APP_LABEL,
                  port: int = LEARNER_PORT) -> dict:
    """A Service fronting a fleet by its app label: the Endpoints object
    that churns with the fleet."""
    return {"metadata": {"name": name, "namespace": ns},
            "spec": {"selector": {"app": app},
                     "ports": [{"name": "rl", "port": port, "targetPort": port}]}}


def ready_fleet_ips(client, namespace: str = "default", app: str = ACTOR_APP_LABEL):
    """The IPs of the fleet's Running, Ready, non-terminating pods: what
    the fleet Service's Endpoints must converge to.  None when the
    apiserver did not answer."""
    try:
        pods, _ = client.pods.list(namespace, f"app={app}")
    except CLIENT_ERRORS:
        return None
    return {(p.get("status") or {}).get("podIp") or (p.get("status") or {}).get("hostIp")
            for p in pods if pod_ready(p)}


def service_endpoint_ips(client, name: str, namespace: str = "default"):
    """The addresses of a Service's Endpoints; None when it has not been
    written or the apiserver did not answer."""
    try:
        ep = client.endpoints.get(name, namespace)
    except CLIENT_ERRORS:
        return None
    return {a.get("ip") for s in ep.get("subsets") or [] for a in s.get("addresses") or []}


# --------------------------------------------------------------- churn driver


class ChurnDriver:
    """Recycle an actor fleet at a target churn rate against a live cluster.

    One recycle = delete the slot's pod + create its replacement under the
    next generation's name = 2 ops toward the rate.  The deletes of a wave
    go as one ``pods/delete:batch`` (``use_batch=False``: one DELETE a pod).
    Replacements are watched through a label-selected informer; a slot's
    restart latency runs from its delete to its replacement Running.

    Only Ready slots recycle: the driver measures the churn the whole
    pipeline sustains, and counts starved ticks rather than pile work onto
    a wedged control plane."""

    def __init__(self, client, namespace: str = "default", actors: int = 16,
                 rate: float = 50.0, use_batch: bool = True, grace_seconds: int = 0,
                 gpus_per_actor: int = 0, app: str = ACTOR_APP_LABEL,
                 learner_addr: str = ""):
        self.client = client
        self.namespace = namespace
        self.actors = int(actors)
        self.rate = float(rate)
        self.use_batch = bool(use_batch)
        self.grace_seconds = grace_seconds
        self.gpus_per_actor = int(gpus_per_actor)
        self.app = app
        self.learner_addr = learner_addr
        self._slots: List[dict] = [
            {"slot": i, "gen": 0, "name": "", "state": "new", "t_issue": 0.0,
             "created": False} for i in range(self.actors)]
        self._ready_names: set = set()
        self._ready_lock = threading.Lock()
        # the measurements are bumped from several recycle workers
        self._stat_lock = threading.Lock()
        self._informer = SharedInformer(client.pods, namespace, f"app={app}")
        self._informer.add_handler(on_add=self._observe,
                                   on_update=lambda _old, new: self._observe(new))
        # old generations whose delete failed (or may not have landed): swept
        # on every settle, so a fault never leaks a pod past the run;
        # guarded by _stat_lock
        self._garbage: set = set()
        self._garbage_retry_at = 0.0
        self.creates = 0
        self.deletes = 0
        self.create_errors = 0
        self.delete_errors = 0
        self.starved_ticks = 0
        self.restart_latencies: List[float] = []
        self._wall = 0.0

    # ------------------------------------------------------------ plumbing

    def _observe(self, pod: dict):
        if (pod.get("status") or {}).get("phase") == "Running" and \
                not pod["metadata"].get("deletionTimestamp"):
            with self._ready_lock:
                self._ready_names.add(pod["metadata"]["name"])

    def _pod_for(self, slot: dict) -> dict:
        return actor_pod(slot["slot"], gen=slot["gen"], ns=self.namespace, app=self.app,
                         gpus=self.gpus_per_actor, learner_addr=self.learner_addr)

    def _create(self, slot: dict) -> bool:
        pod = self._pod_for(slot)
        try:
            self.client.pods.create(pod)
        except AlreadyExists:
            pass  # an earlier attempt's create did land
        except CLIENT_ERRORS:
            with self._stat_lock:
                self.create_errors += 1
            return False
        slot["name"] = pod["metadata"]["name"]
        slot["created"] = True
        with self._stat_lock:
            self.creates += 1
        return True

    # ------------------------------------------------------------- control

    def start(self, ready_timeout: float = 60.0) -> "ChurnDriver":
        """Create the fleet and wait until every slot is Ready."""
        self._informer.start()
        self._informer.wait_for_sync(15.0)
        for slot in self._slots:
            slot["state"] = "recycling"
            # t_issue 0.0: the fleet's bring-up, which is no restart and
            # stays out of the restart latencies
            slot["t_issue"] = 0.0
            self._create(slot)
        deadline = time.monotonic() + ready_timeout
        while time.monotonic() < deadline:
            self._settle()
            if all(s["state"] == "ready" for s in self._slots):
                return self
            time.sleep(0.1)
        ready = sum(1 for s in self._slots if s["state"] == "ready")
        raise RuntimeError(f"churn fleet never became ready: {ready}/{self.actors}")

    def _settle(self, slots=None):
        """Fold the informer's observations into the slots (a worker settles
        only its own); a restart's latency closes when the replacement turns
        Ready.  Also sweeps the garbage."""
        with self._ready_lock:
            ready = set(self._ready_names)
        for slot in (self._slots if slots is None else slots):
            if slot["state"] == "recycling":
                if not slot["created"]:
                    self._create(slot)  # the earlier create failed: again
                elif slot["name"] in ready:
                    slot["state"] = "ready"
                    if slot["t_issue"]:
                        with self._stat_lock:
                            self.restart_latencies.append(time.monotonic() - slot["t_issue"])
        with self._stat_lock:
            sweep_due = self._garbage and time.monotonic() >= self._garbage_retry_at
            if sweep_due:
                self._garbage_retry_at = time.monotonic() + 0.5
        if sweep_due:
            self._sweep_garbage()

    def _sweep_garbage(self):
        with self._stat_lock:
            names = sorted(self._garbage)
        if not names:
            return
        try:
            outs = self.client.delete_batch(self.namespace, names, grace_seconds=0)
        except CLIENT_ERRORS:
            return  # still failing: the next settle retries
        with self._stat_lock:
            for n, err in zip(names, outs):
                if err is None or isinstance(err, NotFound):
                    self._garbage.discard(n)

    def _recycle(self, slots: List[dict]):
        if not slots:
            return
        now = time.monotonic()
        doomed = []
        for slot in slots:
            doomed.append(slot["name"])
            slot["state"] = "recycling"
            slot["t_issue"] = now
            slot["gen"] += 1
            slot["created"] = False
        with self._ready_lock:
            # the set tracks the live names, not every name a run minted
            self._ready_names.difference_update(doomed)
        if self.use_batch:
            try:
                outs = self.client.delete_batch(self.namespace, doomed,
                                                grace_seconds=self.grace_seconds)
                # count only the deletes that landed (or found the pod gone),
                # as the singleton leg does
                with self._stat_lock:
                    for name, err in zip(doomed, outs):
                        if err is None or isinstance(err, NotFound):
                            self.deletes += 1
                        else:
                            self.delete_errors += 1
                            self._garbage.add(name)
            except CLIENT_ERRORS:
                # the call may have landed: sweep the names until they are gone
                with self._stat_lock:
                    self.delete_errors += len(doomed)
                    self._garbage.update(doomed)
        else:
            for name in doomed:
                try:
                    self.client.pods.delete(name, self.namespace,
                                            grace_seconds=self.grace_seconds)
                    ok = True
                except NotFound:
                    ok = True
                except CLIENT_ERRORS:
                    ok = False
                with self._stat_lock:
                    if ok:
                        self.deletes += 1
                    else:
                        self.delete_errors += 1
                        self._garbage.add(name)
        for slot in slots:
            self._create(slot)

    def run(self, duration: float = 20.0, tick: float = 0.05, workers: int = 1) -> dict:
        """Churn for ``duration`` seconds at the target rate; returns
        ``result()``.  ``workers`` threads split the slots (slot % workers)
        and the rate between them; a worker's unexpected error is raised
        here once all have ended, as one worker's would be."""
        workers = max(1, int(workers))
        t0 = time.monotonic()
        if workers == 1:
            self._run_worker(self._slots, self.rate, duration, tick, t0)
        else:
            failed: List[BaseException] = []

            def work(slots):
                try:
                    self._run_worker(slots, self.rate / workers, duration, tick, t0)
                except BaseException as e:  # noqa: BLE001 - re-raised below, after the join
                    failed.append(e)

            threads = [threading.Thread(
                target=work, args=([s for s in self._slots if s["slot"] % workers == w],),
                daemon=True, name=f"churn-worker-{w}") for w in range(workers)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=duration + 60.0)
            if failed:
                raise failed[0]
        self._wall = time.monotonic() - t0
        self._settle()
        return self.result()

    def _run_worker(self, slots: List[dict], rate: float, duration: float, tick: float,
                    t0: float):
        issued = 0
        next_slot = 0
        while time.monotonic() - t0 < duration:
            self._settle(slots)
            want = int((rate * (time.monotonic() - t0)) // 2) - issued
            # whole waves until the deficit is paid or no slot is eligible:
            # each wave's calls pace the loop
            while want > 0:
                eligible = [s for s in slots if s["state"] == "ready"]
                if not eligible:
                    with self._stat_lock:
                        self.starved_ticks += 1
                    break
                # round-robin over the slots, so every actor churns
                eligible.sort(key=lambda s: (s["slot"] - next_slot) % self.actors)
                chunk = eligible[:min(want, RECYCLE_CHUNK)]
                next_slot = (chunk[-1]["slot"] + 1) % self.actors
                self._recycle(chunk)
                issued += len(chunk)
                want -= len(chunk)
                if time.monotonic() - t0 >= duration:
                    break
            time.sleep(tick)

    def drain(self, timeout: float = 30.0) -> bool:
        """Delete the whole fleet (the slots, the garbage and anything else
        with the fleet's label) and wait until the apiserver lists no
        actor."""
        deadline = time.monotonic() + timeout
        names = {s["name"] for s in self._slots if s["created"]} | self._garbage
        while time.monotonic() < deadline:
            try:
                pods, _ = self.client.pods.list(self.namespace, f"app={self.app}")
            except CLIENT_ERRORS:
                time.sleep(0.2)
                continue
            names |= {p["metadata"]["name"] for p in pods}
            if not pods and not names:
                return True
            if names:
                try:
                    self.client.delete_batch(self.namespace, sorted(names), grace_seconds=0)
                    names.clear()
                except CLIENT_ERRORS:
                    pass  # retried on the next pass
            time.sleep(0.2)
        return False

    def stop(self):
        self._informer.stop()

    def result(self) -> dict:
        lats = sorted(self.restart_latencies)

        def pct(q):
            return round(lats[min(len(lats) - 1, int(q * len(lats)))], 4) if lats else None

        ops = self.creates + self.deletes
        return {
            "actors": self.actors,
            "target_rate_ops_s": self.rate,
            "ops": ops,
            "creates": self.creates,
            "deletes": self.deletes,
            "wall_s": round(self._wall, 2),
            "ops_per_s": round(ops / self._wall, 1) if self._wall else None,
            "recycles_completed": len(lats),
            "actor_restart_p50_s": pct(0.50),
            "actor_restart_p99_s": pct(0.99),
            "create_errors": self.create_errors,
            "delete_errors": self.delete_errors,
            "starved_ticks": self.starved_ticks,
            "mode": "batched" if self.use_batch else "singleton",
            "grace_seconds": self.grace_seconds,
        }


# ----------------------------------------------------------------------- main


def main(argv=None):
    import argparse
    import os

    ap = argparse.ArgumentParser(description="Podracer-style RL actor/learner")
    ap.add_argument("--actor", action="store_true")
    ap.add_argument("--learner", action="store_true")
    ap.add_argument("--lifetime", type=float, default=30.0)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--port", type=int, default=LEARNER_PORT)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the learner's torch device (the card by default; 'cpu')")
    args = ap.parse_args(argv)
    if args.learner:
        import torch

        learner = Learner(port=args.port, device=args.device).start()
        where = torch.cuda.get_device_name(learner.device) \
            if learner.device.type == "cuda" else learner.device.type
        print(f"learner serving on {learner.url} on {where}", flush=True)
        try:
            while True:
                time.sleep(5)
                print(json.dumps(learner.stats()), flush=True)
        except KeyboardInterrupt:
            learner.stop()
        return
    # an actor is a numpy process in a pod of a hundredth of a core, and
    # under churn it lives a second or two: numpy's OpenBLAS pool, a thread
    # a host core, doubles the CPU each actor burns in that life, and a few
    # such actors starve each other and the control plane
    os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")
    addr = os.environ.get("KTPU_LEARNER_ADDR", f"http://127.0.0.1:{args.port}")
    if not addr.startswith("http"):
        addr = f"http://{addr}"
    out = run_actor(addr, lifetime_s=args.lifetime, steps_per_batch=args.steps, seed=args.seed)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
