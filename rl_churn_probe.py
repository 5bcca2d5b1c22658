"""Probe of chip_smoke.py's RL leg: what an actor's start costs, and what
reaches the learner while the churn driver recycles the actors.

Run on a machine with the card, from the root of the repo:

    python3 rl_churn_probe.py [--blas 8,default] [--burners 0,6] [--actors N]

For each value of ``--blas`` it starts one cluster as ``chip_smoke.py``
does (``Cluster``) with ``OPENBLAS_NUM_THREADS`` set to that value in the
components' environment, which the kubelet hands to every pod
(``default``: left unset), and runs ``chip_smoke.rl_leg`` (with
``--actors`` in place of its ``RL_ACTORS``) once for each value of
``--burners``, with that many busy-looping processes beside it
to stand for a host that other work holds.  Before the clusters it times
the start of ``python``, of ``import numpy`` and of an actor that does
nothing (``--lifetime 0``), five times each under each BLAS setting.

A line per leg: the learner's batches, the actor-restart p50, and, from
/proc every half second, the actor processes seen, the median of their
lives and the median of the CPU seconds each burnt.  A leg that fails
prints its message and the probe goes on.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import chip_smoke as cs

HZ = os.sysconf("SC_CLK_TCK")


def _cpu_s(pid: int):
    """User plus system CPU seconds of a process and its threads; None once it is gone."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
    except OSError:
        return None
    return (int(fields[11]) + int(fields[12])) / HZ


def _set_blas(value: str):
    if value == "default":
        os.environ.pop("OPENBLAS_NUM_THREADS", None)
    else:
        os.environ["OPENBLAS_NUM_THREADS"] = value


def startup_times():
    env = {**os.environ, "PYTHONPATH": cs.REPO_ROOT}
    for name, cmd in (("python", ["python", "-c", "pass"]),
                      ("import numpy", ["python", "-c", "import numpy"]),
                      ("actor, lifetime 0", ["python", "-m", cs.rl_actor.MODULE, "--actor",
                                             "--lifetime", "0"])):
        took = []
        for _ in range(5):
            t0 = time.perf_counter()
            subprocess.run(cmd, cwd=cs.REPO_ROOT, env=env, capture_output=True, check=True)
            took.append(round(time.perf_counter() - t0, 3))
        print(f"start: {name}: {took} s", flush=True)


def watch_actors(cl: "cs.Cluster", stop: threading.Event, seen: dict):
    """Every half second: each actor process of the cluster, when it was
    first and last seen, and the CPU it had burnt."""
    t0 = time.monotonic()
    while not stop.is_set():
        now = time.monotonic() - t0
        for pid, env in cs._pod_pids(cl.url).items():
            if "KTPU_LEARNER_ADDR" in env:
                cpu = _cpu_s(pid)
                rec = seen.setdefault(pid, {"first": now, "cpu": 0.0})
                rec["last"] = now
                if cpu is not None:
                    rec["cpu"] = cpu
        stop.wait(0.5)


def one_cluster(card: str, burners: list):
    cl = cs.Cluster(tempfile.mkdtemp(prefix="cluster_"))
    try:
        devs = cl.advertised()
        card_id, uuid = devs[0]["id"], devs[0]["attributes"]["nvidia.com/gpu/uuid"]
        for n in burners:
            busy = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
                    for _ in range(n)]
            stop, seen = threading.Event(), {}
            watcher = threading.Thread(target=watch_actors, args=(cl, stop, seen), daemon=True)
            try:
                cs._wait("the learner's port to be free",
                         lambda: cs._refused(cs.rl_actor.LEARNER_PORT), 60)
                watcher.start()
                try:
                    res = cs.rl_leg(cl, card, card_id, uuid)
                    said = (f"batches {res['learner']['batches']} actor_restart_p50_s "
                            f"{res['churn']['actor_restart_p50_s']}")
                except SystemExit:
                    said = f"FAILED: {cs.FAILURES[-1]}"
                    cl.delete_job("rl-learner")
            finally:
                stop.set()
                watcher.join()
                for p in busy:
                    p.kill()
                    p.wait()
            cl.client.services.delete("rl-actors")
            lives = [r["last"] - r["first"] for r in seen.values()]
            cpus = [r["cpu"] for r in seen.values()]
            print(f"leg: OPENBLAS_NUM_THREADS={os.environ.get('OPENBLAS_NUM_THREADS', 'unset')} "
                  f"burners {n}: {said}; {len(seen)} actor processes, median life "
                  f"{statistics.median(lives or [0]):.2f} s, median CPU "
                  f"{statistics.median(cpus or [0]):.2f} s on [{card}]", flush=True)
    finally:
        survivors = cl.stop()
    if survivors:
        print(f"probe: pod processes {survivors} survived the teardown", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blas", default="8,default",
                    help="OPENBLAS_NUM_THREADS values, a cluster each ('default': unset)")
    ap.add_argument("--burners", default="0,6", help="busy processes beside each leg")
    ap.add_argument("--actors", type=int, default=cs.RL_ACTORS,
                    help="the churned fleet's size (chip_smoke.py's RL_ACTORS by default)")
    args = ap.parse_args()
    cs.RL_ACTORS = args.actors
    blas = args.blas.split(",")
    burners = [int(n) for n in args.burners.split(",")]
    card = cs.card_line()
    print(card, flush=True)
    for value in blas:
        _set_blas(value)
        print(f"OPENBLAS_NUM_THREADS={os.environ.get('OPENBLAS_NUM_THREADS', 'unset')}",
              flush=True)
        startup_times()
    for value in blas:
        _set_blas(value)
        one_cluster(card, burners)
    print(json.dumps({"ok": not cs.FAILURES}), flush=True)


if __name__ == "__main__":
    main()
