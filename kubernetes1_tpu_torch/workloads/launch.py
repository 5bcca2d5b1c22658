"""The pod launcher: starts one process per card of a GPU pod under
``torchrun``, from the env that the device plugin injected.

    python -m kubernetes1_tpu_torch.workloads.launch [--timeout S] -m <module> <args...>

It does for a GPU pod what the TPU runtime does with ``TPU_WORKER_ID`` and
``TPU_WORKER_HOSTNAMES``.  The port's plugin turns the annotations that
the Job controller stamps on each pod of an Indexed Job into ``RANK`` (the
worker index), ``WORLD_SIZE`` (the number of workers) and
``MASTER_ADDR``/``MASTER_PORT`` (``<job>-0.<ns>`` and its port), and the
pod's cards into ``CUDA_VISIBLE_DEVICES``.  From those alone:

- k, the processes this pod starts, is the number of cards in
  ``CUDA_VISIBLE_DEVICES`` (1 without it): one process a card, so a
  k-card pod uses all k, where a bare ``python`` would use one;
- the coordinator's address is its name when the name resolves;
  otherwise the pod ``<job>-0`` in namespace ``<ns>`` is looked up through
  the apiserver at ``KTPU_APISERVER`` (the kubelet sets it in every pod),
  and its ``status.podIP`` taken once it has one.  The orchestrator's
  cluster DNS answers only Service names, and under the process runtime a
  pod's resolver is the host's, so ``<job>-0.<ns>`` may not resolve;
- then it prints one line (rank, world, k, the coordinator's name and the
  address it took) and execs ``torchrun`` (``python -m
  torch.distributed.run``, its module form) with ``--nnodes=WORLD_SIZE
  --node-rank=RANK --nproc-per-node=k --master-addr=<address>
  --master-port=MASTER_PORT``, whose static rendezvous gives each process
  its global rank.

A pod that no Indexed Job made (no coordinator in its env) is a world of
its own: rank 0 of 1 on a free local port.

Nothing hangs: a coordinator whose pod never gets an address ends the
launcher with exit code 1 and a message within ``--timeout``; what is left
of the limit goes to torchrun as its rendezvous timeout, so a world that
never forms ends torchrun non-zero about then (plus torchrun's own start).
"""

from __future__ import annotations

import argparse
import math
import os
import socket
import sys
import time
from typing import List, Optional, Tuple

DEFAULT_TIMEOUT_S = 900.0  # a gang on real hosts: pods pulled, scheduled and started
POLL_S = 0.2
# torchrun's own start (its import of torch) before its rendezvous begins,
# kept out of the rendezvous's share of the limit
TORCHRUN_START_S = 5.0


def cards_in_pod(env=os.environ) -> int:
    """k: the cards in ``CUDA_VISIBLE_DEVICES``, 1 when it names none."""
    return len([c for c in env.get("CUDA_VISIBLE_DEVICES", "").split(",") if c.strip()]) or 1


def resolves(name: str) -> bool:
    """Whether the resolver answers ``name``."""
    try:
        return bool(socket.getaddrinfo(name, None, type=socket.SOCK_STREAM))
    except (OSError, UnicodeError):
        return False


def coordinator_pod(name: str) -> Tuple[str, str]:
    """(pod, namespace) of a coordinator named ``<pod>.<ns>[.<more>]``;
    a bare name is in ``default``."""
    pod, _, rest = name.partition(".")
    return pod, rest.split(".")[0] or "default"


def pod_ip(apiserver: str, name: str, deadline: float) -> Optional[str]:
    """The ``status.podIP`` of the coordinator's pod, asked of the
    apiserver until it has one; None at ``deadline`` (monotonic)."""
    from ..client.errors import ApiError
    from ..client.rest import Client

    pod, ns = coordinator_pod(name)
    client = Client(apiserver, timeout=max(1.0, min(10.0, deadline - time.monotonic())))
    try:
        while True:
            try:
                status = client.pods.get(pod, ns).get("status") or {}
                # the orchestrator's wire form spells it podIp, Kubernetes' podIP
                ip = status.get("podIp") or status.get("podIP")
                if ip:
                    return ip
            except (ApiError, OSError):
                pass  # not created yet, or the apiserver is away: ask again
            if time.monotonic() + POLL_S > deadline:
                return None
            time.sleep(POLL_S)
    finally:
        client.close()


def coordinator_address(name: str, deadline: float, env=os.environ) -> Tuple[str, str]:
    """(address, how it was found) for the coordinator ``name``; raises
    RuntimeError when it cannot be found by ``deadline``."""
    if resolves(name):
        return name, "resolved by name"
    apiserver = env.get("KTPU_APISERVER")
    if not apiserver:
        raise RuntimeError(f"the coordinator {name} does not resolve, and no KTPU_APISERVER "
                           f"is set to look up its pod")
    pod, ns = coordinator_pod(name)
    ip = pod_ip(apiserver, name, deadline)
    if ip is None:
        raise RuntimeError(f"the coordinator {name} does not resolve, and its pod {ns}/{pod} "
                           f"had no podIP at {apiserver} within the timeout")
    return ip, f"podIP of {ns}/{pod} from the apiserver"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _split(argv: List[str]) -> Tuple[List[str], str, List[str]]:
    """(the launcher's options, the module, the module's arguments)."""
    if "-m" not in argv or argv.index("-m") + 1 >= len(argv):
        raise SystemExit("usage: python -m kubernetes1_tpu_torch.workloads.launch "
                         "[--timeout S] -m <module> <args...>")
    at = argv.index("-m")
    return argv[:at], argv[at + 1], argv[at + 2:]


def main(argv: Optional[List[str]] = None):
    own, module, args = _split(list(sys.argv[1:] if argv is None else argv))
    ap = argparse.ArgumentParser(prog="python -m kubernetes1_tpu_torch.workloads.launch",
                                 description="start one process per card of this pod "
                                             "under torchrun")
    ap.add_argument("--timeout", type=float, default=DEFAULT_TIMEOUT_S,
                    help="seconds for the coordinator's address and the rendezvous")
    opts = ap.parse_args(own)
    deadline = time.monotonic() + opts.timeout
    env = os.environ
    rank, world, k = int(env.get("RANK", "0")), int(env.get("WORLD_SIZE", "1")), cards_in_pod()
    name = env.get("MASTER_ADDR", "")
    if name:
        port = env.get("MASTER_PORT", "")
        try:
            address, how = coordinator_address(name, deadline)
        except RuntimeError as e:
            print(f"launch: rank {rank} of world {world}: {e}", file=sys.stderr, flush=True)
            sys.exit(1)
    elif world == 1:
        name, address, port, how = "this pod", "127.0.0.1", str(_free_port()), "this pod alone"
    else:
        print(f"launch: rank {rank} of world {world} has no MASTER_ADDR: the device plugin "
              f"injects it from the Job controller's annotations (an Indexed Job)",
              file=sys.stderr, flush=True)
        sys.exit(1)
    print(f"launch: rank {rank} world {world} k {k} coordinator {name} port {port} "
          f"address {address} ({how})", flush=True)
    left = max(1, math.floor(deadline - time.monotonic() - TORCHRUN_START_S))
    cmd = [sys.executable, "-m", "torch.distributed.run", f"--nnodes={world}",
           f"--node-rank={rank}", f"--nproc-per-node={k}", f"--master-addr={address}",
           f"--master-port={port}", f"--rdzv-conf=timeout={left}", "-m", module, *args]
    os.execv(cmd[0], cmd)


if __name__ == "__main__":
    main()
