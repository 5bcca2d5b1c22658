"""Device placement and data parallelism for the workloads.

The JAX package picks a mesh over every visible chip (``make_mesh``,
``auto_mesh``) and lets XLA split the batch over its ``(dp, fsdp)`` axes.
The port runs one process per card over ``torch.distributed``:

- ``make_mesh`` / ``auto_mesh`` build a ``DeviceMesh`` with JAX's dims
  ``("dp", "fsdp", "tp")`` over the ranks of the process group;
- ``data_group`` is the group of the data ranks (dp x fsdp), over which
  the batch is split (``shard_batch``), the gradients are all-reduced
  (``all_reduce_grads``) and batch norm takes its statistics;
- ``broadcast_params`` starts every replica from rank 0's weights.

Over one data rank (a launcher's world of 1, or a mesh of one) the train
steps issue no collective: ``broadcast_params``, ``all_reduce_grads`` and
``all_reduce_value`` return at once, and batch norm keeps its one-launch
kernels (``resnet.ops_over``), so such a step is the step without a mesh.

The process group comes from the launcher's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``, as
``torchrun`` sets them; ``init_from_env``) or from the caller, who made
it before building the mesh.  NCCL on the card, gloo on the CPU.

In this version the fsdp axis, like dp, replicates the parameters: every
data rank holds all of them and takes its share of the batch.  That is
JAX's step in value (its fsdp axis also shards the parameters, which
changes where they live, not what a step computes), with more memory.
tp > 1 is not supported yet.

Without a mesh and without a launcher's environment, a workload runs on
one device and makes no process group (``launched_mesh`` returns None).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DIMS = ("dp", "fsdp", "tp")
DATA_DIMS = ("dp", "fsdp")
# Gradients go through the all-reduce in flat buckets of at most this many
# bytes: one flat copy of every gradient would add 7.7 GB at Llama's 1.923 B
# f32 parameters (8B widths, 4 layers).
BUCKET_BYTES = 256 << 20


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device a workload runs on: ``cuda`` when none is named.

    Raises when the named (or default) device is a CUDA device and no
    card is visible: nothing falls back to the CPU silently; a caller
    that wants the CPU passes ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run on the CPU")
    return dev


def _default_device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def launcher_env() -> bool:
    """Whether a launcher (``torchrun``) set this process's rank and world."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_from_env(device_type: Optional[str] = None):
    """Make the default process group from the launcher's environment,
    unless one exists: NCCL on the card (after ``torch.cuda.set_device(
    LOCAL_RANK)``: a kernel launches only on the current card), gloo on
    the CPU.  Raises when there is neither a group nor that environment."""
    if dist.is_initialized():
        return
    if not launcher_env():
        raise RuntimeError("no process group: launch one process per card with "
                           "`torchrun --nproc-per-node=N`, or call "
                           "torch.distributed.init_process_group before making the mesh")
    device_type = device_type or _default_device_type()
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo")


def make_mesh(dp: int = 1, fsdp: int = 1, tp: int = 1,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A ``DeviceMesh`` of shape (dp, fsdp, tp) over the first dp·fsdp·tp
    ranks of the process group, dims ``("dp", "fsdp", "tp")``, as JAX's
    ``make_mesh`` takes the first devices.  Raises ValueError when the
    group has fewer ranks, NotImplementedError for tp > 1."""
    device_type = device_type or _default_device_type()
    init_from_env(device_type)
    n, world = dp * fsdp * tp, dist.get_world_size()
    if n > world:
        raise ValueError(f"mesh {dp}x{fsdp}x{tp} needs {n} devices, have {world}")
    if tp > 1:
        raise NotImplementedError("tensor parallelism (tp > 1) is not supported yet")
    return DeviceMesh(device_type, torch.arange(n).reshape(dp, fsdp, tp), mesh_dim_names=DIMS)


def auto_mesh(device_type: Optional[str] = None) -> DeviceMesh:
    """JAX's ``auto_mesh``: every rank as fsdp up to a host (8), then dp
    across hosts."""
    device_type = device_type or _default_device_type()
    init_from_env(device_type)
    n = dist.get_world_size()
    fsdp = min(n, 8)
    return make_mesh(dp=n // fsdp, fsdp=fsdp, tp=1, device_type=device_type)


def launched_mesh(device: torch.device) -> Optional[DeviceMesh]:
    """The mesh a workload entry point uses when its caller gave none:
    ``auto_mesh()`` when a launcher set the environment or a process
    group exists, else None (one device, no process group).  Then, where
    more than one card is visible, it says so on one line: it does not
    start processes behind the caller's back."""
    if launcher_env() or dist.is_initialized():
        return auto_mesh(device.type)
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        n = torch.cuda.device_count()
        seen = ", ".join(f"cuda:{i} {torch.cuda.get_device_name(i)}" for i in range(n))
        print(f"{n} cards visible ({seen}); using cuda:{torch.cuda.current_device()} alone. "
              f"To train on all of them, start one process per card: "
              f"torchrun --nproc-per-node={n} -m <module> ...", flush=True)
    return None


def end_process_group():
    """Destroy the default process group, where one exists: an entry
    point's last act, after its last collective."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_rank0() -> bool:
    """Whether this process prints a payload's result: rank 0 of the
    process group; without one, rank 0 of the launcher's environment or
    the only process."""
    if dist.is_initialized():
        return dist.get_rank() == 0
    return int(os.environ.get("RANK", "0")) == 0


def data_group(mesh: DeviceMesh) -> dist.ProcessGroup:
    """The group of the mesh's data ranks (its dp and fsdp dims; a 1-D
    mesh's one dim), over which the batch is split."""
    names = mesh.mesh_dim_names or ()
    sizes = dict(zip(names, mesh.shape))
    if sizes.get("tp", 1) > 1:
        raise NotImplementedError("tensor parallelism (tp > 1) is not supported yet")
    data = tuple(d for d in names if d in DATA_DIMS)
    if not data or any(d not in DIMS for d in names):
        raise ValueError(f"mesh dims {names}: want data dims among {DATA_DIMS}, and tp")
    split = [d for d in data if sizes[d] > 1]
    if len(split) <= 1:
        return mesh.get_group(split[0] if split else data[0])
    return mesh[data]._flatten().get_group()


def data_ranks(mesh: Optional[DeviceMesh]) -> int:
    """How many data ranks share the batch: 1 without a mesh."""
    return 1 if mesh is None else dist.get_world_size(data_group(mesh))


def shard_batch(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's contiguous rows of the global batch ``x`` (dim 0), as
    JAX's ``P(("dp", "fsdp"))`` places them: data rank r of n takes rows
    [r·B/n, (r+1)·B/n).  Raises unless n divides B."""
    group = data_group(mesh)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if r < 0:
        raise ValueError("shard_batch: this rank is not in the mesh")
    if x.shape[0] % n:
        raise ValueError(f"shard_batch: batch {x.shape[0]} does not divide over {n} data ranks")
    b = x.shape[0] // n
    return x[r * b:(r + 1) * b]


@torch.no_grad()
def broadcast_params(leaves: Sequence[torch.Tensor], mesh: DeviceMesh):
    """Every data rank's parameters become those of the group's first
    rank.  The collective writes into the storage without moving the
    tensors' version counters: call it before an optimizer is built over
    them, or call the optimizer's ``forget_params()`` after it."""
    group = data_group(mesh)
    if dist.get_world_size(group) == 1:
        return
    src = dist.get_global_rank(group, 0)
    for p in leaves:
        dist.broadcast(p.detach(), src=src, group=group)


def _buckets(tensors: Sequence[torch.Tensor], limit: int) -> List[List[torch.Tensor]]:
    """Consecutive runs of one dtype and device, each at most ``limit``
    bytes (a larger tensor alone)."""
    out: List[List[torch.Tensor]] = []
    size = 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if (not out or size + nbytes > limit or out[-1][0].dtype != t.dtype
                or out[-1][0].device != t.device):
            out.append([])
            size = 0
        out[-1].append(t)
        size += nbytes
    return out


@torch.no_grad()
def all_reduce_(tensors: Sequence[torch.Tensor], group: dist.ProcessGroup, op: str = "avg"):
    """Sum (``op="sum"``) or average (``"avg"``: the sum, then divided by
    the group's size) each tensor over ``group``, in place, in flat buckets
    of at most BUCKET_BYTES (a larger tensor goes alone, without a copy).
    Every rank gets the same bits."""
    if op not in ("sum", "avg"):
        raise ValueError(f"all_reduce_: op 'sum' or 'avg', got {op!r}")
    n = dist.get_world_size(group)
    for bucket in _buckets(list(tensors), BUCKET_BYTES):
        flat = bucket[0] if len(bucket) == 1 else torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        if op == "avg" and n > 1:
            flat.div_(n)
        if len(bucket) > 1:
            for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
                t.copy_(part.view_as(t))


def all_reduce_grads(leaves: Sequence[torch.Tensor], mesh: DeviceMesh, op: str = "avg"):
    """Each leaf's ``.grad``, summed or averaged over the mesh's data ranks
    in place (a leaf without one gets zeros, which another rank's may
    not be).  Over one data rank, nothing: its sum and its average are
    its own gradients."""
    group = data_group(mesh)
    if dist.get_world_size(group) == 1:
        return
    for p in leaves:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    all_reduce_([p.grad for p in leaves], group, op)


def all_reduce_value(x: torch.Tensor, mesh: DeviceMesh, op: str = "avg") -> torch.Tensor:
    """A reduced copy of ``x`` (a loss, a count) over the data ranks (no
    collective over one)."""
    out = x.detach().clone()
    group = data_group(mesh)
    if dist.get_world_size(group) > 1:
        all_reduce_([out], group, op)
    return out
