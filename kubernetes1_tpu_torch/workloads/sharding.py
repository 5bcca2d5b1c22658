"""Device placement, data parallelism and parameter sharding for the
workloads.

The JAX package picks a mesh over every visible chip (``make_mesh``,
``auto_mesh``), places every leaf of Llama and BERT by a
``PartitionSpec`` (their ``param_specs``) and lets XLA insert the
collectives.  The port runs one process per card over
``torch.distributed`` and writes the collectives out:

- ``make_mesh`` / ``auto_mesh`` build a ``DeviceMesh`` with JAX's dims
  ``("dp", "fsdp", "tp")`` over the ranks of the process group, rank r at
  the coordinate of JAX's device r (``arange(n).reshape(dp, fsdp, tp)``);
- ``data_group`` is the group of the data ranks (dp x fsdp) that share
  this rank's tp coordinate, over which the batch is split
  (``shard_batch``: every tp rank of a data rank takes the same rows);
- ``shard_params`` keeps this rank's block of every leaf, as
  ``NamedSharding`` places it, and ``gather_params`` reassembles the
  whole tree (tests, checkpoints);
- ``Layout`` is what a model's step calls on its local blocks: the fsdp
  gather (all-gather forward, reduce-scatter backward), the tp "copy"
  (identity forward, all-reduce backward), the tp "reduce" (all-reduce
  forward, identity backward), the tp gather of a column-split activation
  and the vocab-parallel embedding lookup (over fsdp the tokens are
  gathered and the rows reduce-scattered, so the table never moves);
- ``reduce_grads`` finishes each leaf's gradient: an fsdp-sharded leaf's
  was reduced over fsdp by its gather, and goes over dp alone; every
  other leaf's goes over the whole data group.  No leaf's gradient is
  reduced over tp: the tp collectives make it whole on every tp rank;
- ``broadcast_params`` and ``all_reduce_grads`` serve the replicated
  steps (ResNet-50, llama_bench: JAX gives them no param specs).

Over a group of one rank every collective here returns at once, so a
step over a one-rank mesh is the step without a mesh, bit for bit.

The process group comes from the launcher's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``, as
``torchrun`` sets them; ``init_from_env``) or from the caller, who made
it before building the mesh.  NCCL on the card; gloo on the CPU, which a
caller asks for by ``device_type="cpu"``: without it the mesh is the
card's, and raises when no card is visible.

Without a mesh and without a launcher's environment, a workload runs on
one device and makes no process group (``launched_mesh`` returns None).
"""

from __future__ import annotations

import math
import os
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DIMS = ("dp", "fsdp", "tp")
DATA_DIMS = ("dp", "fsdp")
# A leaf's placement: one entry per dim, each None (whole), an axis name or
# a tuple of axis names (the dim split over their product, the first axis
# major), as a JAX PartitionSpec's.
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]
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


def _device_type(device_type: Optional[str]) -> str:
    """The mesh's device type: the card unless the caller names "cpu";
    raises as ``resolve_device`` does when no card is visible."""
    return resolve_device(device_type).type


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
    device_type = _device_type(device_type)
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo")


def make_mesh(dp: int = 1, fsdp: int = 1, tp: int = 1,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A ``DeviceMesh`` of shape (dp, fsdp, tp) over the first dp·fsdp·tp
    ranks of the process group, dims ``("dp", "fsdp", "tp")``, as JAX's
    ``make_mesh`` takes the first devices: rank r sits where JAX puts
    device r.  The card's mesh unless ``device_type="cpu"``.  Raises
    ValueError when the group has fewer ranks."""
    device_type = _device_type(device_type)
    init_from_env(device_type)
    n, world = dp * fsdp * tp, dist.get_world_size()
    if n > world:
        raise ValueError(f"mesh {dp}x{fsdp}x{tp} needs {n} devices, have {world}")
    return DeviceMesh(device_type, torch.arange(n).reshape(dp, fsdp, tp), mesh_dim_names=DIMS)


def auto_mesh(device_type: Optional[str] = None) -> DeviceMesh:
    """JAX's ``auto_mesh``: every rank as fsdp up to a host (8), then dp
    across hosts.  The card's mesh unless ``device_type="cpu"``."""
    device_type = _device_type(device_type)
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
    mesh's one dim) that share this rank's tp coordinate, over which the
    batch is split."""
    names = mesh.mesh_dim_names or ()
    sizes = dict(zip(names, mesh.shape))
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


# ------------------------------------------------------ parameter sharding


def _group(mesh: Optional[DeviceMesh], axis: str) -> Optional[dist.ProcessGroup]:
    """The group along the mesh's dim ``axis`` through this rank; None
    without a mesh or where the mesh has no such dim (one rank along it)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return None
    return mesh.get_group(axis)


def _size(group: Optional[dist.ProcessGroup]) -> int:
    return 1 if group is None else dist.get_world_size(group)


def tp_group(mesh: Optional[DeviceMesh]) -> Optional[dist.ProcessGroup]:
    """The tp ranks that share this rank's dp and fsdp coordinates (None:
    one rank)."""
    return _group(mesh, "tp")


def fsdp_group(mesh: Optional[DeviceMesh]) -> Optional[dist.ProcessGroup]:
    """The fsdp ranks that share this rank's dp and tp coordinates (None:
    one rank)."""
    return _group(mesh, "fsdp")


def data_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """A 1-D ``("dp",)`` mesh over ``mesh``'s data group: the view of a
    step whose parameters are replicated over the data ranks
    (llama_bench, as JAX gives its payload no param specs)."""
    if tuple(mesh.mesh_dim_names or ()) == ("dp",):
        return mesh
    return DeviceMesh.from_group(data_group(mesh), mesh.device_type, mesh_dim_names=("dp",))


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _coords(mesh: Optional[DeviceMesh]) -> Tuple[dict, dict]:
    """(axis -> size, axis -> this rank's coordinate) over DIMS; an axis
    the mesh lacks has size 1."""
    sizes = {a: 1 for a in DIMS}
    coord = {a: 0 for a in DIMS}
    if mesh is not None:
        here = mesh.get_coordinate()
        if here is None:
            raise ValueError("this rank is not in the mesh")
        for name, n, c in zip(mesh.mesh_dim_names or (), mesh.shape, here):
            sizes[name], coord[name] = n, c
    return sizes, coord


def local_shape(shape: Sequence[int], spec: Spec, mesh: Optional[DeviceMesh]) -> Tuple[int, ...]:
    """The shape of this rank's block of a leaf of ``shape`` placed by
    ``spec``.  Raises ValueError where a dim does not divide."""
    sizes, _ = _coords(mesh)
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} for a leaf of shape {tuple(shape)}")
    out = []
    for n, entry in zip(shape, spec):
        parts = math.prod(sizes[a] for a in _axes(entry))
        if n % parts:
            raise ValueError(f"dim {n} of a leaf {tuple(shape)} does not divide over "
                             f"{_axes(entry)} ({parts} ranks)")
        out.append(n // parts)
    return tuple(out)


def shard_tensor(t: torch.Tensor, spec: Spec, mesh: Optional[DeviceMesh]) -> torch.Tensor:
    """This rank's contiguous block of the whole leaf ``t`` at its mesh
    coordinate, as ``NamedSharding(mesh, spec)`` places it (a dim split
    over several axes takes them major first).  ``t`` itself where the
    spec splits nothing on this mesh, else a copy (the whole may then be
    freed).  Raises ValueError where a dim does not divide."""
    sizes, coord = _coords(mesh)
    shape = local_shape(t.shape, spec, mesh)
    if shape == tuple(t.shape):
        return t
    block = t
    for dim, (entry, n) in enumerate(zip(spec, shape)):
        index = 0
        for a in _axes(entry):
            index = index * sizes[a] + coord[a]
        block = block.narrow(dim, index * n, n)
    return block.clone(memory_format=torch.contiguous_format)


def map_tree(fn: Callable, tree, specs):
    """``fn(leaf, spec)`` over a parameter tree (dicts; a list of per-layer
    dicts takes the one per-layer spec dict), as a new tree."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v, specs) for v in tree]
    return fn(tree, specs)


def shard_params(params, specs, mesh: Optional[DeviceMesh]):
    """Every leaf of the whole tree ``params`` cut to this rank's block by
    its spec in ``specs`` (a model's ``param_specs``); a new tree."""
    return map_tree(lambda t, s: shard_tensor(t, s, mesh), params, specs)


def _all_gather(x: torch.Tensor, dim: int, group: dist.ProcessGroup) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim``, in rank order."""
    n = dist.get_world_size(group)
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(x: torch.Tensor, dim: int, group: dist.ProcessGroup) -> torch.Tensor:
    """The sum over the group of ``x``, this rank's block of it along
    ``dim``."""
    n = dist.get_world_size(group)
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim).contiguous()


@torch.no_grad()
def gather_tensor(t: torch.Tensor, spec: Spec, mesh: Optional[DeviceMesh]) -> torch.Tensor:
    """The whole leaf from every rank's block ``t`` (each rank calls it):
    ``shard_tensor``'s inverse."""
    for dim, entry in enumerate(spec):
        for a in reversed(_axes(entry)):  # the minor axis first
            group = _group(mesh, a)
            if _size(group) > 1:
                t = _all_gather(t, dim, group)
    return t


def gather_params(params, specs, mesh: Optional[DeviceMesh]):
    """The whole tree from every rank's blocks (every rank calls it and
    gets the whole tree)."""
    return map_tree(lambda t, s: gather_tensor(t.detach(), s, mesh), params, specs)


def spec_leaves(specs, n_layers: int, leaves: Callable) -> List[Spec]:
    """Each leaf's spec in the order of a model's ``param_leaves``, which
    ``leaves`` is (applied to the spec tree with ``n_layers`` layers)."""
    return leaves({**specs, "layers": [specs["layers"]] * n_layers})


def tree_from_leaves(items, n_layers: int) -> dict:
    """A parameter tree from (path, leaf) pairs: ("name",) or ("layers",
    i, "name")."""
    tree: dict = {"layers": [{} for _ in range(n_layers)]}
    for path, leaf in items:
        if path[0] == "layers":
            tree["layers"][path[1]][path[2]] = leaf
        else:
            tree[path[0]] = leaf
    return tree


def spec_of(specs, path) -> Spec:
    return specs["layers"][path[2]] if path[0] == "layers" else specs[path[0]]


class _FsdpGather(torch.autograd.Function):
    """All-gather of the fsdp blocks along ``dim`` forward; reduce-scatter
    backward, summed or averaged over the group."""

    @staticmethod
    def forward(ctx, w, dim, group, op):
        ctx.dim, ctx.group, ctx.op = dim, group, op
        return _all_gather(w, dim, group)

    @staticmethod
    def backward(ctx, g):
        out = _reduce_scatter(g, ctx.dim, ctx.group)
        if ctx.op == "avg":
            out.div_(dist.get_world_size(ctx.group))
        return out, None, None, None


class _Rows(torch.autograd.Function):
    """``table[index]`` forward; backward, the rows' gradients added in
    f32 and rounded once to the table's dtype (autograd's own backward
    adds them in that dtype: one rounding an add, many for a frequent
    token such as BERT's MASK)."""

    @staticmethod
    def forward(ctx, table, index):
        ctx.save_for_backward(index)
        ctx.shape, ctx.dtype = table.shape, table.dtype
        return table[index]

    @staticmethod
    def backward(ctx, g):
        (index,) = ctx.saved_tensors
        out = g.new_zeros(ctx.shape, dtype=torch.float32)
        out.index_put_((index,), g.float(), accumulate=True)
        return out.to(ctx.dtype), None


def _rows(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``table[index]``; over a table narrower than f32 (a gathered bf16
    copy), through ``_Rows``."""
    return table[index] if table.dtype == torch.float32 else _Rows.apply(table, index)


class _FsdpScatterRows(torch.autograd.Function):
    """The fsdp ranks' partial rows added, each rank keeping its block of
    dim 0, forward (a reduce-scatter); the gradient's blocks gathered,
    backward, and averaged over the group where ``op`` is "avg", as the
    fsdp gather's backward averages."""

    @staticmethod
    def forward(ctx, x, group, op):
        ctx.group, ctx.op = group, op
        return _reduce_scatter(x, 0, group)

    @staticmethod
    def backward(ctx, g):
        out = _all_gather(g, 0, ctx.group)
        if ctx.op == "avg":
            out.div_(dist.get_world_size(ctx.group))
        return out, None, None


class _TpCopy(torch.autograd.Function):
    """Identity forward; the gradient summed over tp backward (each tp rank
    holds part of it: its heads, its columns, its vocab block)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _TpReduce(torch.autograd.Function):
    """The tp ranks' partial sums added, forward; identity backward (the
    rest of the step is the same on every tp rank)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _TpGatherLast(torch.autograd.Function):
    """The tp ranks' column blocks concatenated along the last dim,
    forward; this rank's block of the gradient, backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        return _all_gather(x, x.dim() - 1, group)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g.narrow(-1, r * ctx.width, ctx.width).contiguous(), None


class Layout:
    """What a sharded step calls on this rank's blocks: over a mesh's fsdp
    and tp groups, or (no mesh, or groups of one) the identity, so that the
    model's code is one for both.  ``op`` is how the fsdp gather's backward
    reduces ("avg" where the step averages its gradients over the data
    ranks, "sum" where it sums them)."""

    def __init__(self, mesh: Optional[DeviceMesh] = None, op: str = "avg"):
        if op not in ("sum", "avg"):
            raise ValueError(f"Layout: op 'sum' or 'avg', got {op!r}")
        self.op = op
        self.fsdp_group, self.tp_group = fsdp_group(mesh), tp_group(mesh)
        self.fsdp, self.tp = _size(self.fsdp_group), _size(self.tp_group)
        self.fsdp_rank = dist.get_rank(self.fsdp_group) if self.fsdp > 1 else 0
        self.tp_rank = dist.get_rank(self.tp_group) if self.tp > 1 else 0

    def full(self, w: torch.Tensor, spec: Spec) -> torch.Tensor:
        """This rank's tp block of a leaf: its fsdp blocks gathered along
        the dim whose spec entry holds "fsdp" (there the minor axis).  The
        caller casts the block to the compute dtype first, so that the
        gather and its reduce-scatter move that dtype, as XLA's do."""
        if self.fsdp == 1:
            return w
        for dim, entry in enumerate(spec):
            axes = _axes(entry)
            if "fsdp" in axes:
                if axes[-1] != "fsdp":
                    raise ValueError(f"spec {spec}: fsdp must be the minor axis of its dim")
                return _FsdpGather.apply(w, dim, self.fsdp_group, self.op)
        return w

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.tp == 1 else _TpCopy.apply(x, self.tp_group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.tp == 1 else _TpReduce.apply(x, self.tp_group)

    def gather_last(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.tp == 1 else _TpGatherLast.apply(x, self.tp_group)

    def vocab_start(self, block_rows: int) -> int:
        """The first vocab row of this rank's tp block of ``block_rows`` rows."""
        return self.tp_rank * block_rows

    def lookup(self, table: torch.Tensor, tokens: torch.Tensor, spec: Spec,
               dtype: torch.dtype) -> torch.Tensor:
        """``whole[tokens]`` in ``dtype``, where ``table`` is this rank's
        block of a (vocab, d) table placed by ``spec`` (d whole).  Over the
        axes that split the vocab, each rank picks the rows in its block
        (0 elsewhere) and the ranks' rows are added: each token's row comes
        from exactly one rank, so the sums are exact in ``dtype``.  Over
        fsdp the ranks' tokens differ: the tokens are gathered and the rows
        reduce-scattered back to their ranks, so the table never moves."""
        axes = _axes(spec[0])
        if spec[1] is not None:
            raise ValueError(f"lookup: spec {spec} splits d")
        over_fsdp, over_tp = "fsdp" in axes and self.fsdp > 1, "tp" in axes and self.tp > 1
        if not (over_fsdp or over_tp):
            return _rows(table, tokens).to(dtype)
        if over_fsdp:
            tokens = _all_gather(tokens, 0, self.fsdp_group)
        block = 0
        for a in axes:
            block = block * (self.tp if a == "tp" else self.fsdp) + (
                self.tp_rank if a == "tp" else self.fsdp_rank)
        rows = table.shape[0]
        local = tokens - block * rows
        inside = (local >= 0) & (local < rows)
        picked = torch.where(inside[..., None], _rows(table, local.clamp(0, rows - 1)),
                             0.0).to(dtype)
        if over_fsdp:
            picked = _FsdpScatterRows.apply(picked, self.fsdp_group, self.op)
        return self.reduce(picked) if over_tp else picked


def reduce_grads(leaves: Sequence[torch.Tensor], specs: Sequence[Spec],
                 mesh: Optional[DeviceMesh], op: str = "avg"):
    """Each sharded step's gradients, made the whole batch's in place: a
    leaf split over fsdp (its gather's backward reduced it there) over
    the dp ranks, every other leaf over the whole data group (a leaf
    without a gradient gets zeros first).  Nothing goes over tp."""
    if mesh is None:
        return
    over_fsdp = [any("fsdp" in _axes(e) for e in s) for s in specs]
    for group, pick in ((_group(mesh, "dp"), True), (data_group(mesh), False)):
        ps = [p for p, f in zip(leaves, over_fsdp) if f == pick]
        if _size(group) == 1 or not ps:
            continue
        for p in ps:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        all_reduce_([p.grad for p in ps], group, op)


def whole_shapes(leaf_shapes, n_layers: int, leaves: Callable) -> list:
    """(path, whole shape) of each leaf in the order of a model's
    ``param_leaves`` (``leaves``), from its ``leaf_shapes``."""
    return leaves(tree_from_leaves(((path, (path, shape)) for path, shape, _ in leaf_shapes),
                                   n_layers))


def check_blocks(leaves: Sequence[torch.Tensor], shapes: Sequence, specs: Sequence[Spec],
                 mesh: Optional[DeviceMesh], who: str):
    """Raise ValueError unless each leaf has the shape of this rank's block
    of its whole leaf (``shapes``: ``whole_shapes``).  A sharded step
    takes the blocks ``make_train_state(mesh=)`` keeps: given whole
    weights over tp, every rank would run every head and the ranks' sums
    would be added, a wrong result and no error."""
    for p, (path, shape), spec in zip(leaves, shapes, specs):
        want = local_shape(shape, spec, mesh)
        if tuple(p.shape) != want:
            raise ValueError(
                f"{who}: leaf {'/'.join(map(str, path))} is {tuple(p.shape)}, but this rank's "
                f"block of {tuple(shape)} placed by {spec} is {want}: make the parameters with "
                f"make_train_state(mesh=)")


def spec_numel(shapes: Sequence[Sequence[int]], specs: Sequence[Spec],
               mesh: Optional[DeviceMesh]) -> int:
    """The elements one rank holds of whole leaves of ``shapes`` placed by
    ``specs``."""
    return sum(math.prod(local_shape(s, sp, mesh)) for s, sp in zip(shapes, specs))
