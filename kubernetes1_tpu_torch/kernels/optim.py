"""K10 AdamW, K10b Adafactor and K10c SGD with momentum: the hand-written
multi-tensor CUDA kernels and their plain PyTorch versions.

Replaces the optimizer updates that XLA fuses into the JAX package's
jitted steps: ``optax.adamw`` (``workloads/llama.py:210``,
``bert.py:171``, ``llama_bench.py:72``), ``optax.adafactor``
(``llama_bench.py:74``) and ``optax.sgd(lr, momentum=0.9)``
(``resnet.py:143``, ``resnet_bench.py:51``, ``llama_bench.py:76``).  The
kernels are in ``csrc/optim.cu``; one call updates every leaf.

A ``LeafTable`` holds the leaves of one optimizer: each parameter with its
state tensors, and the gradients of the step.  On the card it also holds
the device-side table the kernels read (built once; the gradient column
is refreshed by ``set_grads`` with one host-to-device copy) and, for
Adafactor, the scratch of its reductions.  Each update function takes
the table, the step count (a 0-dim int32 tensor, optax's ``count``,
incremented by the update) and the hyperparameters, and updates the
parameters and states in place; the plain version is optax's formula in
f32, op by op.

The device table keeps the addresses it was built with, so every update
first checks that each parameter and state still lives there and
raises, naming the leaf, when one moved (``p.data = ...``).  Every
kernel update moves the parameters' version counters, as torch's own
in-place writes do.  Adafactor's kernel carries each block's sum of p²
from one update to the next (``csrc/optim.cu``); the table tells it
when it must read p instead, from those counters.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import build

# csrc/optim.cu's grid: a flat block's elements, an Adafactor tile's rows
# and columns, the statistics of one of its finalize blocks.
CHUNK = 32768
ROWS = 32
COLS = 1024
FIN = 1024
# Adafactor's factoring of a leaf (csrc/optim.cu's kFlat, kFactoredCols,
# kFactoredRows): none, or optax's d0 (the axis v_row averages over) the
# leaf's columns or its rows.
FLAT, FACTORED_COLS, FACTORED_ROWS = 0, 1, 2
# optax.adafactor's defaults, the only values the JAX package uses: factor
# from two dims of 128, decay 1 - t^-0.8, eps 1e-30 on g^2, clip to block
# RMS 1, parameter scale at least 1e-3.
MIN_DIM_SIZE_TO_FACTOR = 128
DECAY_RATE = 0.8
EPS = 1e-30
CLIPPING_THRESHOLD = 1.0
MIN_SCALE = 1e-3
# csrc/optim.cu's struct Leaf
LEAF_DTYPE = np.dtype([("p", "<u8"), ("s0", "<u8"), ("s1", "<u8"), ("n", "<i8"),
                       ("rows", "<i8"), ("block0", "<i8"), ("fblock0", "<i8"),
                       ("part", "<i8"), ("group", "<i4"), ("mode", "<i4")])
assert LEAF_DTYPE.itemsize == 72

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
KERNEL_ADAMW = build.Kernel("optim", "ktpu_adamw_f32", [
    _P, _P, _I, _LL,        # leaves, grads, n_leaves, nblocks
    _P,                     # count
    _F, _F, _F, _F, _F,     # lr, b1, b2, 1 - b1, 1 - b2
    _F, _F,                 # eps, weight decay
    _P,                     # stream
])
KERNEL_ADAFACTOR = build.Kernel("optim", "ktpu_adafactor_f32", [
    _P, _P, _I, _LL, _LL,   # leaves, grads, n_leaves, nblocks, n_fblocks
    _P, _I,                 # groups, n_groups
    _P, _P, _P, _P, _P,     # fpart, vpart, ppart, upart, gstat
    _P, _I,                 # count, read_p
    _F, _F, _F, _F, _F,     # lr, decay_rate, eps, clipping threshold, min_scale
    _P,                     # stream
])
KERNEL_SGDM = build.Kernel("optim", "ktpu_sgdm_f32", [
    _P, _P, _I, _LL,        # leaves, grads, n_leaves, nblocks
    _F, _F,                 # lr, momentum
    _P,                     # stream
])


def factored_dims(shape: Sequence[int]) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: (d1, d0), the second-largest and the
    largest axis of ``shape`` by ``np.argsort`` (which breaks ties), or
    None when the second-largest is below MIN_DIM_SIZE_TO_FACTOR."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


@dataclasses.dataclass
class Leaf:
    """One parameter and its state: AdamW (m, v); SGD (trace,);
    Adafactor (v,) or, factored, (v_row, v_col), with its group (the JAX
    leaf it belongs to) and its mode (FACTORED_COLS / FACTORED_ROWS: the
    parameter is a (rows, cols) matrix whose v_row averages over the
    columns / the rows).  ``name`` says which it is in error messages."""

    p: torch.Tensor
    states: Tuple[torch.Tensor, ...]
    group: int = 0
    mode: int = FLAT
    name: str = ""


def _blocks(leaf: Leaf) -> Tuple[int, int, int]:
    """(blocks in the A/B/C and flat grids, blocks in Adafactor's FA grid,
    floats of tile sums) of one leaf."""
    n = leaf.p.numel()
    if leaf.mode == FLAT:
        return math.ceil(n / CHUNK), 0, 0
    R, C = leaf.p.shape
    bands, chunks = math.ceil(R / ROWS), math.ceil(C / COLS)
    return bands * chunks, math.ceil((R + C) / FIN), bands * C + chunks * R


def table_records(leaves: Sequence[Leaf], n_groups: int):
    """The kernels' view of the leaves: (the LEAF_DTYPE records, the
    (n_groups, 3) int64 (first block, end block, elements) of each group,
    the blocks of the A/B/C and flat grids, the blocks of Adafactor's FA
    grid, the floats of its tile sums)."""
    rec = np.zeros(len(leaves), LEAF_DTYPE)
    groups = np.zeros((n_groups, 3), np.int64)
    block = fblock = part = 0
    for i, leaf in enumerate(leaves):
        nb, nfb, npart = _blocks(leaf)
        s0 = leaf.states[0].data_ptr() if leaf.states else 0
        s1 = leaf.states[1].data_ptr() if len(leaf.states) > 1 else 0
        rec[i] = (leaf.p.data_ptr(), s0, s1, leaf.p.numel(),
                  leaf.p.shape[0] if leaf.mode != FLAT else 0, block, fblock, part,
                  leaf.group, leaf.mode)
        if groups[leaf.group, 2] == 0:
            groups[leaf.group, 0] = block
        block, fblock, part = block + nb, fblock + nfb, part + npart
        groups[leaf.group, 1] = block
        groups[leaf.group, 2] += leaf.p.numel()
    return rec, groups, block, fblock, part


class LeafTable:
    """The leaves an update reads and writes, in order, and the step's
    gradients.  For Adafactor the leaves come group by group (each JAX
    leaf's tensors together, groups numbered from 0 in order).

    Every tensor is f32, contiguous, and on one device.  On a card the
    table also holds the kernels' device-side table, a pinned host copy of
    the gradient column and, for an ``adafactor`` table, the scratch of its
    reductions."""

    def __init__(self, leaves: Sequence[Leaf], adafactor: bool = False):
        self.leaves: List[Leaf] = list(leaves)
        if not self.leaves:
            raise ValueError("LeafTable: no leaves")
        self.device = self.leaves[0].p.device
        groups = [leaf.group for leaf in self.leaves]
        if groups[0] != 0 or any(b - a not in (0, 1) for a, b in zip(groups, groups[1:])):
            raise ValueError(f"LeafTable: leaves must come group by group from 0, got {groups}")
        self.n_groups = groups[-1] + 1
        for i, leaf in enumerate(self.leaves):
            for t in (leaf.p, *leaf.states):
                _check_tensor(f"leaf {i}", t, self.device)
            if leaf.p.numel() == 0:
                raise ValueError(f"LeafTable: leaf {i} is empty")
            if leaf.mode != FLAT and (leaf.p.dim() != 2 or len(leaf.states) != 2):
                raise ValueError(f"LeafTable: factored leaf {i} must be a matrix with "
                                 f"(v_row, v_col), got {tuple(leaf.p.shape)}")
        self.grads: List[Optional[torch.Tensor]] = [None] * len(self.leaves)
        self._ptrs = self._addresses()
        self._versions: Optional[List[int]] = None
        if self.device.type == "cuda":
            self._build_device_table(adafactor)

    def label(self, i: int) -> str:
        name = self.leaves[i].name
        return f"leaf {i}" + (f" ({name})" if name else "")

    def _addresses(self) -> List[Tuple[int, ...]]:
        return [(leaf.p.data_ptr(), *(s.data_ptr() for s in leaf.states))
                for leaf in self.leaves]

    def check_addresses(self):
        """Raise, naming the leaf, when a parameter or state tensor no
        longer lives where the table was built (``p.data = other``): the
        kernels would write through the old address."""
        for i, (now, then) in enumerate(zip(self._addresses(), self._ptrs)):
            if now != then:
                raise ValueError(f"optimizer table: {self.label(i)} moved to new storage "
                                 f"since the optimizer was built; build a new optimizer")

    def must_read_params(self) -> bool:
        """Whether an update has to read the parameters: at the first
        update, after ``forget_params``, and when anything wrote one since
        ``mark_params``.  Every torch in-place write moves a tensor's
        version counter (``copy_``, ``mul_``, a write through a view, which
        shares it), and so does every table kernel's update, through
        ``mark_params``.  A write that moves no counter goes unseen: one
        through ``p.data`` (a counter of its own), or a raw-pointer write
        by code outside this module that does not call
        ``torch.autograd.graph.increment_version``."""
        return self._versions is None or any(
            leaf.p._version != v for leaf, v in zip(self.leaves, self._versions))

    def forget_params(self):
        """Have the next update read the parameters, as the first does."""
        self._versions = None

    def mark_params(self):
        """After an update that wrote every parameter through raw pointers:
        move each parameter's version counter, as a torch in-place write
        would, so that autograd's check of saved tensors and any other
        table over the same parameters see the write; then record the new
        versions."""
        torch.autograd.graph.increment_version([leaf.p for leaf in self.leaves])
        self._versions = [leaf.p._version for leaf in self.leaves]

    def members(self) -> List[List[int]]:
        """The leaf indices of each group, in order."""
        out: List[List[int]] = [[] for _ in range(self.n_groups)]
        for i, leaf in enumerate(self.leaves):
            out[leaf.group].append(i)
        return out

    def _build_device_table(self, adafactor: bool):
        dev = self.device
        rec, groups, self.nblocks, self.n_fblocks, part = table_records(self.leaves,
                                                                        self.n_groups)
        self.table = torch.from_numpy(rec.view(np.uint8).copy()).to(dev)
        self.groups = torch.from_numpy(groups).to(dev)
        self.grad_ptrs = torch.zeros(len(self.leaves), dtype=torch.int64, device=dev)
        self._host_ptrs = torch.zeros(len(self.leaves), dtype=torch.int64).pin_memory()
        self._copied = torch.cuda.Event()
        self._last_ptrs: Optional[List[int]] = None
        if adafactor:
            f32 = dict(device=dev, dtype=torch.float32)
            self.fpart = torch.empty(max(part, 1), **f32)
            self.vpart = torch.empty(max(self.n_fblocks, 1), **f32)
            self.ppart = torch.empty(self.nblocks, **f32)
            self.upart = torch.empty(self.nblocks, **f32)
            self.gstat = torch.empty(2 * self.n_groups, **f32)

    def set_grads(self, grads: Sequence[Optional[torch.Tensor]]):
        """This step's gradients, one per leaf.  Raises when one is
        missing, not f32, not contiguous, not the parameter's shape or on
        another device; on a card, when that card is not the current
        device.  On a card, a changed gradient column is copied to the
        device table in one host-to-device copy."""
        grads = list(grads)
        if len(grads) != len(self.leaves):
            raise ValueError(f"set_grads: {len(grads)} gradients for {len(self.leaves)} leaves")
        for i, (leaf, g) in enumerate(zip(self.leaves, grads)):
            if g is None:
                raise ValueError(f"set_grads: leaf {i} has no gradient")
            _check_tensor(f"gradient {i}", g, self.device)
            if g.shape != leaf.p.shape:
                raise ValueError(f"set_grads: gradient {i} {tuple(g.shape)} for a "
                                 f"{tuple(leaf.p.shape)} parameter")
        if self.device.type == "cuda":
            if self.device.index != torch.cuda.current_device():
                raise ValueError(f"set_grads: leaves on {self.device}, but the current device "
                                 f"is cuda:{torch.cuda.current_device()}")
            ptrs = [g.data_ptr() for g in grads]
            if ptrs != self._last_ptrs:
                self._copied.synchronize()  # the last copy has left the pinned buffer
                self._host_ptrs.numpy()[:] = ptrs
                self.grad_ptrs.copy_(self._host_ptrs, non_blocking=True)
                self._copied.record()
                self._last_ptrs = ptrs
        self.grads = grads


def _check_tensor(what: str, t: torch.Tensor, device: torch.device):
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, the table's leaves on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{what}: f32 required, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: contiguous tensor required")
    if t.device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{what}: 16-byte aligned tensor required")


def _check_count(count: torch.Tensor, table: LeafTable):
    if count.dtype != torch.int32 or count.numel() != 1 or count.device != table.device:
        raise ValueError(f"count: one int32 on {table.device} required, got {count.dtype} "
                         f"{tuple(count.shape)} on {count.device}")


def _ready(table: LeafTable):
    """Raise before an update that has no gradients or whose leaves moved."""
    if any(g is None for g in table.grads):
        raise ValueError("update before set_grads")
    table.check_addresses()


# --------------------------------------------------------------- K10 AdamW


@torch.no_grad()
def adamw_plain(table: LeafTable, count: torch.Tensor, lr: float, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 1e-4):
    """optax.adamw: scale_by_adam, add_decayed_weights, scale(-lr),
    apply_updates; every leaf decayed.  Leaf states (m, v)."""
    _ready(table)
    t = (count + 1).float()
    bc1, bc2 = 1 - torch.pow(b1, t), 1 - torch.pow(b2, t)
    for leaf, g in zip(table.leaves, table.grads):
        m, v = leaf.states
        m.copy_((1 - b1) * g + b1 * m)
        v.copy_((1 - b2) * (g * g) + b2 * v)
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * leaf.p
        leaf.p.copy_(leaf.p + u * -lr)
    count += 1


def adamw_kernel(table: LeafTable, count: torch.Tensor, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 1e-4):
    """One call of the AdamW entry point over every leaf (the update, then
    the count)."""
    KERNEL_ADAMW.load()
    _ready(table)
    _check_count(count, table)
    KERNEL_ADAMW.launch(table.device, table.table.data_ptr(), table.grad_ptrs.data_ptr(),
                        len(table.leaves), table.nblocks, count.data_ptr(), lr, b1, b2,
                        1 - b1, 1 - b2, eps, weight_decay)
    table.mark_params()


def adamw(table: LeafTable, count: torch.Tensor, lr: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4):
    """One AdamW step over the table, in place.  Leaves on the CPU take
    the plain version; on a card the kernel runs or this raises."""
    if table.device.type == "cpu":
        return adamw_plain(table, count, lr, b1, b2, eps, weight_decay)
    return adamw_kernel(table, count, lr, b1, b2, eps, weight_decay)


# ------------------------------------------------------ K10c SGD momentum


@torch.no_grad()
def sgdm_plain(table: LeafTable, lr: float, momentum: float = 0.9):
    """optax.sgd(lr, momentum): trace t = g + momentum t, scale(-lr),
    apply_updates.  Leaf states (trace,)."""
    _ready(table)
    for leaf, g in zip(table.leaves, table.grads):
        (trace,) = leaf.states
        trace.copy_(g + momentum * trace)
        leaf.p.copy_(leaf.p + trace * -lr)


def sgdm_kernel(table: LeafTable, lr: float, momentum: float = 0.9):
    """One launch of the SGD-momentum kernel over every leaf."""
    KERNEL_SGDM.load()
    _ready(table)
    KERNEL_SGDM.launch(table.device, table.table.data_ptr(), table.grad_ptrs.data_ptr(),
                       len(table.leaves), table.nblocks, lr, momentum)
    table.mark_params()


def sgdm(table: LeafTable, lr: float, momentum: float = 0.9):
    """One SGD-momentum step over the table, in place (the plain version
    for CPU leaves, the kernel on a card)."""
    if table.device.type == "cpu":
        return sgdm_plain(table, lr, momentum)
    return sgdm_kernel(table, lr, momentum)


# ------------------------------------------------------- K10b Adafactor


@torch.no_grad()
def adafactor_plain(table: LeafTable, count: torch.Tensor, lr: float):
    """optax.adafactor(lr) with its defaults: scale_by_factored_rms,
    clip_by_block_rms, scale(lr), scale_by_param_block_rms, scale(-1),
    apply_updates.  Each group is one JAX leaf: its tensors are stacked on
    a leading axis (a group of one tensor is that tensor), and optax's
    formula runs on the stacked array, as the JAX step runs it; the
    results are written back leaf by leaf."""
    _ready(table)
    t = (count + 1).float()
    decay = 1.0 - t ** -DECAY_RATE
    for idx in table.members():
        leaves = [table.leaves[i] for i in idx]

        def stacked(ts):
            return ts[0] if len(ts) == 1 else torch.stack(ts)

        def unstacked(x):
            return [x] if len(leaves) == 1 else list(x.unbind(0))

        p = stacked([leaf.p for leaf in leaves])
        g = stacked([table.grads[i] for i in idx])
        dims = factored_dims(p.shape)
        if dims is not None:
            d1, d0 = dims
            g2 = g * g + EPS
            v_row = decay * stacked([leaf.states[0] for leaf in leaves]) \
                + (1.0 - decay) * g2.mean(dim=d0)
            v_col = decay * stacked([leaf.states[1] for leaf in leaves]) \
                + (1.0 - decay) * g2.mean(dim=d1)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = v_row.mean(dim=reduced_d1, keepdim=True)
            row_factor = (v_row / row_col_mean) ** -0.5
            col_factor = v_col ** -0.5
            u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            new_states = (v_row, v_col)
        else:
            v = decay * stacked([leaf.states[0] for leaf in leaves]) \
                + (1.0 - decay) * (g * g + EPS)
            u = g * v ** -0.5
            new_states = (v,)
        u = u / torch.clamp_min(torch.sqrt(torch.mean(u * u)) / CLIPPING_THRESHOLD, 1.0)
        u = u * lr
        rms = torch.sqrt(torch.mean(p * p))
        u = u * torch.where(rms <= MIN_SCALE, torch.full_like(rms, MIN_SCALE), rms)
        u = u * -1
        p = p + u
        for leaf, p_k, *states_k in zip(leaves, unstacked(p), *map(unstacked, new_states)):
            leaf.p.copy_(p_k)
            for s, new in zip(leaf.states, states_k):
                s.copy_(new)
    count += 1


def adafactor_kernel(table: LeafTable, count: torch.Tensor, lr: float):
    """One call of the Adafactor entry point over every leaf: its five
    launches (tile sums, statistics, update sums, group scales, update).
    The sums of p² come from the last update unless the table says that
    p must be read."""
    KERNEL_ADAFACTOR.load()
    _ready(table)
    _check_count(count, table)
    KERNEL_ADAFACTOR.launch(
        table.device, table.table.data_ptr(), table.grad_ptrs.data_ptr(), len(table.leaves),
        table.nblocks, table.n_fblocks, table.groups.data_ptr(), table.n_groups,
        table.fpart.data_ptr(), table.vpart.data_ptr(), table.ppart.data_ptr(),
        table.upart.data_ptr(), table.gstat.data_ptr(), count.data_ptr(),
        int(table.must_read_params()), lr, DECAY_RATE, EPS, CLIPPING_THRESHOLD, MIN_SCALE)
    table.mark_params()


def adafactor(table: LeafTable, count: torch.Tensor, lr: float):
    """One Adafactor step over the table, in place (the plain version for
    CPU leaves, the kernel on a card)."""
    if table.device.type == "cpu":
        return adafactor_plain(table, count, lr)
    return adafactor_kernel(table, count, lr)
