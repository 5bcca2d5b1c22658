"""K8 batch norm: the hand-written CUDA kernels (statistics, apply and
backward) and their plain PyTorch versions.

Replaces the XLA-fused ``_bn`` of the JAX package's ``workloads/resnet.py``
together with the ReLU and the residual add around it: training-mode batch
statistics in f32 (E[x], E[x²]), folded into a per-channel bf16 multiply
and add.  The kernels are in ``csrc/batchnorm.cu``.  Every function takes
the NHWC activation as an (M, C) matrix, M = N·H·W; ``scale`` and ``bias``
are the f32 (C,) parameters.  ``stats`` is the (4, C) f32 tensor of
(mean, rsqrt(var + eps), inv, gate) that the backward reads, where
inv = rsqrt(var + eps)·scale and gate is the VJP of JAX's
``maximum(mean2 − mean², 0)``: 1 above 0, ½ at a tie, 0 where clamped.
Where the layer has a ReLU, the apply also gives the (M, C/8) uint8 mask
of y > 0 (bit k of byte (row, g) is channel 8g + k), which the backward
reads in place of y.

Across ranks (``group``: each rank holds M rows of a global batch, every
rank the same M), the statistics are the global batch's, as JAX's are
under its batch split: the split form sums this rank's rows
(``bn_sums``), all-reduces the (2, C) sums, and applies them
(``bn_fold_apply``: one launch that folds them over M·n rows in each
block's prologue and gives y, the mask, w, b and stats); the backward
sums dy' and dy'·x (``bn_bwd_sums``, which
also gives this rank's dscale and dbias: the train step averages those
with every other gradient), all-reduces them and computes dx from the
global sums (``bn_bwd_dx``).  With one rank it gives the one-launch
path's bits.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from . import build

EPS = 1e-5  # resnet.py's _bn

KERNEL_STATS = build.Kernel("batchnorm", "ktpu_bn_stats_bf16", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, scale, bias
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # w, b, stats
    ctypes.c_void_p, ctypes.c_void_p,                   # partial, sync
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int,      # M, C, P
    ctypes.c_float,                                     # eps
    ctypes.c_void_p,                                    # stream
])
KERNEL_APPLY = build.Kernel("batchnorm", "ktpu_bn_apply_bf16", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, w, b
    ctypes.c_void_p, ctypes.c_void_p,                   # r (or null), y
    ctypes.c_void_p,                                    # mask (or null: no ReLU)
    ctypes.c_longlong, ctypes.c_int,                    # M, C
    ctypes.c_void_p,                                    # stream
])
KERNEL_BWD = build.Kernel("batchnorm", "ktpu_bn_bwd_bf16", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, mask (or null), dy
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # w, scale, stats
    ctypes.c_void_p, ctypes.c_void_p,                   # dx, dr (or null)
    ctypes.c_void_p, ctypes.c_void_p,                   # dscale, dbias
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # partial, coef, sync
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int,      # M, C, P
    ctypes.c_void_p,                                    # stream
])
KERNEL_SUMS = build.Kernel("batchnorm", "ktpu_bn_sums_bf16", [
    ctypes.c_void_p, ctypes.c_void_p,                   # x, sums
    ctypes.c_void_p, ctypes.c_void_p,                   # partial, sync
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int,      # M, C, P
    ctypes.c_void_p,                                    # stream
])
KERNEL_FOLD_APPLY = build.Kernel("batchnorm", "ktpu_bn_fold_apply_bf16", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, sums, scale
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # bias, r (or null), y
    ctypes.c_void_p,                                    # mask (or null: no ReLU)
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # w, b, stats
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,  # M, M (every rank's), C
    ctypes.c_float,                                     # eps
    ctypes.c_void_p,                                    # stream
])
KERNEL_BWD_SUMS = build.Kernel("batchnorm", "ktpu_bn_bwd_sums_bf16", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, mask (or null), dy
    ctypes.c_void_p, ctypes.c_void_p,                   # stats, sums
    ctypes.c_void_p, ctypes.c_void_p,                   # dscale, dbias
    ctypes.c_void_p, ctypes.c_void_p,                   # partial, sync
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int,      # M, C, P
    ctypes.c_void_p,                                    # stream
])
KERNEL_BWD_DX = build.Kernel("batchnorm", "ktpu_bn_bwd_dx_bf16", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, mask (or null), dy
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # w, scale, stats
    ctypes.c_void_p,                                    # sums (every rank's)
    ctypes.c_void_p, ctypes.c_void_p,                   # dx, dr (or null)
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,  # M, M (every rank's), C
    ctypes.c_int,                                       # P
    ctypes.c_void_p,                                    # stream
])
# The reductions' block, as csrc/batchnorm.cu's block_for: tx groups of 8
# channels (at most MAX_TX) by THREADS // tx row lanes.
THREADS = 512
MAX_TX = 16

_BITS = torch.tensor([1 << k for k in range(8)], dtype=torch.uint8)


def bn_stats_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = EPS) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(w, b, stats): JAX's f32 statistics and fold, w and b rounded to
    x's dtype.  Differentiable: autograd of ``batchnorm_plain`` is the
    reference the backward is held to."""
    xf = x.float()
    mean = xf.mean(dim=0)
    mean2 = xf.square().mean(dim=0)
    d = mean2 - mean.square()
    rstd = torch.rsqrt(torch.maximum(d, torch.zeros_like(d)) + eps)
    inv = rstd * scale
    gate = torch.where(d > 0, 1.0, torch.where(d == 0, 0.5, 0.0))
    stats = torch.stack([mean, rstd, inv, gate]).detach()
    return inv.to(x.dtype), (bias - mean * inv).to(x.dtype), stats


def relu_mask_plain(y: torch.Tensor) -> torch.Tensor:
    """The (M, C/8) uint8 mask of y > 0: bit k of byte (row, g) is channel
    8g + k (a 0 of either sign is not > 0)."""
    M, C = y.shape
    bits = (y.detach() > 0).view(M, C // 8, 8).to(torch.uint8) * _BITS.to(y.device)
    return bits.sum(dim=2, dtype=torch.uint8)


def relu_unmask_plain(mask: torch.Tensor) -> torch.Tensor:
    """The (M, C) bool y > 0 that ``relu_mask_plain`` packed."""
    M, G = mask.shape
    return ((mask.unsqueeze(2) & _BITS.to(mask.device)) != 0).view(M, G * 8)


def bn_apply_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   r: Optional[torch.Tensor] = None,
                   relu: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(y, mask): relu?(x * w + b [+ r]) in x's dtype, each op rounding
    (the JAX order: the residual adds to the normalised value, then the
    ReLU), and with a ReLU the mask of y > 0 (else None)."""
    y = x * w + b
    if r is not None:
        y = r + y
    if not relu:
        return y, None
    y = torch.relu(y)
    return y, relu_mask_plain(y)


def bn_bwd_plain(x: torch.Tensor, mask: Optional[torch.Tensor], dy: torch.Tensor,
                 w: torch.Tensor, scale: torch.Tensor, stats: torch.Tensor,
                 residual: bool = False):
    """The backward the kernels compute, in f32, rounding once at the end:
    (dx, dr or None, dscale, dbias).  ``mask`` (the apply's, or None where
    the layer has no ReLU) gates dy to y > 0."""
    M = x.shape[0]
    xf, dyf = x.float(), dy.float()
    if mask is not None:
        dyf = torch.where(relu_unmask_plain(mask), dyf, 0.0)
    mean, rstd, inv, gate = stats
    d_b = dyf.sum(dim=0)
    d_w = (dyf * xf).sum(dim=0)
    d_inv = d_w - d_b * mean
    d_v = -0.5 * d_inv * scale * rstd * rstd * rstd * gate
    d_mean = -d_b * inv - 2.0 * mean * d_v
    dx = dyf * w.float() + d_mean / M + (2.0 * d_v / M) * xf
    dr = dyf.to(dy.dtype) if residual else None
    return dx.to(x.dtype), dr, (d_inv * rstd).to(scale.dtype), d_b.to(scale.dtype)


def bn_sums_plain(x: torch.Tensor) -> torch.Tensor:
    """This rank's (2, C) f32 sums (Σx, Σx²) over its rows.
    Differentiable."""
    xf = x.float()
    return torch.stack([xf.sum(dim=0), xf.square().sum(dim=0)])


def bn_fold_plain(sums: torch.Tensor, M: int, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float = EPS, dtype: torch.dtype = torch.bfloat16
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(w, b, stats) from the sums over M rows (every rank's), in
    ``bn_stats_plain``'s arithmetic, w and b rounded to ``dtype`` (x's).
    Differentiable."""
    mean, mean2 = sums[0] / M, sums[1] / M
    d = mean2 - mean.square()
    rstd = torch.rsqrt(torch.maximum(d, torch.zeros_like(d)) + eps)
    inv = rstd * scale
    gate = torch.where(d > 0, 1.0, torch.where(d == 0, 0.5, 0.0))
    stats = torch.stack([mean, rstd, inv, gate]).detach()
    return inv.to(dtype), (bias - mean * inv).to(dtype), stats


def bn_fold_apply_plain(x: torch.Tensor, sums: torch.Tensor, M: int, scale: torch.Tensor,
                        bias: torch.Tensor, r: Optional[torch.Tensor] = None,
                        relu: bool = False, eps: float = EPS):
    """(y, mask, w, b, stats): ``bn_fold_plain`` of the sums over M rows
    (every rank's), w and b in x's dtype, then ``bn_apply_plain`` on this
    rank's rows.  Differentiable."""
    w, b, stats = bn_fold_plain(sums, M, scale, bias, eps, x.dtype)
    return (*bn_apply_plain(x, w, b, r, relu), w, b, stats)


def _masked_dy(mask: Optional[torch.Tensor], dy: torch.Tensor) -> torch.Tensor:
    dyf = dy.float()
    return dyf if mask is None else torch.where(relu_unmask_plain(mask), dyf, 0.0)


def bn_bwd_sums_plain(x: torch.Tensor, mask: Optional[torch.Tensor], dy: torch.Tensor,
                      stats: torch.Tensor):
    """This rank's (2, C) f32 sums (Σdy', Σdy'·x), and the dscale and
    dbias of its rows (from those sums, as ``bn_bwd_plain`` computes
    them): (sums, dscale, dbias)."""
    xf, dyf = x.float(), _masked_dy(mask, dy)
    d_b, d_w = dyf.sum(dim=0), (dyf * xf).sum(dim=0)
    mean, rstd = stats[0], stats[1]
    return torch.stack([d_b, d_w]), (d_w - d_b * mean) * rstd, d_b


def bn_bwd_dx_plain(x: torch.Tensor, mask: Optional[torch.Tensor], dy: torch.Tensor,
                    w: torch.Tensor, scale: torch.Tensor, stats: torch.Tensor,
                    sums: torch.Tensor, M: int, residual: bool = False):
    """(dx, dr or None) of this rank's rows from the sums over every
    rank's M rows, in ``bn_bwd_plain``'s arithmetic."""
    xf, dyf = x.float(), _masked_dy(mask, dy)
    mean, rstd, inv, gate = stats
    d_b, d_w = sums
    d_inv = d_w - d_b * mean
    d_v = -0.5 * d_inv * scale * rstd * rstd * rstd * gate
    d_mean = -d_b * inv - 2.0 * mean * d_v
    dx = dyf * w.float() + d_mean / M + (2.0 * d_v / M) * xf
    return dx.to(x.dtype), (dyf.to(dy.dtype) if residual else None)


class _AllReduceSum(torch.autograd.Function):
    """A sum over the group's ranks whose gradient is the sum of the
    ranks' gradients: every rank's loss reaches every rank's input."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def batchnorm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    residual: Optional[torch.Tensor] = None, relu: bool = False,
                    group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """The plain forward (autograd differentiates it); with ``group``,
    the split form: sums, a differentiable all-reduce, the fold over M·n
    rows and the apply."""
    if group is not None:
        sums = _AllReduceSum.apply(bn_sums_plain(x), group)
        return bn_fold_apply_plain(x, sums, x.shape[0] * dist.get_world_size(group), scale,
                                   bias, residual, relu)[0]
    w, b, _stats = bn_stats_plain(x, scale, bias)
    return bn_apply_plain(x, w, b, residual, relu)[0]


def num_partials(M: int, C: int, resident: int) -> int:
    """P, the blocks along M of the reductions' grid (one (2, C) f32
    partial each): as many as the rows need, while all of the grid's
    blocks fit among the ``resident`` ones."""
    tx = min(C // 8, MAX_TX)
    ty = THREADS // tx
    gx = math.ceil(C // 8 / tx)
    return max(1, min(math.ceil(M / ty), resident // gx))


def _check(op, x, *per_channel):
    if x.dim() != 2 or x.shape[1] % 8 or x.shape[0] == 0:
        raise ValueError(f"{op}: x (M, C) with M > 0 and C % 8 == 0 required, "
                         f"got {tuple(x.shape)}")
    for t in per_channel:
        if tuple(t.shape) != (x.shape[1],):
            raise ValueError(f"{op}: per-channel tensors ({x.shape[1]},) required, "
                             f"got {tuple(t.shape)}")


class _Grid:
    """Per device: the reductions' resident blocks (asked of the library
    once) and the columns' ticket words (``build.ticket_words``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._resident: Dict[int, int] = {}

    def resident(self, device: torch.device) -> int:
        with self._lock:
            if device.index not in self._resident:
                out = ctypes.c_int(0)
                fn = build.load_library("batchnorm").ktpu_bn_resident_blocks
                fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_int)], ctypes.c_int
                err = fn(ctypes.byref(out))
                if err != 0 or out.value <= 0:
                    raise build.KernelLaunchError(
                        f"ktpu_bn_resident_blocks: CUDA error {err}, {out.value} blocks")
                self._resident[device.index] = out.value
            return self._resident[device.index]

    def sync(self, device: torch.device, C: int) -> torch.Tensor:
        return build.ticket_words(device, 2 * math.ceil(C // 8 / MAX_TX))


_GRID = _Grid()


def bn_stats_kernel(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = EPS) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of the statistics kernel (the partial sums, and in each
    column's last block the per-channel fold): (w, b, stats)."""
    KERNEL_STATS.load()
    build.check_cuda_tensors("bn_stats", x)
    build.check_cuda_tensors("bn_stats", scale, bias, dtype=torch.float32)
    _check("bn_stats", x, scale, bias)
    M, C = x.shape
    P = num_partials(M, C, _GRID.resident(x.device))
    w = torch.empty(C, device=x.device, dtype=x.dtype)
    b = torch.empty(C, device=x.device, dtype=x.dtype)
    stats = torch.empty((4, C), device=x.device, dtype=torch.float32)
    partial = torch.empty((P, 2, C), device=x.device, dtype=torch.float32)
    KERNEL_STATS.launch(x.device, x.data_ptr(), scale.data_ptr(), bias.data_ptr(), w.data_ptr(),
                        b.data_ptr(), stats.data_ptr(), partial.data_ptr(),
                        _GRID.sync(x.device, C).data_ptr(), M, C, P, eps)
    return w, b, stats


def bn_apply_kernel(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    r: Optional[torch.Tensor] = None,
                    relu: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One launch of the apply kernel: (y, mask), y = relu?(x * w + b [+ r])
    computed in f32 and rounded once, and with a ReLU the (M, C/8) uint8
    mask of y > 0 (else None)."""
    KERNEL_APPLY.load()
    build.check_cuda_tensors("bn_apply", x, w, b, *([] if r is None else [r]))
    _check("bn_apply", x, w, b)
    if r is not None and r.shape != x.shape:
        raise ValueError(f"bn_apply: residual {tuple(r.shape)} != x {tuple(x.shape)}")
    M, C = x.shape
    y = torch.empty_like(x)
    mask = torch.empty((M, C // 8), device=x.device, dtype=torch.uint8) if relu else None
    KERNEL_APPLY.launch(x.device, x.data_ptr(), w.data_ptr(), b.data_ptr(),
                        None if r is None else r.data_ptr(), y.data_ptr(),
                        None if mask is None else mask.data_ptr(), M, C)
    return y, mask


def bn_bwd_kernel(x: torch.Tensor, mask: Optional[torch.Tensor], dy: torch.Tensor,
                  w: torch.Tensor, scale: torch.Tensor, stats: torch.Tensor,
                  residual: bool = False):
    """One launch of the backward kernel (the sums of dy' and dy'·x, the
    per-channel chain rule in each column's last block, then dx over each
    block's own rows): (dx, dr or None, dscale, dbias)."""
    KERNEL_BWD.load()
    build.check_cuda_tensors("bn_bwd", x, dy, w)
    build.check_cuda_tensors("bn_bwd", scale, stats, dtype=torch.float32)
    _check("bn_bwd", x, w, scale)
    M, C = x.shape
    if mask is not None:
        build.check_cuda_tensors("bn_bwd", mask, dtype=torch.uint8)
    if (dy.shape != x.shape or stats.shape != (4, C) or (mask is not None and (
            mask.shape != (M, C // 8) or mask.device != x.device))):
        raise ValueError(f"bn_bwd: dy {tuple(dy.shape)}, mask (M, C/8) and stats (4, {C}) "
                         f"must match x {tuple(x.shape)} on its device")
    P = num_partials(M, C, _GRID.resident(x.device))
    dx = torch.empty_like(x)
    dr = torch.empty_like(dy) if residual else None
    dscale, dbias = torch.empty_like(scale), torch.empty_like(scale)
    partial = torch.empty((P, 2, C), device=x.device, dtype=torch.float32)
    coef = torch.empty((2, C), device=x.device, dtype=torch.float32)
    KERNEL_BWD.launch(x.device, x.data_ptr(), None if mask is None else mask.data_ptr(),
                      dy.data_ptr(), w.data_ptr(), scale.data_ptr(), stats.data_ptr(),
                      dx.data_ptr(), None if dr is None else dr.data_ptr(), dscale.data_ptr(),
                      dbias.data_ptr(), partial.data_ptr(), coef.data_ptr(),
                      _GRID.sync(x.device, C).data_ptr(), M, C, P)
    return dx, dr, dscale, dbias


def bn_sums_kernel(x: torch.Tensor) -> torch.Tensor:
    """One launch: this rank's (2, C) f32 sums (Σx, Σx²), from the
    statistics kernel's partials in its order."""
    KERNEL_SUMS.load()
    build.check_cuda_tensors("bn_sums", x)
    _check("bn_sums", x)
    M, C = x.shape
    P = num_partials(M, C, _GRID.resident(x.device))
    sums = torch.empty((2, C), device=x.device, dtype=torch.float32)
    partial = torch.empty((P, 2, C), device=x.device, dtype=torch.float32)
    KERNEL_SUMS.launch(x.device, x.data_ptr(), sums.data_ptr(), partial.data_ptr(),
                       _GRID.sync(x.device, C).data_ptr(), M, C, P)
    return sums


def bn_fold_apply_kernel(x: torch.Tensor, sums: torch.Tensor, M: int, scale: torch.Tensor,
                         bias: torch.Tensor, r: Optional[torch.Tensor] = None,
                         relu: bool = False, eps: float = EPS):
    """One launch of the split forward's apply: (y, mask, w, b, stats).
    Each block folds its channels' (2, C) sums over M rows (every rank's)
    in the statistics kernel's arithmetic, then applies them to its rows
    of x as ``bn_apply_kernel`` does; w, b (bf16) and stats (f32) are the
    fold's, for the backward."""
    KERNEL_FOLD_APPLY.load()
    build.check_cuda_tensors("bn_fold_apply", x, *([] if r is None else [r]))
    build.check_cuda_tensors("bn_fold_apply", sums, scale, bias, dtype=torch.float32)
    _check("bn_fold_apply", x, scale, bias)
    rows, C = x.shape
    if sums.shape != (2, C) or M < rows or (r is not None and r.shape != x.shape):
        raise ValueError(f"bn_fold_apply: sums (2, {C}) over M >= {rows} rows and a residual "
                         f"like x, got {tuple(sums.shape)} over {M}, "
                         f"{None if r is None else tuple(r.shape)}")
    y = torch.empty_like(x)
    mask = torch.empty((rows, C // 8), device=x.device, dtype=torch.uint8) if relu else None
    w = torch.empty(C, device=x.device, dtype=x.dtype)
    b = torch.empty(C, device=x.device, dtype=x.dtype)
    stats = torch.empty((4, C), device=x.device, dtype=torch.float32)
    KERNEL_FOLD_APPLY.launch(x.device, x.data_ptr(), sums.data_ptr(), scale.data_ptr(),
                             bias.data_ptr(), None if r is None else r.data_ptr(), y.data_ptr(),
                             None if mask is None else mask.data_ptr(), w.data_ptr(),
                             b.data_ptr(), stats.data_ptr(), rows, M, C, eps)
    return y, mask, w, b, stats


def _check_bwd(op, x, mask, dy, stats):
    M, C = x.shape
    if mask is not None:
        build.check_cuda_tensors(op, mask, dtype=torch.uint8)
    if (dy.shape != x.shape or stats.shape != (4, C) or (mask is not None and (
            mask.shape != (M, C // 8) or mask.device != x.device))):
        raise ValueError(f"{op}: dy {tuple(dy.shape)}, mask (M, C/8) and stats (4, {C}) "
                         f"must match x {tuple(x.shape)} on its device")


def bn_bwd_sums_kernel(x: torch.Tensor, mask: Optional[torch.Tensor], dy: torch.Tensor,
                       stats: torch.Tensor):
    """One launch: this rank's (2, C) sums (Σdy', Σdy'·x), from the
    backward kernel's partials in its order, and the dscale and dbias of
    its rows: (sums, dscale, dbias), f32."""
    KERNEL_BWD_SUMS.load()
    build.check_cuda_tensors("bn_bwd_sums", x, dy)
    build.check_cuda_tensors("bn_bwd_sums", stats, dtype=torch.float32)
    _check("bn_bwd_sums", x)
    _check_bwd("bn_bwd_sums", x, mask, dy, stats)
    M, C = x.shape
    P = num_partials(M, C, _GRID.resident(x.device))
    sums = torch.empty((2, C), device=x.device, dtype=torch.float32)
    dscale, dbias = (torch.empty(C, device=x.device, dtype=torch.float32) for _ in range(2))
    partial = torch.empty((P, 2, C), device=x.device, dtype=torch.float32)
    KERNEL_BWD_SUMS.launch(x.device, x.data_ptr(), None if mask is None else mask.data_ptr(),
                           dy.data_ptr(), stats.data_ptr(), sums.data_ptr(), dscale.data_ptr(),
                           dbias.data_ptr(), partial.data_ptr(),
                           _GRID.sync(x.device, C).data_ptr(), M, C, P)
    return sums, dscale, dbias


def bn_bwd_dx_kernel(x: torch.Tensor, mask: Optional[torch.Tensor], dy: torch.Tensor,
                     w: torch.Tensor, scale: torch.Tensor, stats: torch.Tensor,
                     sums: torch.Tensor, M: int, residual: bool = False):
    """One launch: (dx, dr or None) of this rank's rows from the (2, C)
    sums over every rank's M rows."""
    KERNEL_BWD_DX.load()
    build.check_cuda_tensors("bn_bwd_dx", x, dy, w)
    build.check_cuda_tensors("bn_bwd_dx", scale, stats, sums, dtype=torch.float32)
    _check("bn_bwd_dx", x, w, scale)
    _check_bwd("bn_bwd_dx", x, mask, dy, stats)
    rows, C = x.shape
    if sums.shape != (2, C) or M < rows:
        raise ValueError(f"bn_bwd_dx: sums (2, {C}) over M >= {rows} rows, got "
                         f"{tuple(sums.shape)} over {M}")
    P = num_partials(rows, C, _GRID.resident(x.device))
    dx = torch.empty_like(x)
    dr = torch.empty_like(dy) if residual else None
    KERNEL_BWD_DX.launch(x.device, x.data_ptr(), None if mask is None else mask.data_ptr(),
                         dy.data_ptr(), w.data_ptr(), scale.data_ptr(), stats.data_ptr(),
                         sums.data_ptr(), dx.data_ptr(), None if dr is None else dr.data_ptr(),
                         rows, M, C, P)
    return dx, dr


def _apply_over(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                r: Optional[torch.Tensor], relu: bool, group: dist.ProcessGroup):
    """(y, mask, w, stats, M) with the statistics over every rank's rows, M
    of them (each rank gives x.shape[0]): this rank's sums, their
    all-reduce, the apply that folds them (two launches)."""
    M = x.shape[0] * dist.get_world_size(group)
    sums = bn_sums_kernel(x)
    dist.all_reduce(sums, group=group)
    y, mask, w, _b, stats = bn_fold_apply_kernel(x, sums, M, scale, bias, r, relu)
    return y, mask, w, stats, M


class _BatchNormRanksFn(torch.autograd.Function):
    """The split kernels over ``group``: sums, all-reduce, the apply that
    folds them; backward sums (and this rank's dscale, dbias), all-reduce,
    dx."""

    @staticmethod
    def forward(ctx, x, scale, bias, r, relu, group):
        y, mask, w, stats, M = _apply_over(x, scale, bias, r, relu, group)
        ctx.save_for_backward(x, mask, w, scale, stats)
        ctx.residual, ctx.group, ctx.M = r is not None, group, M
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mask, w, scale, stats = ctx.saved_tensors
        dy = dy.contiguous()
        sums, dscale, dbias = bn_bwd_sums_kernel(x, mask, dy, stats)
        dist.all_reduce(sums, group=ctx.group)
        dx, dr = bn_bwd_dx_kernel(x, mask, dy, w, scale, stats, sums, ctx.M, ctx.residual)
        return dx, dscale, dbias, dr, None, None


class _BatchNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, r, relu):
        w, b, stats = bn_stats_kernel(x, scale, bias)
        y, mask = bn_apply_kernel(x, w, b, r, relu)
        # the backward reads the ReLU's mask, never y
        ctx.save_for_backward(x, mask, w, scale, stats)
        ctx.residual = r is not None
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mask, w, scale, stats = ctx.saved_tensors
        dx, dr, dscale, dbias = bn_bwd_kernel(x, mask, dy.contiguous(), w, scale, stats,
                                              ctx.residual)
        return dx, dscale, dbias, dr, None


def batchnorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              residual: Optional[torch.Tensor] = None, relu: bool = False,
              group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Training-mode batch norm of ``x`` (M, C) with batch statistics,
    then the residual add and the ReLU where asked: relu?(bn(x) [+ r]).
    With ``group``, the statistics are over every rank's rows (each rank
    gives the same M): the split form.

    A CPU tensor takes the plain version (autograd differentiates it); a
    CUDA tensor launches the kernels (bf16, C % 8 == 0) or raises."""
    if x.device.type == "cpu":
        return batchnorm_plain(x, scale, bias, residual, relu, group)
    return batchnorm_on_kernels(x, scale, bias, residual, relu, group)


def batchnorm_on_kernels(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         residual: Optional[torch.Tensor] = None,
                         relu: bool = False,
                         group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """The wrapper's kernel path: the statistics and apply kernels alone,
    or, where a gradient is wanted, the autograd Function over them and
    the backward kernel; with ``group``, the split kernels with an
    all-reduce between each pair (bn_sums and bn_fold_apply; bn_bwd_sums
    and bn_bwd_dx)."""
    tensors = (x, scale, bias) + (() if residual is None else (residual,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        if group is not None:
            return _BatchNormRanksFn.apply(x, scale, bias, residual, relu, group)
        return _BatchNormFn.apply(x, scale, bias, residual, relu)
    if group is not None:
        return _apply_over(x, scale, bias, residual, relu, group)[0]
    w, b, _stats = bn_stats_kernel(x, scale, bias)
    return bn_apply_kernel(x, w, b, residual, relu)[0]
