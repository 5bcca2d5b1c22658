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
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import build

EPS = 1e-5  # resnet.py's _bn

KERNEL_STATS = build.Kernel("batchnorm", "ktpu_bn_stats_bf16", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, scale, bias
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # w, b, stats
    ctypes.c_void_p,                                    # partial
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int,      # M, C, P
    ctypes.c_float,                                     # eps
    ctypes.c_void_p,                                    # stream
])
KERNEL_APPLY = build.Kernel("batchnorm", "ktpu_bn_apply_bf16", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, w, b
    ctypes.c_void_p, ctypes.c_void_p,                   # r (or null), y
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int,      # M, C, relu
    ctypes.c_void_p,                                    # stream
])
KERNEL_BWD = build.Kernel("batchnorm", "ktpu_bn_bwd_bf16", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, y (or null), dy
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # w, scale, stats
    ctypes.c_void_p, ctypes.c_void_p,                   # dx, dr (or null)
    ctypes.c_void_p, ctypes.c_void_p,                   # dscale, dbias
    ctypes.c_void_p, ctypes.c_void_p,                   # partial, coef
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int,      # M, C, P
    ctypes.c_int,                                       # relu
    ctypes.c_void_p,                                    # stream
])
# The reductions' grid: blocks of 256 threads, tx groups of 8 channels by
# 256 // tx row lanes (as csrc/batchnorm.cu's partial_block), and about 8
# blocks on each of an H100's 132 SMs in all.
THREADS = 256
TARGET_BLOCKS = 8 * 132


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


def bn_apply_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   r: Optional[torch.Tensor] = None, relu: bool = False) -> torch.Tensor:
    """relu?(x * w + b [+ r]) in x's dtype, each op rounding (the JAX
    order: the residual adds to the normalised value, then the ReLU)."""
    y = x * w + b
    if r is not None:
        y = r + y
    return torch.relu(y) if relu else y


def bn_bwd_plain(x: torch.Tensor, y: Optional[torch.Tensor], dy: torch.Tensor, w: torch.Tensor,
                 scale: torch.Tensor, stats: torch.Tensor, relu: bool = False,
                 residual: bool = False):
    """The backward the kernels compute, in f32, rounding once at the end:
    (dx, dr or None, dscale, dbias).  ``y`` (the forward's output) is read
    only for the ReLU's mask y > 0."""
    M = x.shape[0]
    xf, dyf = x.float(), dy.float()
    if relu:
        dyf = torch.where(y > 0, dyf, 0.0)
    mean, rstd, inv, gate = stats
    d_b = dyf.sum(dim=0)
    d_w = (dyf * xf).sum(dim=0)
    d_inv = d_w - d_b * mean
    d_v = -0.5 * d_inv * scale * rstd * rstd * rstd * gate
    d_mean = -d_b * inv - 2.0 * mean * d_v
    dx = dyf * w.float() + d_mean / M + (2.0 * d_v / M) * xf
    dr = dyf.to(dy.dtype) if residual else None
    return dx.to(x.dtype), dr, (d_inv * rstd).to(scale.dtype), d_b.to(scale.dtype)


def batchnorm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    residual: Optional[torch.Tensor] = None, relu: bool = False) -> torch.Tensor:
    w, b, _stats = bn_stats_plain(x, scale, bias)
    return bn_apply_plain(x, w, b, residual, relu)


def num_partials(M: int, C: int) -> int:
    """P, the blocks along M of the reductions' grid (one (2, C) f32
    partial each)."""
    tx = min(C // 8, 32)
    ty = THREADS // tx
    gx = math.ceil(C // 8 / tx)
    return max(1, min(math.ceil(M / ty), math.ceil(TARGET_BLOCKS / gx)))


def _check(op, x, *per_channel):
    if x.dim() != 2 or x.shape[1] % 8 or x.shape[0] == 0:
        raise ValueError(f"{op}: x (M, C) with M > 0 and C % 8 == 0 required, "
                         f"got {tuple(x.shape)}")
    for t in per_channel:
        if tuple(t.shape) != (x.shape[1],):
            raise ValueError(f"{op}: per-channel tensors ({x.shape[1]},) required, "
                             f"got {tuple(t.shape)}")


def bn_stats_kernel(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = EPS) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One call of the statistics entry point (the partial sums, then the
    per-channel fold): (w, b, stats)."""
    KERNEL_STATS.load()
    build.check_cuda_tensors("bn_stats", x)
    build.check_cuda_tensors("bn_stats", scale, bias, dtype=torch.float32)
    _check("bn_stats", x, scale, bias)
    M, C = x.shape
    P = num_partials(M, C)
    w = torch.empty(C, device=x.device, dtype=x.dtype)
    b = torch.empty(C, device=x.device, dtype=x.dtype)
    stats = torch.empty((4, C), device=x.device, dtype=torch.float32)
    partial = torch.empty((P, 2, C), device=x.device, dtype=torch.float32)
    KERNEL_STATS.launch(x.device, x.data_ptr(), scale.data_ptr(), bias.data_ptr(), w.data_ptr(),
                        b.data_ptr(), stats.data_ptr(), partial.data_ptr(), M, C, P, eps)
    return w, b, stats


def bn_apply_kernel(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    r: Optional[torch.Tensor] = None, relu: bool = False) -> torch.Tensor:
    """One launch of the apply kernel: relu?(x * w + b [+ r]) computed in
    f32 and rounded once."""
    KERNEL_APPLY.load()
    build.check_cuda_tensors("bn_apply", x, w, b, *([] if r is None else [r]))
    _check("bn_apply", x, w, b)
    if r is not None and r.shape != x.shape:
        raise ValueError(f"bn_apply: residual {tuple(r.shape)} != x {tuple(x.shape)}")
    y = torch.empty_like(x)
    KERNEL_APPLY.launch(x.device, x.data_ptr(), w.data_ptr(), b.data_ptr(),
                        None if r is None else r.data_ptr(), y.data_ptr(), x.shape[0],
                        x.shape[1], int(relu))
    return y


def bn_bwd_kernel(x: torch.Tensor, y: Optional[torch.Tensor], dy: torch.Tensor,
                  w: torch.Tensor, scale: torch.Tensor, stats: torch.Tensor,
                  relu: bool = False, residual: bool = False):
    """One call of the backward entry point (the partial sums of dy' and
    dy'·x, the per-channel chain rule, the elementwise dx):
    (dx, dr or None, dscale, dbias)."""
    KERNEL_BWD.load()
    build.check_cuda_tensors("bn_bwd", x, dy, w, *([y] if relu else []))
    build.check_cuda_tensors("bn_bwd", scale, stats, dtype=torch.float32)
    _check("bn_bwd", x, w, scale)
    M, C = x.shape
    if dy.shape != x.shape or (relu and y.shape != x.shape) or stats.shape != (4, C):
        raise ValueError(f"bn_bwd: dy {tuple(dy.shape)}, y and stats (4, {C}) must match "
                         f"x {tuple(x.shape)}")
    P = num_partials(M, C)
    dx = torch.empty_like(x)
    dr = torch.empty_like(dy) if residual else None
    dscale, dbias = torch.empty_like(scale), torch.empty_like(scale)
    partial = torch.empty((P, 2, C), device=x.device, dtype=torch.float32)
    coef = torch.empty((2, C), device=x.device, dtype=torch.float32)
    KERNEL_BWD.launch(x.device, x.data_ptr(), y.data_ptr() if relu else None, dy.data_ptr(),
                      w.data_ptr(), scale.data_ptr(), stats.data_ptr(), dx.data_ptr(),
                      None if dr is None else dr.data_ptr(), dscale.data_ptr(),
                      dbias.data_ptr(), partial.data_ptr(), coef.data_ptr(), M, C, P, int(relu))
    return dx, dr, dscale, dbias


class _BatchNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, r, relu):
        w, b, stats = bn_stats_kernel(x, scale, bias)
        y = bn_apply_kernel(x, w, b, r, relu)
        # the output is kept only for the ReLU's mask
        ctx.save_for_backward(x, y if relu else None, w, scale, stats)
        ctx.relu, ctx.residual = relu, r is not None
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y, w, scale, stats = ctx.saved_tensors
        dx, dr, dscale, dbias = bn_bwd_kernel(x, y, dy.contiguous(), w, scale, stats,
                                              ctx.relu, ctx.residual)
        return dx, dscale, dbias, dr, None


def batchnorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              residual: Optional[torch.Tensor] = None, relu: bool = False) -> torch.Tensor:
    """Training-mode batch norm of ``x`` (M, C) with batch statistics,
    then the residual add and the ReLU where asked: relu?(bn(x) [+ r]).

    A CPU tensor takes the plain version (autograd differentiates it); a
    CUDA tensor launches the kernels (bf16, C % 8 == 0) or raises."""
    if x.device.type == "cpu":
        return batchnorm_plain(x, scale, bias, residual, relu)
    return batchnorm_on_kernels(x, scale, bias, residual, relu)


def batchnorm_on_kernels(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         residual: Optional[torch.Tensor] = None,
                         relu: bool = False) -> torch.Tensor:
    """The wrapper's kernel path: the statistics and apply kernels alone,
    or, where a gradient is wanted, the autograd Function over them and
    the backward kernel."""
    tensors = (x, scale, bias) + (() if residual is None else (residual,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _BatchNormFn.apply(x, scale, bias, residual, relu)
    w, b, _stats = bn_stats_kernel(x, scale, bias)
    return bn_apply_kernel(x, w, b, residual, relu)
