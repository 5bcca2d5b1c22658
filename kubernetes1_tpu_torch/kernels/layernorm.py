"""K7b LayerNorm: the hand-written CUDA kernels (forward and backward) and
their plain PyTorch versions.

Replaces the XLA-fused ``layernorm`` of the JAX package's
``workloads/bert.py``: f32 statistics with the two-pass variance, f32
scale and bias, eps 1e-6, one rounding to x's dtype at the end.  The
kernels are in ``csrc/layernorm.cu``.  The residual add before it
(``layernorm(x + attn)``) stays a torch op: the kernel takes its
rounded bf16 sum, as JAX's bf16 add rounds it.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import build

KERNEL = build.Kernel("layernorm", "ktpu_layernorm_fwd_bf16", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, scale, bias
    ctypes.c_void_p,                                    # y
    ctypes.c_longlong, ctypes.c_int, ctypes.c_float,    # rows, d, eps
    ctypes.c_void_p,                                    # stream
])
KERNEL_BWD = build.Kernel("layernorm", "ktpu_layernorm_bwd_bf16", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, scale, dy
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # dx, dscale, dbias
    ctypes.c_void_p, ctypes.c_void_p,                   # partial, sync
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int,      # rows, d, P
    ctypes.c_float,                                     # eps
    ctypes.c_void_p,                                    # stream
])
EPS = 1e-6  # bert.py's layernorm default

_grids: Dict[Tuple[Optional[int], int], Tuple[int, int]] = {}


def bwd_blocks(device: torch.device, rows: int, d: int) -> int:
    """The backward's blocks at (rows, d) on ``device``, each one (2, d)
    f32 partial of dscale and dbias: as many as the SMs hold at once (the
    launch is cooperative, and the library counts them once per width),
    but no more than one per consumer warp's row of a stage."""
    key = (device.index, d)
    if key not in _grids:
        fn = build.load_library("layernorm").ktpu_layernorm_bwd_grid
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        resident, warps = ctypes.c_int(0), ctypes.c_int(0)
        err = fn(d, ctypes.byref(resident), ctypes.byref(warps))
        if err != 0 or resident.value <= 0 or warps.value <= 0:
            raise build.KernelLaunchError(f"ktpu_layernorm_bwd_grid({d}): CUDA error {err}, "
                                          f"{resident.value} blocks of {warps.value} warps")
        _grids[key] = (resident.value, warps.value)
    resident, warps = _grids[key]
    return min(resident, -(-rows // warps))


def layernorm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = EPS) -> torch.Tensor:
    """JAX's ``layernorm`` step for step: the f32 mean, the two-pass
    variance mean((xf - mu)^2), ``(xf - mu) * rsqrt(var + eps) * scale +
    bias`` in f32, cast once to x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def layernorm_bwd_plain(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                        eps: float = EPS) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward the kernel computes, in f32, as JAX differentiates the
    two-pass form: with c = xf - mu, r = rsqrt(var + eps) and g = dy *
    scale, dc = g*r - c * r^3 * mean(g*c) (through r and var), dx = dc -
    mean(dc) (through mu), rounded once to x's dtype; dscale = the sum over
    rows of dy * (c * r) and dbias of dy, in f32."""
    d = x.shape[-1]
    xf, dyf = x.float().reshape(-1, d), dy.float().reshape(-1, d)
    mu = xf.mean(dim=-1, keepdim=True)
    c = xf - mu
    r = torch.rsqrt(c.square().mean(dim=-1, keepdim=True) + eps)
    g = dyf * scale
    dc = g * r - c * r ** 3 * (g * c).mean(dim=-1, keepdim=True)
    dx = dc - dc.mean(dim=-1, keepdim=True)
    return (dx.to(x.dtype).reshape(x.shape), (dyf * (c * r)).sum(dim=0), dyf.sum(dim=0))


def _check(x, scale, bias):
    d = x.shape[-1]
    if scale.shape != (d,) or bias.shape != (d,) or d % 8:
        raise ValueError(f"layernorm: x (..., {d}) with d % 8 == 0, scale and bias ({d},) "
                         f"required, got {tuple(scale.shape)} and {tuple(bias.shape)}")


def layernorm_kernel(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = EPS) -> torch.Tensor:
    """One launch of the forward kernel: bf16 x, f32 scale and bias."""
    _check(x, scale, bias)
    build.check_cuda_tensors("layernorm", x)
    build.check_cuda_tensors("layernorm", scale, bias, dtype=torch.float32)
    KERNEL.load()
    y = torch.empty_like(x)
    d = x.shape[-1]
    KERNEL.launch(x.device, x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
                  x.numel() // d, d, eps)
    return y


def layernorm_bwd_kernel(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                         eps: float = EPS) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of the backward kernel (the rows, then the column sums of
    its per-block partials): (dx, dscale, dbias).  Raises for a CPU
    tensor: it never runs the plain version."""
    _check(x, scale, scale)
    if dy.shape != x.shape:
        raise ValueError(f"layernorm backward: dy {tuple(dy.shape)} != x {tuple(x.shape)}")
    build.check_cuda_tensors("layernorm backward", x, dy)
    build.check_cuda_tensors("layernorm backward", scale, dtype=torch.float32)
    KERNEL_BWD.load()
    d = x.shape[-1]
    rows = x.numel() // d
    P = bwd_blocks(x.device, rows, d)
    dx, dscale, dbias = torch.empty_like(x), torch.empty_like(scale), torch.empty_like(scale)
    partial = torch.empty((P, 2, d), device=x.device, dtype=torch.float32)
    KERNEL_BWD.launch(x.device, x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                      dscale.data_ptr(), dbias.data_ptr(), partial.data_ptr(),
                      build.ticket_words(x.device, 2).data_ptr(), rows, d, P, eps)
    return dx, dscale, dbias


class _LayerNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return layernorm_kernel(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale, dbias = layernorm_bwd_kernel(x, scale, dy.contiguous(), ctx.eps)
        return dx, dscale, dbias, None


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = EPS) -> torch.Tensor:
    """LayerNorm over the last axis of ``x`` (..., d) with f32 ``scale``
    and ``bias`` (d,).

    A CPU tensor takes the plain version (autograd differentiates it); a
    CUDA tensor launches the kernel (bf16 x, d % 8 == 0) or raises."""
    if x.device.type == "cpu":
        return layernorm_plain(x, scale, bias, eps)
    return layernorm_on_kernels(x, scale, bias, eps)


def layernorm_on_kernels(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         eps: float = EPS) -> torch.Tensor:
    """The wrapper's kernel path: the forward kernel alone, or, where a
    gradient is wanted, the autograd Function over both kernels."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _LayerNormFn.apply(x, scale, bias, eps)
    return layernorm_kernel(x, scale, bias, eps)
