"""K2 RMSNorm: the hand-written CUDA kernels (forward and backward) and
their plain PyTorch versions.

Replaces the XLA-fused ``rmsnorm`` of the JAX package's
``workloads/llama.py``; the kernels are in ``csrc/rmsnorm.cu``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import build

KERNEL = build.Kernel("rmsnorm", "ktpu_rmsnorm_bf16", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, scale, out
    ctypes.c_int, ctypes.c_int, ctypes.c_float,         # rows, d, eps
    ctypes.c_void_p,                                    # stream
])
KERNEL_BWD = build.Kernel("rmsnorm", "ktpu_rmsnorm_bwd_bf16", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, scale, dy
    ctypes.c_void_p, ctypes.c_void_p,                   # dx, dscale
    ctypes.c_void_p, ctypes.c_void_p,                   # partial, sync
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int,      # rows, d, P
    ctypes.c_float,                                     # eps
    ctypes.c_void_p,                                    # stream
])

_grids: Dict[Tuple[Optional[int], int], Tuple[int, int]] = {}


def bwd_blocks(device: torch.device, rows: int, d: int) -> int:
    """The backward's blocks at (rows, d) on ``device``, each one (d,) f32
    partial of dscale: as many as the SMs hold at once (the launch is
    cooperative, and the library counts them once per width), but no more
    than one per row a block takes at a time."""
    key = (device.index, d)
    if key not in _grids:
        fn = build.load_library("rmsnorm").ktpu_rmsnorm_bwd_grid
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        resident, per_block = ctypes.c_int(0), ctypes.c_int(0)
        err = fn(d, ctypes.byref(resident), ctypes.byref(per_block))
        if err != 0 or resident.value <= 0 or per_block.value <= 0:
            raise build.KernelLaunchError(f"ktpu_rmsnorm_bwd_grid({d}): CUDA error {err}, "
                                          f"{resident.value} blocks of {per_block.value} rows")
        _grids[key] = (resident.value, per_block.value)
    resident, per_block = _grids[key]
    return min(resident, -(-rows // per_block))


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """f32 mean of squares, ``x * rsqrt(var + eps)`` cast to x's dtype,
    THEN times the scale cast to x's dtype (the JAX order of roundings)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def rmsnorm_bwd_plain(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                      eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward the kernel computes, in f32: with r = rsqrt(var + eps)
    and dn = dy * scale rounded to x's dtype (the VJP of the product in
    that dtype), dx = r*dn - x * r^3 * mean(dn * x), and dscale = the sum
    over rows of dy * (x * r rounded); each rounded once at the end.
    ``scale`` is in x's dtype, as the layer hands it over."""
    d = x.shape[-1]
    xf, dyf = x.float().reshape(-1, d), dy.float().reshape(-1, d)
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    dn = (dyf * scale.float()).to(x.dtype).float()
    dx = r * dn - xf * (r ** 3) * (dn * xf).mean(dim=-1, keepdim=True)
    dscale = (dyf * (xf * r).to(x.dtype).float()).sum(dim=0)
    return dx.to(x.dtype).reshape(x.shape), dscale.to(scale.dtype)


def _check(x, scale):
    d = x.shape[-1]
    if scale.shape != (d,) or d % 8:
        raise ValueError(f"rmsnorm: x (..., {d}) with d % 8 == 0 and scale ({d},) "
                         f"required, got scale {tuple(scale.shape)}")


def rmsnorm_kernel(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """One launch of the forward kernel; ``scale`` in x's dtype."""
    _check(x, scale)
    build.check_cuda_tensors("rmsnorm", x, scale)
    KERNEL.load()
    out = torch.empty_like(x)
    d = x.shape[-1]
    KERNEL.launch(x.device, x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                  x.numel() // d, d, eps)
    return out


def rmsnorm_bwd_kernel(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                       eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the backward kernel (the rows, then the column sums of
    its per-block partials): (dx, dscale).  Raises for a CPU tensor: it
    never runs the plain version."""
    _check(x, scale)
    if dy.shape != x.shape:
        raise ValueError(f"rmsnorm backward: dy {tuple(dy.shape)} != x {tuple(x.shape)}")
    build.check_cuda_tensors("rmsnorm backward", x, scale, dy)
    KERNEL_BWD.load()
    d = x.shape[-1]
    rows = x.numel() // d
    P = bwd_blocks(x.device, rows, d)
    dx, dscale = torch.empty_like(x), torch.empty_like(scale)
    partial = torch.empty((P, d), device=x.device, dtype=torch.float32)
    KERNEL_BWD.launch(x.device, x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                      dscale.data_ptr(), partial.data_ptr(),
                      build.ticket_words(x.device, 2).data_ptr(), rows, d, P, eps)
    return dx, dscale


class _RMSNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm_kernel(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd_kernel(x, scale, dy.contiguous(), ctx.eps)
        return dx, dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis of ``x`` (..., d) with ``scale`` (d,).

    A CPU tensor takes the plain version (autograd differentiates it); a
    CUDA tensor launches the kernel (bf16, d % 8 == 0) or raises.  The
    scale is cast to x's dtype first, outside the kernels, as the JAX
    function casts it: an f32 scale's gradient flows back through that
    cast."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    return rmsnorm_on_kernels(x, scale, eps)


def rmsnorm_on_kernels(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The wrapper's kernel path: the forward kernel alone, or, where a
    gradient is wanted, the autograd Function over both kernels."""
    scale = scale.to(x.dtype)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNormFn.apply(x, scale, eps)
    return rmsnorm_kernel(x, scale, eps)
