"""K2 RMSNorm: the hand-written CUDA kernel and its plain PyTorch version.

Replaces the XLA-fused ``rmsnorm`` of the JAX package's
``workloads/llama.py``; the kernel is ``csrc/rmsnorm.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

KERNEL = build.Kernel("rmsnorm", "ktpu_rmsnorm_bf16", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, scale, out
    ctypes.c_int, ctypes.c_int, ctypes.c_float,         # rows, d, eps
    ctypes.c_void_p,                                    # stream
])


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """f32 mean of squares, ``x * rsqrt(var + eps)`` cast to x's dtype,
    THEN times the scale cast to x's dtype (the JAX order of roundings)."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x.float() * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis of ``x`` (..., d) with ``scale`` (d,).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (bf16, d % 8 == 0) or raises."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    KERNEL.load()
    build.check_cuda_tensors("rmsnorm", x, scale)
    d = x.shape[-1]
    if scale.shape != (d,) or d % 8:
        raise ValueError(f"rmsnorm: x (..., {d}) with d % 8 == 0 and scale ({d},) "
                         f"required, got scale {tuple(scale.shape)}")
    out = torch.empty_like(x)
    KERNEL.launch(x.device, x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                  x.numel() // d, d, eps)
    return out
