"""K4 SwiGLU: the hand-written CUDA kernels (forward and backward) and
their plain PyTorch versions.

Replaces ``jax.nn.silu(h @ w_gate) * (h @ w_up)`` in the JAX package's
``workloads/llama.py`` ``layer_fn``: the elementwise part between the two
GEMMs (which stay ``torch.matmul``) and ``w_down``.  The kernels are in
``csrc/swiglu.cu``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import build

KERNEL = build.Kernel("swiglu", "ktpu_swiglu_fwd_bf16", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # g, u, y
    ctypes.c_longlong,                                  # n
    ctypes.c_void_p,                                    # stream
])
KERNEL_BWD = build.Kernel("swiglu", "ktpu_swiglu_bwd_bf16", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # g, u, dy
    ctypes.c_void_p, ctypes.c_void_p,                   # dg, du
    ctypes.c_longlong,                                  # n
    ctypes.c_void_p,                                    # stream
])


def swiglu_plain(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """silu(g) * u in g's dtype: silu rounds once, the product once."""
    return F.silu(g) * u


def swiglu_bwd_plain(g: torch.Tensor, u: torch.Tensor,
                     dy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward the kernel computes, in f32, rounding where the plain
    version's autograd rounds: du = dy * silu(g), ds = dy * u, and
    dg = ds * sig(g) * (1 + g * (1 - sig(g)))."""
    dt = g.dtype
    gf, dyf = g.float(), dy.float()
    s = (gf / (1 + torch.exp(-gf))).to(dt).float()
    ds = (dyf * u.float()).to(dt).float()
    sg = torch.sigmoid(gf)
    return (ds * (sg * (1 + gf * (1 - sg)))).to(dt), (dyf * s).to(dt)


def _check(g, u):
    if g.shape != u.shape or g.numel() % 8:
        raise ValueError(f"swiglu: g and u of one shape with numel % 8 == 0 required, "
                         f"got {tuple(g.shape)} and {tuple(u.shape)}")


def swiglu_kernel(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One launch of the forward kernel."""
    KERNEL.load()
    build.check_cuda_tensors("swiglu", g, u)
    _check(g, u)
    y = torch.empty_like(g)
    KERNEL.launch(g.device, g.data_ptr(), u.data_ptr(), y.data_ptr(), g.numel())
    return y


def swiglu_bwd_kernel(g: torch.Tensor, u: torch.Tensor,
                      dy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the backward kernel: (dg, du)."""
    KERNEL_BWD.load()
    build.check_cuda_tensors("swiglu backward", g, u, dy)
    _check(g, u)
    _check(g, dy)
    dg, du = torch.empty_like(g), torch.empty_like(u)
    KERNEL_BWD.launch(g.device, g.data_ptr(), u.data_ptr(), dy.data_ptr(), dg.data_ptr(),
                      du.data_ptr(), g.numel())
    return dg, du


class _SwiGLUFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, u):
        ctx.save_for_backward(g, u)
        return swiglu_kernel(g, u)

    @staticmethod
    def backward(ctx, dy):
        g, u = ctx.saved_tensors
        return swiglu_bwd_kernel(g, u, dy.contiguous())


def swiglu(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """silu(g) * u for the two GEMM outputs (..., d_ff).

    A CPU tensor takes the plain version (autograd differentiates it); a
    CUDA tensor launches the kernel (bf16, numel % 8 == 0) or raises."""
    if g.device.type == "cpu":
        return swiglu_plain(g, u)
    return swiglu_on_kernels(g, u)


def swiglu_on_kernels(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The wrapper's kernel path: the forward kernel alone, or, where a
    gradient is wanted, the autograd Function over both kernels."""
    if torch.is_grad_enabled() and (g.requires_grad or u.requires_grad):
        return _SwiGLUFn.apply(g, u)
    return swiglu_kernel(g, u)
