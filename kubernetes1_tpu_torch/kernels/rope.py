"""K3 RoPE: the hand-written CUDA kernel (forward and, with its direction
flag, backward) and its plain PyTorch versions.

Replaces the XLA-fused ``rope`` of the JAX package's
``workloads/llama.py``, which the layer calls once for q and once for k;
here one call (one launch) rotates both.  The kernel is ``csrc/rope.cu``.
Positions are ``arange(S)`` on every row, as the JAX forward builds them.
The VJP of the rotation is the rotation by -angle, applied to dq and dk.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

KERNEL = build.Kernel("rope", "ktpu_rope_bf16", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, qo, ko
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, S, H, Hkv, hd
    ctypes.c_float, ctypes.c_int,                                        # theta, inverse
    ctypes.c_void_p,                                                     # stream
])
# The backward is the same entry point with inverse=1; its launches are
# counted apart from the forward's.
KERNEL_BWD = build.Kernel("rope", "ktpu_rope_bf16", KERNEL.argtypes)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _table(S: int, hd: int, theta: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    freqs = theta ** (-torch.arange(0, hd // 2, dtype=torch.float32,
                                    device=device) / (hd // 2))
    ang = torch.arange(S, dtype=torch.float32, device=device)[:, None] * freqs
    return ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]


def rope_plain(q: torch.Tensor, k: torch.Tensor,
               theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Half-split rotary embedding in f32 (``jnp.split(x, 2)``: the first
    and second halves of the head, not even/odd lanes), cast back."""
    cos, sin = _table(q.shape[1], q.shape[-1], theta, q.device)
    return _rotate(q, cos, sin), _rotate(k, cos, sin)


def rope_bwd_plain(dq: torch.Tensor, dk: torch.Tensor,
                   theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The VJP of ``rope_plain``: the same rotation by -angle (cos, -sin),
    in f32, cast back; bit-equal to the kernel with inverse=1."""
    cos, sin = _table(dq.shape[1], dq.shape[-1], theta, dq.device)
    return _rotate(dq, cos, -sin), _rotate(dk, cos, -sin)


def rope_kernel(q: torch.Tensor, k: torch.Tensor, theta: float,
                inverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel, rotating by +angle, or by -angle (the
    backward, counted on KERNEL_BWD) when ``inverse``."""
    kern = KERNEL_BWD if inverse else KERNEL
    kern.load()
    build.check_cuda_tensors("rope", q, k)
    B, S, H, hd = q.shape
    if k.dim() != 4 or k.shape[:2] != (B, S) or k.shape[3] != hd or hd % 4:
        raise ValueError(f"rope: q (B, S, H, hd) and k (B, S, Hkv, hd) with hd % 4 == 0 "
                         f"required, got {tuple(q.shape)} and {tuple(k.shape)}")
    qo, ko = torch.empty_like(q), torch.empty_like(k)
    kern.launch(q.device, q.data_ptr(), k.data_ptr(), qo.data_ptr(), ko.data_ptr(),
                B, S, H, k.shape[2], hd, theta, int(inverse))
    return qo, ko


class _RoPEFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, theta):
        ctx.theta = theta
        return rope_kernel(q, k, theta)

    @staticmethod
    def backward(ctx, dqo, dko):
        dq, dk = rope_kernel(dqo.contiguous(), dko.contiguous(), ctx.theta, inverse=True)
        return dq, dk, None


def rope(q: torch.Tensor, k: torch.Tensor,
         theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate q (B, S, H, hd) and k (B, S, Hkv, hd) at positions arange(S).

    A CPU tensor takes the plain version (autograd differentiates it); a
    CUDA tensor launches the kernel (bf16, hd % 4 == 0, both in one
    launch) or raises, and the backward is the kernel with inverse=1."""
    if q.device.type == "cpu":
        return rope_plain(q, k, theta)
    return rope_on_kernels(q, k, theta)


def rope_on_kernels(q: torch.Tensor, k: torch.Tensor,
                    theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The wrapper's kernel path: the kernel alone, or, where a gradient
    is wanted, the autograd Function whose backward is the kernel with
    inverse=1."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad):
        return _RoPEFn.apply(q, k, theta)
    return rope_kernel(q, k, theta)
