"""K3 RoPE: the hand-written CUDA kernel and its plain PyTorch version.

Replaces the XLA-fused ``rope`` of the JAX package's
``workloads/llama.py``, which the layer calls once for q and once for k;
here one call (one launch) rotates both.  The kernel is ``csrc/rope.cu``.
Positions are ``arange(S)`` on every row, as the JAX forward builds them.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

KERNEL = build.Kernel("rope", "ktpu_rope_bf16", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, qo, ko
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, S, H, Hkv, hd
    ctypes.c_float,                                                      # theta
    ctypes.c_void_p,                                                     # stream
])


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def rope_plain(q: torch.Tensor, k: torch.Tensor,
               theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Half-split rotary embedding in f32 (``jnp.split(x, 2)``: the first
    and second halves of the head, not even/odd lanes), cast back."""
    S, hd = q.shape[1], q.shape[-1]
    freqs = theta ** (-torch.arange(0, hd // 2, dtype=torch.float32,
                                    device=q.device) / (hd // 2))
    ang = torch.arange(S, dtype=torch.float32, device=q.device)[:, None] * freqs
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    return _rotate(q, cos, sin), _rotate(k, cos, sin)


def rope(q: torch.Tensor, k: torch.Tensor,
         theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate q (B, S, H, hd) and k (B, S, Hkv, hd) at positions arange(S).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (bf16, hd % 4 == 0, both in one launch) or raises."""
    if q.device.type == "cpu":
        return rope_plain(q, k, theta)
    KERNEL.load()
    build.check_cuda_tensors("rope", q, k)
    B, S, H, hd = q.shape
    if k.dim() != 4 or k.shape[:2] != (B, S) or k.shape[3] != hd or hd % 4:
        raise ValueError(f"rope: q (B, S, H, hd) and k (B, S, Hkv, hd) with hd % 4 == 0 "
                         f"required, got {tuple(q.shape)} and {tuple(k.shape)}")
    qo, ko = torch.empty_like(q), torch.empty_like(k)
    KERNEL.launch(q.device, q.data_ptr(), k.data_ptr(), qo.data_ptr(), ko.data_ptr(),
                  B, S, H, k.shape[2], hd, theta)
    return qo, ko
