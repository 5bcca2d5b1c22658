"""K1 causal GQA attention: the hand-written CUDA kernel and its plain
PyTorch version.

Replaces ``jax.nn.dot_product_attention(q, k, v, is_causal=True)`` in the
JAX package's ``workloads/llama.py`` ``attention``; the kernel is
``csrc/attention.cu``.  Layouts are JAX's: q (B, S, H, hd), k and v
(B, S, Hkv, hd), and query head n reads kv head n // (H // Hkv).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build

KERNEL = build.Kernel("attention", "ktpu_attention_fwd_bf16", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, v, o
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, S, H, Hkv, hd
    ctypes.c_float,                                                      # scale
    ctypes.c_void_p,                                                     # stream
])
HEAD_DIMS = (16, 32, 64, 128)  # the kernel's instantiations


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """JAX's ``_dot_product_attention_core``, step for step: QK^T with f32
    accumulation, times hd^-0.5 in f32, causal mask (JAX's large negative,
    not -inf), f32 softmax, probabilities cast to v's dtype, then P.V."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, H // Hkv, hd)
    logits = torch.einsum("btkgh,bskh->bkgts", qg.float(), k.float())
    logits = logits * (1.0 / math.sqrt(hd))
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~causal, -0.7 * torch.finfo(torch.float32).max)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskh->btkgh", probs.float(), v.float())
    return out.to(q.dtype).reshape(B, S, H, hd)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal GQA attention, scale hd^-0.5.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (bf16, hd in HEAD_DIMS) or raises."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    KERNEL.load()
    build.check_cuda_tensors("attention", q, k, v)
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    if (k.shape != v.shape or k.dim() != 4 or k.shape[:2] != (B, S)
            or k.shape[3] != hd or H % Hkv or hd not in HEAD_DIMS):
        raise ValueError(f"attention: q (B, S, H, hd), k = v (B, S, Hkv, hd), H % Hkv == 0, "
                         f"hd in {HEAD_DIMS}; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    o = torch.empty_like(q)
    KERNEL.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  B, S, H, Hkv, hd, 1.0 / math.sqrt(hd))
    return o
