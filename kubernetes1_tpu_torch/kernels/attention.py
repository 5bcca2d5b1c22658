"""K1 causal GQA attention and K7a non-causal attention: the hand-written
CUDA kernels (forward and backward) and their plain PyTorch versions.

Replaces ``jax.nn.dot_product_attention(q, k, v, is_causal=True)`` in the
JAX package's ``workloads/llama.py`` ``attention`` (``causal=True``, the
default) and ``jax.nn.dot_product_attention(q, k, v)`` in its
``workloads/bert.py`` ``layer_fn`` (``causal=False``); one pair of kernels
in ``csrc/attention.cu`` serves both.  Layouts are JAX's: q (B, S, H, hd),
k and v (B, S, Hkv, hd), and query head n reads kv head n // (H // Hkv).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import build

_FWD_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, v, o
    ctypes.c_void_p,                                                     # lse or null
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, S, H, Hkv, hd
    ctypes.c_float, ctypes.c_int,                                        # scale, causal
    ctypes.c_void_p,                                                     # stream
]
_BWD_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,                   # q, k, v
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,                   # o, dout, lse
    ctypes.c_void_p,                                                     # delta (scratch)
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,                   # dq, dk, dv
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, S, H, Hkv, hd
    ctypes.c_float, ctypes.c_int,                                        # scale, causal
    ctypes.c_void_p,                                                     # stream
]
# One entry point per direction; the causal (K1) and non-causal (K7a)
# launches are counted apart.
KERNEL = build.Kernel("attention", "ktpu_attention_fwd_bf16", _FWD_ARGS)
KERNEL_BWD = build.Kernel("attention", "ktpu_attention_bwd_bf16", _BWD_ARGS)
KERNEL_NC = build.Kernel("attention", "ktpu_attention_fwd_bf16", _FWD_ARGS)
KERNEL_BWD_NC = build.Kernel("attention", "ktpu_attention_bwd_bf16", _BWD_ARGS)
HEAD_DIMS = (16, 32, 64, 128)  # the kernels' instantiations
MASK_VALUE = -0.7 * torch.finfo(torch.float32).max  # JAX's causal mask value


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """hd^-0.5 * Q K^T in f32, with the causal mask where ``causal``,
    (B, Hkv, G, S, S)."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, H // Hkv, hd)
    logits = torch.einsum("btkgh,bskh->bkgts", qg.float(), k.float())
    logits = logits * (1.0 / math.sqrt(hd))
    if not causal:
        return logits
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    return logits.masked_fill(~mask, MASK_VALUE)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """JAX's ``_dot_product_attention_core``, step for step: QK^T with f32
    accumulation, times hd^-0.5 in f32, the causal mask where ``causal``
    (JAX's large negative, not -inf), f32 softmax, probabilities cast to
    v's dtype, then P.V."""
    B, S, H, hd = q.shape
    probs = torch.softmax(_scores(q, k, causal), dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskh->btkgh", probs.float(), v.float())
    return out.to(q.dtype).reshape(B, S, H, hd)


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """The f32 log-sum-exp of each row's scaled scores, (B, H, S): what
    the forward kernel hands its backward."""
    B, S, H, _hd = q.shape
    return torch.logsumexp(_scores(q, k, causal), dim=-1).reshape(B, H, S)


def delta_plain(o: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO * O) in f32, (B, H, S): the backward's first pass."""
    return (dout.float() * o.float()).sum(-1).transpose(1, 2)


def _probs(q, k, lse, causal: bool) -> torch.Tensor:
    """P = exp(scores - lse) in f32, recomputed from the forward's lse,
    (B, Hkv, G, S, S); masked entries are 0."""
    B, S, H, _hd = q.shape
    Hkv = k.shape[2]
    return _scores(q, k, causal).sub_(lse.reshape(B, Hkv, H // Hkv, S, 1)).exp_()


def _ds(p, q, v, dout, delta) -> torch.Tensor:
    """dS = P * (dO V^T - D), rounded to q's dtype as the kernels round it
    for their products, returned in f32."""
    B, S, H, hd = q.shape
    Hkv = v.shape[2]
    d5 = dout.reshape(B, S, Hkv, H // Hkv, hd).float()
    ds = torch.einsum("btkgh,bskh->bkgts", d5, v.float())
    return ds.sub_(delta.reshape(B, Hkv, H // Hkv, S, 1)).mul_(p).to(q.dtype).float()


def attention_bwd_dkdv_plain(q, k, v, dout, lse, delta, causal: bool = True
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward's dK/dV pass: with P from the lse and D = rowsum(dO *
    O), dV = P^T dO (P rounded to q's dtype) and dK = scale * dS^T Q, each
    summed over the query heads of its kv head.  f32 (dk, dv), like k."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    G, scale = H // Hkv, 1.0 / math.sqrt(hd)
    p = _probs(q, k, lse, causal)
    d5 = dout.reshape(B, S, Hkv, G, hd).float()
    dv = torch.einsum("bkgts,btkgh->bskh", p.to(q.dtype).float(), d5)
    ds = _ds(p, q, v, dout, delta)
    del p
    dk = torch.einsum("bkgts,btkgh->bskh", ds, q.reshape(B, S, Hkv, G, hd).float()) * scale
    return dk, dv


def attention_bwd_dq_plain(q, k, v, dout, lse, delta, causal: bool = True) -> torch.Tensor:
    """The backward's dQ pass: dQ = scale * dS K with dS = P * (dO V^T - D)
    rounded to q's dtype.  f32, like q."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    ds = _ds(_probs(q, k, lse, causal), q, v, dout, delta)
    dq = torch.einsum("bkgts,bskh->btkgh", ds, k.float()) * (1.0 / math.sqrt(hd))
    return dq.reshape(B, S, H, hd)


def attention_bwd_plain(q, k, v, o, lse, dout, causal: bool = True) -> Tuple[torch.Tensor, ...]:
    """The backward the kernels compute: D = rowsum(dO * O), then the
    dK/dV pass and the dQ pass, in f32, rounding where the kernels do.
    Returns (dq, dk, dv) in q's dtype."""
    delta = delta_plain(o, dout)
    dk, dv = attention_bwd_dkdv_plain(q, k, v, dout, lse, delta, causal)
    dq = attention_bwd_dq_plain(q, k, v, dout, lse, delta, causal)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _check(q, k, v):
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    if (k.shape != v.shape or k.dim() != 4 or k.shape[:2] != (B, S)
            or k.shape[3] != hd or H % Hkv or hd not in HEAD_DIMS):
        raise ValueError(f"attention: q (B, S, H, hd), k = v (B, S, Hkv, hd), H % Hkv == 0, "
                         f"hd in {HEAD_DIMS}; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")


def attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     with_lse: bool = False, causal: bool = True,
                     kernel: Optional[build.Kernel] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One launch of the forward kernel: (o, lse (B, H, S) f32 or None).
    ``kernel``: the counter the launch goes to (ring attention's blocks
    count apart); by default K1's or K7a's."""
    kernel = kernel or (KERNEL if causal else KERNEL_NC)
    kernel.load()
    build.check_cuda_tensors("attention", q, k, v)
    _check(q, k, v)
    B, S, H, hd = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), device=q.device, dtype=torch.float32) if with_lse else None
    kernel.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  lse.data_ptr() if with_lse else None, B, S, H, k.shape[2], hd,
                  1.0 / math.sqrt(hd), int(causal))
    return o, lse


def attention_bwd_kernel(q, k, v, o, lse, dout, causal: bool = True) -> Tuple[torch.Tensor, ...]:
    """One call of the backward entry point (three launches inside it:
    D, the dK/dV pass, the dQ pass; no atomics, so the result is the same
    on every run): (dq, dk, dv)."""
    kernel = KERNEL_BWD if causal else KERNEL_BWD_NC
    kernel.load()
    build.check_cuda_tensors("attention backward", q, k, v, o, dout)
    build.check_cuda_tensors("attention backward", lse, dtype=torch.float32)
    _check(q, k, v)
    B, S, H, hd = q.shape
    if o.shape != q.shape or dout.shape != q.shape or lse.shape != (B, H, S):
        raise ValueError(f"attention backward: o, dout like q {tuple(q.shape)} and lse "
                         f"{(B, H, S)} required")
    delta = torch.empty((B, H, S), device=q.device, dtype=torch.float32)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    kernel.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                  dk.data_ptr(), dv.data_ptr(), B, S, H, k.shape[2], hd,
                  1.0 / math.sqrt(hd), int(causal))
    return dq, dk, dv


def kernel_info(hd: int) -> dict:
    """The launch shape of the forward and the two backward passes at head
    dim ``hd`` (builds the library): {name: (dynamic shared memory bytes,
    threads a block, registers a consumer thread after setmaxnreg)}."""
    fn = build.load_library("attention").ktpu_attention_kernel_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
    out = {}
    for which, name in enumerate(("forward", "dK/dV pass", "dQ pass")):
        vals = [ctypes.c_int() for _ in range(3)]
        if fn(which, hd, *(ctypes.byref(x) for x in vals)):
            raise ValueError(f"attention kernel_info: hd {hd} not in {HEAD_DIMS}")
        out[name] = tuple(x.value for x in vals)
    return out


class _AttentionFn(torch.autograd.Function):
    """The forward kernel, keeping q, k, v, o and the lse for the backward
    kernel (Llama's ``save_attn`` policy keeps them across the remat
    boundary; BERT's full remat runs the forward again in backward)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = attention_kernel(q, k, v, with_lse=True, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        return (*attention_bwd_kernel(q, k, v, o, lse, dout.contiguous(), ctx.causal), None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True) -> torch.Tensor:
    """GQA attention, scale hd^-0.5, causal (Llama) unless ``causal=False``
    (BERT's bidirectional encoder).

    A CPU tensor takes the plain version (autograd differentiates it); a
    CUDA tensor launches the kernel (bf16, hd in HEAD_DIMS) or raises, and
    where a gradient is wanted, the backward kernel differentiates it."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal)
    return attention_on_kernels(q, k, v, causal)


def attention_on_kernels(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """The wrapper's kernel path: the forward kernel alone, or, where a
    gradient is wanted, the autograd Function over both kernels."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _AttentionFn.apply(q, k, v, causal)
    return attention_kernel(q, k, v, causal=causal)[0]
