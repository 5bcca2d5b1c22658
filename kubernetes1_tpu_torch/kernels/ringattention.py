"""K6 ring attention's block, merge and block-backward: the hand-written
CUDA kernels and their plain PyTorch versions.

Replaces the JAX package's ``workloads/ringattention.py`` ``_block_attn``
(one (q block, kv block) tile at global offsets), ``_merge`` (the
online-softmax fold) and the normalise-and-cast after its ring loop, plus
what ``jax.grad`` derives from them.  The port keeps each partial in the
lse form: a normalised ``o`` (in q's dtype) with its row log-sum-exp
``lse`` (B, H, S) f32.  JAX's ``(o unnormalised, m, l)`` is the same
function: ``o_norm = o / l`` and ``lse = m + log l``.  Layouts are JAX's:
q (B, Sq, H, hd), k and v (B, Sk, Hkv, hd), query head n reading kv head
n // (H // Hkv) (by index: K and V are not repeated).

The ring pairs equal, aligned blocks only, so a block on the card takes
one of three forms: the diagonal (causal within the block), a block wholly
behind the queries (every key counts), or one wholly ahead, which the ring
skips.  ``ring_block`` launches K1's forward (``csrc/attention.cu``,
``causal`` 1) for the first and K7a's (``causal`` 0) for the second, with
the lse, through counters of its own; ``ring_merge`` is ``csrc/ring_merge.cu``;
``ring_block_bwd`` is the accumulating mode of K1/K7a's two backward passes
(``ktpu_ring_block_bwd_bf16``).  The plain versions take any offsets and
dtypes.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import attention, build

NEG_INF = -1e30  # JAX's mask value in ringattention.py

_MERGE_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # o_acc, lse_acc, o_blk, lse_blk
    ctypes.c_void_p, ctypes.c_void_p,                                    # lse_out, out or null
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,              # B, S, H, hd
    ctypes.c_void_p,                                                     # stream
]
_BWD_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,                   # q, k, v
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,                   # o or null, dout, lse
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # delta, dq, dk, dv (f32)
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, S, H, Hkv, hd
    ctypes.c_float, ctypes.c_int,                                        # scale, causal
    ctypes.c_void_p,                                                     # stream
]
# The diagonal and the unmasked blocks count apart, forward and backward.
RING_BLOCK = build.Kernel("attention", "ktpu_attention_fwd_bf16", attention._FWD_ARGS)
RING_BLOCK_NC = build.Kernel("attention", "ktpu_attention_fwd_bf16", attention._FWD_ARGS)
RING_MERGE = build.Kernel("ring_merge", "ktpu_ring_merge", _MERGE_ARGS)
RING_BLOCK_BWD = build.Kernel("attention", "ktpu_ring_block_bwd_bf16", _BWD_ARGS)
RING_BLOCK_BWD_NC = build.Kernel("attention", "ktpu_ring_block_bwd_bf16", _BWD_ARGS)


# ------------------------------------------------------------------ plain


def block_attn_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_off: int, kv_off: int,
                     causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_block_attn`` at any offsets, in the lse form: (o in q's dtype,
    lse (B, H, Sq) f32).  f32 scores times hd^-0.5; where ``causal``, key
    kv_off + j hidden from query q_off + i unless q_off + i >= kv_off + j
    (JAX's NEG_INF); p rounded to q's dtype before P.V, summed in f32,
    divided by the f32 row sum and rounded once.  A row with every key
    hidden gives o = 0 and lse = -inf (JAX's m_safe guard: l = 0)."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    logits = torch.einsum("bqkgd,bskd->bkgqs", q.reshape(B, Sq, Hkv, G, hd).float(), k.float())
    logits.mul_(hd ** -0.5)
    if causal:
        qi = q_off + torch.arange(Sq, device=q.device)[:, None]
        ki = kv_off + torch.arange(Sk, device=q.device)[None, :]
        logits.masked_fill_(qi < ki, NEG_INF)
    m = logits.amax(-1)
    m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
    dead = logits <= NEG_INF / 2
    p = logits.sub_(m_safe[..., None]).exp_().masked_fill_(dead, 0.0)
    del dead
    l = p.sum(-1)                                                        # (B, Hkv, G, Sq)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(q.dtype).float(), v.float())
    del p
    o = o / torch.where(l > 0, l, 1.0).permute(0, 3, 1, 2)[..., None]
    lse = m_safe + torch.log(l)                                          # -inf where l == 0
    return o.reshape(B, Sq, H, hd).to(q.dtype), lse.reshape(B, H, Sq)


def merge_plain(o_a: torch.Tensor, lse_a: torch.Tensor, o_n: torch.Tensor,
                lse_n: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_merge`` in the lse form, in f32: fold partial n into the
    accumulator a.  Rows with both lse at -inf stay o = 0, lse = -inf."""
    mx = torch.maximum(lse_a, lse_n)
    dead = mx == -math.inf
    mx = torch.where(dead, 0.0, mx)
    lse = mx + torch.log(torch.exp(lse_a - mx) + torch.exp(lse_n - mx))
    wa = torch.where(dead, 0.0, torch.exp(lse_a - lse)).transpose(1, 2)[..., None]
    wb = torch.where(dead, 0.0, torch.exp(lse_n - lse)).transpose(1, 2)[..., None]
    return o_a.float() * wa + o_n.float() * wb, lse


def merge_op_plain(o_acc, lse_acc, o_blk, lse_blk, final: bool = False):
    """``merge_plain`` with ``ring_merge``'s contract: the last merge
    (``final``) returns o rounded to the block's dtype."""
    o, lse = merge_plain(o_acc, lse_acc, o_blk, lse_blk)
    return (o.to(o_blk.dtype) if final else o), lse


delta_plain = attention.delta_plain  # D = rowsum(dO * O) in f32, (B, H, S)


def block_bwd_plain(q, k, v, dout, lse, delta, causal: bool) -> Tuple[torch.Tensor, ...]:
    """The gradient of one (q block, kv block) pair of equal length given
    the ring's FINAL lse and delta = rowsum(dO * O) of its final output,
    as the kernels compute it: the two passes of the attention backward
    (``attention.attention_bwd_dq_plain``, ``attention_bwd_dkdv_plain``;
    P rounded to q's dtype for dV, dS rounded for dK and dQ).  ``causal``:
    the diagonal block (key <= query within it); else every key.  Returns
    f32 partials (dq, dk, dv), dK and dV summed per kv head."""
    dq = attention.attention_bwd_dq_plain(q, k, v, dout, lse, delta, causal)
    return (dq, *attention.attention_bwd_dkdv_plain(q, k, v, dout, lse, delta, causal))


def block_bwd_dkdv_op_plain(q, k, v, dout, lse, delta, causal, dk, dv):
    """The dK/dV pass in the accumulating mode: add the block's f32 dk, dv
    into the kv block's buffers in place."""
    for acc, part in zip((dk, dv), attention.attention_bwd_dkdv_plain(q, k, v, dout, lse, delta,
                                                                      causal)):
        acc.add_(part)


def block_bwd_dq_op_plain(q, k, v, dout, lse, delta, causal, dq):
    """The dQ pass in the accumulating mode: add the block's f32 dq into
    the q block's buffer in place."""
    dq.add_(attention.attention_bwd_dq_plain(q, k, v, dout, lse, delta, causal))


def block_bwd_op_plain(q, k, v, dout, lse, delta, causal, dq, dk, dv, o=None):
    """``ring_block_bwd``'s contract on the plain versions: fill ``delta``
    from ``o`` first when it is given; then both passes add their partials
    into the f32 buffers dq, dk, dv in place."""
    if o is not None:
        delta.copy_(delta_plain(o, dout))
    block_bwd_dkdv_op_plain(q, k, v, dout, lse, delta, causal, dk, dv)
    block_bwd_dq_op_plain(q, k, v, dout, lse, delta, causal, dq)


# ----------------------------------------------------------------- kernels


def ring_block_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_off: int, kv_off: int,
                      causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the block forward: K1's kernel on the diagonal, K7a's
    on a block wholly behind the queries (or any block, non-causal).
    Raises on blocks of unequal length and on any other offsets."""
    Sb = q.shape[1]
    if k.shape[1] != Sb:
        raise ValueError(f"ring_block: q and k/v blocks of one length, got {Sb} and {k.shape[1]}")
    diagonal = causal and q_off == kv_off
    if causal and not diagonal and kv_off + Sb > q_off:
        raise ValueError(f"ring_block: the kernel takes the diagonal block or one wholly behind "
                         f"the queries; got q_off {q_off}, kv_off {kv_off}, block {Sb}")
    return attention.attention_kernel(q, k, v, with_lse=True, causal=diagonal,
                                      kernel=RING_BLOCK if diagonal else RING_BLOCK_NC)


def ring_merge_kernel(o_acc: torch.Tensor, lse_acc: torch.Tensor, o_blk: torch.Tensor,
                      lse_blk: torch.Tensor, final: bool = False):
    """One launch of the merge: o_acc updated in place (returned), or, when
    ``final``, a new bf16 output; the new lse in a new buffer."""
    RING_MERGE.load()
    build.check_cuda_tensors("ring_merge", o_blk)
    build.check_cuda_tensors("ring_merge", o_acc, lse_acc, lse_blk, dtype=torch.float32)
    B, S, H, hd = o_blk.shape
    if o_acc.shape != o_blk.shape or lse_acc.shape != (B, H, S) or lse_blk.shape != (B, H, S) \
            or hd % 8:
        raise ValueError(f"ring_merge: o (B, S, H, hd) with hd % 8 == 0 and lse (B, H, S); got "
                         f"{tuple(o_acc.shape)}, {tuple(lse_acc.shape)}, {tuple(o_blk.shape)}, "
                         f"{tuple(lse_blk.shape)}")
    lse = torch.empty_like(lse_acc)
    out = torch.empty_like(o_blk) if final else o_acc
    RING_MERGE.launch(o_blk.device, o_acc.data_ptr(), lse_acc.data_ptr(), o_blk.data_ptr(),
                      lse_blk.data_ptr(), lse.data_ptr(), out.data_ptr() if final else None,
                      B, S, H, hd)
    return out, lse


def ring_block_bwd_kernel(q, k, v, dout, lse, delta, causal: bool, dq, dk, dv, o=None):
    """One call of the accumulating backward entry: the dK/dV pass and the
    dQ pass (two launches; three when ``o`` is given and delta is computed
    first), each gradient element added by the one block that owns it."""
    kernel = RING_BLOCK_BWD if causal else RING_BLOCK_BWD_NC
    kernel.load()
    build.check_cuda_tensors("ring_block_bwd", q, k, v, dout, *(() if o is None else (o,)))
    build.check_cuda_tensors("ring_block_bwd", lse, delta, dq, dk, dv, dtype=torch.float32)
    attention._check(q, k, v)
    B, S, H, hd = q.shape
    if (dout.shape != q.shape or dq.shape != q.shape or dk.shape != k.shape
            or dv.shape != k.shape or lse.shape != (B, H, S) or delta.shape != (B, H, S)
            or (o is not None and o.shape != q.shape)):
        raise ValueError("ring_block_bwd: dout, o, dq like q, dk and dv like k, lse and delta "
                         f"{(B, H, S)} required")
    kernel.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  None if o is None else o.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                  delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  B, S, H, k.shape[2], hd, 1.0 / math.sqrt(hd), int(causal))


# ---------------------------------------------------------------- wrappers
#
# A CPU tensor takes the plain version; a CUDA tensor launches the kernel
# (bf16, hd in attention.HEAD_DIMS) or raises.


def ring_block(q, k, v, q_off: int, kv_off: int, causal: bool):
    """One block's (o, lse); see ``block_attn_plain``."""
    if q.device.type == "cpu":
        return block_attn_plain(q, k, v, q_off, kv_off, causal)
    return ring_block_kernel(q, k, v, q_off, kv_off, causal)


def ring_merge(o_acc, lse_acc, o_blk, lse_blk, final: bool = False):
    """Fold a block's (o, lse) into the f32 accumulator: (o, lse), o in
    the block's dtype when ``final``.  The accumulator's buffers may be
    reused: the caller keeps only what this returns."""
    if o_acc.device.type == "cpu":
        return merge_op_plain(o_acc, lse_acc, o_blk, lse_blk, final)
    return ring_merge_kernel(o_acc, lse_acc, o_blk, lse_blk, final)


def ring_block_bwd(q, k, v, dout, lse, delta, causal: bool, dq, dk, dv,
                   o: Optional[torch.Tensor] = None):
    """Add one block's gradients into the f32 buffers dq, dk, dv (dq
    scaled, as dk); fill ``delta`` from ``o`` first when it is given."""
    if q.device.type == "cpu":
        return block_bwd_op_plain(q, k, v, dout, lse, delta, causal, dq, dk, dv, o)
    return ring_block_bwd_kernel(q, k, v, dout, lse, delta, causal, dq, dk, dv, o)
