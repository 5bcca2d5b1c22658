"""Ring attention: sequence (context) parallelism over a ``DeviceMesh`` axis.

The counterpart of the JAX package's ``workloads/ringattention.py``.  A
sequence too long for one card is split along its length: each rank holds
one block of Q, K and V, the K/V blocks travel around the ring by
``torch.distributed`` point-to-point transfers (``batch_isend_irecv`` on
the axis' group: NCCL between cards, gloo on the CPU), and a running
online-softmax accumulator folds each block in, so the full S x S
attention is computed from S/n-sized tiles with no all-gather.

The JAX function takes global arrays that ``shard_map`` splits.  The port
is SPMD per rank: every rank of the axis calls ``ring_attention`` with its
own block (B, S/n, H, hd) of q and (B, S/n, Hkv, hd) of k and v, rank r
holding positions [r * S/n, (r + 1) * S/n), and gets its block of the
output back; a backward pass, too, is entered by every rank.

Causal masking per (q block, kv block) pair from the blocks' offsets, as
in JAX: a kv block behind the queries counts whole, the same block
counts its lower triangle, a block ahead contributes nothing and is
skipped (JAX computes it and discards it).  The partials are in the lse
form (``kernels/ringattention.py``); GQA is by index, so K and V travel
at Hkv heads, not repeated to H as JAX's ``jnp.repeat`` does.

The step bodies, ``fold_step`` (forward) and ``grad_step`` (backward),
are the whole per-rank computation; ``ring_attention`` adds only the
transfers, and ``lockstep_forward`` / ``lockstep_backward`` run the same
steps for n virtual ranks on one device, the transfers replaced by
handing the blocks over, which is how one card measures a ring.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Sequence, Tuple

import torch
import torch.distributed as dist

from ..kernels import ringattention as _ring


class Ops(NamedTuple):
    """The kernel-backed ops of the ring: a block's (o, lse), the merge,
    and a block's backward that adds into f32 buffers."""

    block: Callable
    merge: Callable
    block_bwd: Callable


# The wrappers: the kernels on CUDA tensors, the plain versions on CPU ones.
KERNELS = Ops(_ring.ring_block, _ring.ring_merge, _ring.ring_block_bwd)
# The plain versions on every device: the ring that chip_smoke.py holds the
# kernels' lockstep ring to on the card.
PLAIN = Ops(_ring.block_attn_plain, _ring.merge_op_plain, _ring.block_bwd_op_plain)


def _src(r: int, s: int, n: int) -> int:
    """The kv block rank r holds at step s: it came from rank (r - s) mod n."""
    return (r - s) % n


def _folds(r: int, src: int, causal: bool) -> bool:
    return not (causal and src > r)


def fold_step(ops: Ops, q, k, v, r: int, s: int, n: int, causal: bool, acc):
    """Rank r's forward step s: fold the kv block it holds into ``acc``,
    (o, lse), or None before the first block.  The first block's output is
    the accumulator as it stands; each later one is merged in f32, the
    last merge rounding to q's dtype.  Returns the accumulator."""
    src = _src(r, s, n)
    if not _folds(r, src, causal):
        return acc
    sb = q.shape[1]
    o, lse = ops.block(q, k, v, r * sb, src * sb, causal)
    if acc is None:
        return o, lse
    final = s == n - 1 or (causal and src == 0)  # the last block this rank folds
    return ops.merge(acc[0].float(), acc[1], o, lse, final)


def grad_step(ops: Ops, q, k, v, dout, o, lse, delta, r: int, s: int, n: int, causal: bool,
              dq, dk, dv):
    """Rank r's backward step s: add the gradients of the pair (its q
    block, the kv block it holds) into dq (its own, f32) and dk, dv (the
    kv block's f32 accumulators).  Step 0 (its own block, which always
    folds) also fills ``delta`` from the output."""
    src = _src(r, s, n)
    if _folds(r, src, causal):
        ops.block_bwd(q, k, v, dout, lse, delta, causal and src == r, dq, dk, dv,
                      o if s == 0 else None)


def _check(q, k, v):
    if k.shape != v.shape or k.dim() != 4 or k.shape[:2] != q.shape[:2] or \
            k.shape[3] != q.shape[3] or q.shape[2] % k.shape[2]:
        raise ValueError(f"ring_attention: q (B, Sb, H, hd), k = v (B, Sb, Hkv, hd), H % Hkv "
                         f"== 0; got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")


# ------------------------------------------------------------ over ranks


class _Buffers:
    """One rank's packed ring buffer: K and V (bf16 on the card) and, in
    backward, their f32 gradient accumulators, contiguous in one byte
    buffer so one transfer a step moves a block."""

    def __init__(self, like_kv: torch.Tensor, grads: bool):
        self.shape, self.dtype = like_kv.shape, like_kv.dtype
        self.kv_bytes = 2 * like_kv.numel() * like_kv.element_size()
        self.g_bytes = 2 * like_kv.numel() * 4 if grads else 0
        self.raw = torch.empty(self.kv_bytes + self.g_bytes, dtype=torch.uint8,
                               device=like_kv.device)

    def _view(self, start: int, nbytes: int, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        half = nbytes // 2
        return tuple(self.raw[start + i * half:start + (i + 1) * half].view(dtype).view(self.shape)
                     for i in range(2))

    def kv(self):
        return self._view(0, self.kv_bytes, self.dtype)

    def grads(self):
        return self._view(self.kv_bytes, self.g_bytes, torch.float32)


class _Ring:
    """The axis' group and this rank's neighbours on it."""

    def __init__(self, group):
        self.group = group
        self.n, self.r = dist.get_world_size(group), dist.get_rank(group)
        self.next = dist.get_global_rank(group, (self.r + 1) % self.n)
        self.prev = dist.get_global_rank(group, (self.r - 1) % self.n)

    def exchange(self, send: torch.Tensor, recv: torch.Tensor, tag: int):
        """Post send -> rank r+1 and recv <- rank r-1; returns the works.
        On the card the transfer waits on the current stream, so it comes
        after whatever produced ``send``."""
        return dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, self.next, self.group, tag),
            dist.P2POp(dist.irecv, recv, self.prev, self.group, tag)])


def _wait(works):
    for w in works:
        w.wait()


class _RingFn(torch.autograd.Function):
    """The whole ring, forward and backward, on one rank."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, ops):
        ring = _Ring(group)
        n, r = ring.n, ring.r
        cur = _Buffers(k, grads=False)
        for dst, src in zip(cur.kv(), (k, v)):
            dst.copy_(src)
        nxt = _Buffers(k, grads=False) if n > 1 else None
        acc = None
        for s in range(n):
            # post the hand-over of this block before its compute (n - 1
            # transfers: the block that would come back home is not sent)
            works = ring.exchange(cur.raw, nxt.raw, 0) if s < n - 1 else []
            acc = fold_step(ops, q, *cur.kv(), r, s, n, causal, acc)
            _wait(works)
            if works:
                cur, nxt = nxt, cur
        o, lse = acc
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group, ctx.causal, ctx.ops = group, causal, ops
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        ops, causal = ctx.ops, ctx.causal
        ring = _Ring(ctx.group)
        n, r = ring.n, ring.r
        dout = dout.contiguous()
        delta = torch.empty_like(lse)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        cur = _Buffers(k, grads=True)
        for dst, src in zip(cur.kv(), (k, v)):
            dst.copy_(src)
        for g in cur.grads():
            g.zero_()
        nxt = _Buffers(k, grads=True) if n > 1 else None
        for s in range(n):
            # K and V leave before the compute (n - 1 transfers); the
            # gradient accumulators after it, n times, so that after the
            # last one each rank holds its own block's dK and dV
            works = ring.exchange(cur.raw[:cur.kv_bytes], nxt.raw[:nxt.kv_bytes], 0) \
                if s < n - 1 else []
            grad_step(ops, q, *cur.kv(), dout, o, lse, delta, r, s, n, causal, dq, *cur.grads())
            if n > 1:
                works += ring.exchange(cur.raw[cur.kv_bytes:], nxt.raw[nxt.kv_bytes:], 1)
                _wait(works)
                cur, nxt = nxt, cur
        dk, dv = cur.grads()
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, axis: str = "sp",
                   causal: bool = True) -> torch.Tensor:
    """This rank's block of attention over the whole ring.

    q (B, Sb, H, hd), k and v (B, Sb, Hkv, hd) are this rank's blocks of a
    sequence of n * Sb positions, n the size of ``mesh``'s dimension
    ``axis`` (a ``torch.distributed.device_mesh.DeviceMesh``); the result
    is the output's block (B, Sb, H, hd).  GQA: H % Hkv == 0.  Every rank
    of the axis must call it (and its backward), with blocks of one shape.
    CUDA tensors run the kernels (bf16, hd in 16, 32, 64, 128) or raise;
    CPU tensors run the plain versions in any dtype."""
    _check(q, k, v)
    return _RingFn.apply(q.contiguous(), k.contiguous(), v.contiguous(), mesh.get_group(axis),
                         causal, KERNELS)


# ------------------------------------------------------ n ranks, one device


def lockstep_forward(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                     vs: Sequence[torch.Tensor], causal: bool = True,
                     ops: Ops = KERNELS) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The ring's forward for n = len(qs) virtual ranks on one device:
    every rank's ``fold_step`` at each step, the kv block of rank
    (r - s) mod n handed over in place of the transfer.  Returns each
    rank's (o, lse), as ``ring_attention``'s forward computes them."""
    n = len(qs)
    accs = [None] * n
    for s in range(n):
        for r in range(n):
            src = _src(r, s, n)
            accs[r] = fold_step(ops, qs[r], ks[src], vs[src], r, s, n, causal, accs[r])
    return [a[0] for a in accs], [a[1] for a in accs]


def lockstep_backward(qs, ks, vs, os_, lses, douts, causal: bool = True,
                      ops: Ops = KERNELS) -> Tuple[List[torch.Tensor], ...]:
    """The ring's backward for n virtual ranks on one device, given each
    rank's output and lse from ``lockstep_forward``: every rank's
    ``grad_step`` at each step, block src's dK/dV accumulators handed from
    rank to rank as they travel in the ring.  Returns (dqs, dks, dvs) in
    the inputs' dtype."""
    n = len(qs)
    f32 = dict(dtype=torch.float32, device=qs[0].device)
    deltas = [torch.empty_like(lse) for lse in lses]
    dqs = [torch.zeros(q.shape, **f32) for q in qs]
    dks = [torch.zeros(k.shape, **f32) for k in ks]
    dvs = [torch.zeros(k.shape, **f32) for k in ks]
    for s in range(n):
        for r in range(n):
            src = _src(r, s, n)
            grad_step(ops, qs[r], ks[src], vs[src], douts[r], os_[r], lses[r], deltas[r], r, s, n,
                      causal, dqs[r], dks[src], dvs[src])
    return ([g.to(qs[0].dtype) for g in dqs], [g.to(ks[0].dtype) for g in dks],
            [g.to(vs[0].dtype) for g in dvs])


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Dense single-device attention for correctness checks (JAX's
    ``reference_attention``: f32 scores, the causal mask at JAX's NEG_INF,
    f32 softmax, probabilities in q's dtype)."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    k, v = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd ** -0.5
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, _ring.NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(q.dtype)
