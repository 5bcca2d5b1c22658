"""K5 fused cross-entropy: the hand-written CUDA kernels (forward and
backward) and their plain PyTorch versions.

Replaces the ``log_softmax`` / ``take_along_axis`` of the JAX package's
``workloads/llama.py`` ``loss_fn`` over bf16 logits (rows, vocab), and of
its ``workloads/bert.py`` ``mlm_loss_fn`` over f32 logits: the kernels
never hold the log-softmax, nor (bf16) the logits or their gradient in
f32.  The mean (Llama) or the mask weighting (BERT) over rows stays a
torch op.  One templated source, ``csrc/cross_entropy.cu``, has an entry
point per dtype, each with its own launch count.

Vocab-parallel (``cross_entropy_vocab_parallel``): under JAX's param
specs a tp rank holds the logits of its block of the vocab.  Its partial
entry (``ktpu_xent_part_*``) writes each row's lse over the block and the
target's logit where the target falls in the block; the wrapper takes
the log-sum-exp of the tp ranks' lse and the sum of their target logits,
and the backward is the one-block kernel fed the global lse and the
targets shifted to the block (no one-hot outside it).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from . import build

_FWD_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p,                   # logits, targets
    ctypes.c_void_p, ctypes.c_void_p,                   # loss, lse
    ctypes.c_int, ctypes.c_int,                         # rows, vocab
    ctypes.c_void_p,                                    # stream
]
_BWD_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p,                   # logits, targets
    ctypes.c_void_p, ctypes.c_void_p,                   # lse, grad
    ctypes.c_void_p,                                    # dlogits (may be logits)
    ctypes.c_int, ctypes.c_int,                         # rows, vocab
    ctypes.c_void_p,                                    # stream
]
_PART_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p,                   # logits, targets
    ctypes.c_void_p, ctypes.c_void_p,                   # target logit, lse
    ctypes.c_int, ctypes.c_int,                         # rows, vocab (the block's)
    ctypes.c_longlong,                                  # v0: the block's first column
    ctypes.c_void_p,                                    # stream
]
# bf16 logits (Llama)
KERNEL = build.Kernel("cross_entropy", "ktpu_xent_fwd_bf16", _FWD_ARGS)
KERNEL_BWD = build.Kernel("cross_entropy", "ktpu_xent_bwd_bf16", _BWD_ARGS)
# f32 logits (BERT's masked LM)
KERNEL_F32 = build.Kernel("cross_entropy", "ktpu_xent_fwd_f32", _FWD_ARGS)
KERNEL_BWD_F32 = build.Kernel("cross_entropy", "ktpu_xent_bwd_f32", _BWD_ARGS)
# the vocab-parallel partial forward, bf16 (Llama) and f32 (BERT) logits
KERNEL_PART = build.Kernel("cross_entropy", "ktpu_xent_part_bf16", _PART_ARGS)
KERNEL_PART_F32 = build.Kernel("cross_entropy", "ktpu_xent_part_f32", _PART_ARGS)
DTYPES = (torch.bfloat16, torch.float32)


def cross_entropy_plain(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-row negative log-likelihood in f32: ``logits`` (rows, vocab) of
    any float dtype, cast to f32 first (JAX's ``astype(float32)``), then
    log-softmax and the target's entry."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets[:, None])[:, 0]


def cross_entropy_lse_plain(logits: torch.Tensor) -> torch.Tensor:
    """The f32 log-sum-exp of each row, which the forward kernel keeps for
    its backward."""
    return torch.logsumexp(logits.float(), dim=-1)


def cross_entropy_bwd_plain(logits: torch.Tensor, targets: torch.Tensor, lse: torch.Tensor,
                            grad: torch.Tensor) -> torch.Tensor:
    """The backward the kernel computes: (exp(x - lse) - onehot) * grad
    per row, in f32, rounded once to the logits' dtype (for bf16, where
    the VJP of JAX's cast to f32 rounds it; f32 is not rounded).  A
    target outside [0, vocab) has no one-hot (a vocab block's rows whose
    target lies in another block)."""
    d = torch.exp(logits.float() - lse[:, None])
    vocab = logits.shape[1]
    inside = (targets >= 0) & (targets < vocab)
    d.scatter_add_(1, targets.clamp(0, vocab - 1)[:, None],
                   torch.where(inside, -1.0, 0.0)[:, None].to(d.dtype))
    return (d * grad[:, None]).to(logits.dtype)


def cross_entropy_part_plain(logits: torch.Tensor, targets: torch.Tensor,
                             v0: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The partial entry's plain twin: for ``logits`` (rows, V) the block
    of global columns [v0, v0 + V) and global ``targets`` (rows,), (each
    row's f32 lse over the block, the target's logit where it lies in the
    block, else 0)."""
    x = logits.float()
    vocab = x.shape[1]
    local = targets - v0
    inside = (local >= 0) & (local < vocab)
    picked = x.gather(1, local.clamp(0, vocab - 1)[:, None])[:, 0]
    return torch.logsumexp(x, dim=-1), torch.where(inside, picked, 0.0)


def _check(logits, targets):
    if logits.dim() != 2 or targets.shape != (logits.shape[0],):
        raise ValueError(f"cross_entropy: logits (rows, vocab) and targets (rows,) required, "
                         f"got {tuple(logits.shape)} and {tuple(targets.shape)}")
    if logits.dtype not in DTYPES:
        raise TypeError(f"cross_entropy: kernel takes bf16 or f32 logits, got {logits.dtype}")


def cross_entropy_kernel(logits: torch.Tensor,
                         targets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the forward kernel for the logits' dtype (bf16 or
    f32): (loss, lse), each (rows,) f32."""
    _check(logits, targets)
    kernel = KERNEL if logits.dtype == torch.bfloat16 else KERNEL_F32
    kernel.load()
    build.check_cuda_tensors("cross_entropy", logits, dtype=logits.dtype)
    build.check_cuda_tensors("cross_entropy", targets, dtype=torch.int64)
    rows, vocab = logits.shape
    loss = torch.empty(rows, device=logits.device, dtype=torch.float32)
    lse = torch.empty_like(loss)
    kernel.launch(logits.device, logits.data_ptr(), targets.data_ptr(), loss.data_ptr(),
                  lse.data_ptr(), rows, vocab)
    return loss, lse


def cross_entropy_part_kernel(logits: torch.Tensor, targets: torch.Tensor,
                              v0: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the partial entry for the logits' dtype: (lse, the
    target's logit or 0), each (rows,) f32."""
    _check(logits, targets)
    kernel = KERNEL_PART if logits.dtype == torch.bfloat16 else KERNEL_PART_F32
    kernel.load()
    build.check_cuda_tensors("cross_entropy partial", logits, dtype=logits.dtype)
    build.check_cuda_tensors("cross_entropy partial", targets, dtype=torch.int64)
    rows, vocab = logits.shape
    tgt = torch.empty(rows, device=logits.device, dtype=torch.float32)
    lse = torch.empty_like(tgt)
    kernel.launch(logits.device, logits.data_ptr(), targets.data_ptr(), tgt.data_ptr(),
                  lse.data_ptr(), rows, vocab, int(v0))
    return lse, tgt


def cross_entropy_bwd_kernel(logits: torch.Tensor, targets: torch.Tensor, lse: torch.Tensor,
                             grad: torch.Tensor,
                             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of the backward kernel for the logits' dtype: dlogits in
    that dtype.  ``out`` may be ``logits`` itself: the gradient is then
    written over the logits, in place."""
    _check(logits, targets)
    kernel = KERNEL_BWD if logits.dtype == torch.bfloat16 else KERNEL_BWD_F32
    kernel.load()
    out = torch.empty_like(logits) if out is None else out
    build.check_cuda_tensors("cross_entropy backward", logits, out, dtype=logits.dtype)
    build.check_cuda_tensors("cross_entropy backward", targets, dtype=torch.int64)
    build.check_cuda_tensors("cross_entropy backward", lse, grad, dtype=torch.float32)
    rows, vocab = logits.shape
    if out.shape != logits.shape or lse.shape != (rows,) or grad.shape != (rows,):
        raise ValueError(f"cross_entropy backward: out like logits, lse and grad ({rows},) "
                         f"required")
    kernel.launch(logits.device, logits.data_ptr(), targets.data_ptr(), lse.data_ptr(),
                  grad.data_ptr(), out.data_ptr(), rows, vocab)
    return out


class _CrossEntropyFn(torch.autograd.Function):
    """Keeps the logits and the lse; the backward writes the gradient OVER
    the saved logits (2.1 GB not allocated at Llama-3-8B's 8192 x 128256
    bf16, 2.0 GB at BERT-large's 16384 x 30522 f32), so it runs once per
    forward (a second backward through a retained graph raises), and no
    caller may read the logits after it (``loss_fn`` and ``mlm_loss_fn``
    hold none)."""

    @staticmethod
    def forward(ctx, logits, targets):
        loss, lse = cross_entropy_kernel(logits, targets)
        ctx.save_for_backward(logits, targets, lse)
        ctx.spent = False
        return loss

    @staticmethod
    def backward(ctx, grad):
        if ctx.spent:  # the kernel's write bumps no version counter
            raise RuntimeError("cross_entropy: second backward through one graph; the "
                               "first wrote the gradient over the saved logits")
        ctx.spent = True
        logits, targets, lse = ctx.saved_tensors
        return cross_entropy_bwd_kernel(logits, targets, lse, grad.contiguous(),
                                        out=logits), None


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-row negative log-likelihood (rows,) f32 of ``logits`` (rows,
    vocab) at integer ``targets`` (rows,).

    A CPU tensor takes the plain version (autograd differentiates it); a
    CUDA tensor launches the kernel (bf16 or f32 logits, int64 targets)
    or raises."""
    if logits.device.type == "cpu":
        return cross_entropy_plain(logits, targets)
    return cross_entropy_on_kernels(logits, targets)


def cross_entropy_on_kernels(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The wrapper's kernel path: the forward kernel alone, or, where a
    gradient is wanted, the autograd Function over both kernels (whose
    backward writes over the logits)."""
    if torch.is_grad_enabled() and logits.requires_grad:
        return _CrossEntropyFn.apply(logits, targets)
    return cross_entropy_kernel(logits, targets)[0]


def combine_parts(lse: torch.Tensor, tgt: torch.Tensor,
                  group: Optional[dist.ProcessGroup]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, global lse) per row from this rank's block's (lse, target
    logit): the log-sum-exp in f32 of every tp rank's lse (all-gathered, so
    every rank adds them in one order) minus the sum of their target
    logits (one of which is not 0)."""
    n = 1 if group is None else dist.get_world_size(group)
    if n > 1:
        every = lse.new_empty(n * lse.numel())
        dist.all_gather_into_tensor(every, lse.contiguous(), group=group)
        lse = torch.logsumexp(every.view(n, -1), dim=0)
        tgt = tgt.clone()
        dist.all_reduce(tgt, group=group)
    return lse - tgt, lse


class _VocabParallelFn(torch.autograd.Function):
    """The vocab-parallel cross-entropy over one rank's block of the
    logits: the partial entry and the combine forward; the one-block
    backward with the global lse and the block's targets.  On the kernels
    the backward writes the gradient over the saved logits, as
    ``_CrossEntropyFn`` does."""

    @staticmethod
    def forward(ctx, logits, targets, v0, group, on_kernels):
        part = cross_entropy_part_kernel if on_kernels else cross_entropy_part_plain
        loss, lse = combine_parts(*part(logits, targets, v0), group)
        ctx.save_for_backward(logits, targets - v0, lse)
        ctx.on_kernels, ctx.spent = on_kernels, False
        return loss

    @staticmethod
    def backward(ctx, grad):
        logits, local, lse = ctx.saved_tensors
        if not ctx.on_kernels:
            return cross_entropy_bwd_plain(logits, local, lse, grad), None, None, None, None
        if ctx.spent:
            raise RuntimeError("cross_entropy_vocab_parallel: second backward through one "
                               "graph; the first wrote the gradient over the saved logits")
        ctx.spent = True
        return (cross_entropy_bwd_kernel(logits, local, lse, grad.contiguous(), out=logits),
                None, None, None, None)


def cross_entropy_vocab_parallel(logits: torch.Tensor, targets: torch.Tensor, v0: int,
                                 group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Per-row negative log-likelihood (rows,) f32 over the whole vocab,
    from this rank's block ``logits`` (rows, V) of global columns [v0, v0
    + V) and global ``targets`` (rows,); every rank of ``group`` (the tp
    ranks, which hold the other blocks of the same rows) calls it.  A CPU
    tensor takes the plain versions; a CUDA tensor launches the kernels
    (bf16 or f32 logits, int64 targets) or raises."""
    return _VocabParallelFn.apply(logits, targets, v0, group, logits.device.type != "cpu")


def cross_entropy_vocab_parallel_plain(logits: torch.Tensor, targets: torch.Tensor, v0: int,
                                       group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The same on the plain versions, on any device."""
    return _VocabParallelFn.apply(logits, targets, v0, group, False)
