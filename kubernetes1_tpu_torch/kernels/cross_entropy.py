"""K5 fused cross-entropy: the hand-written CUDA kernels (forward and
backward) and their plain PyTorch versions.

Replaces the ``log_softmax`` / ``take_along_axis`` of the JAX package's
``workloads/llama.py`` ``loss_fn`` over the logits (rows, vocab): the
kernels read the bf16 logits and never hold them, their log-softmax or
their gradient in f32.  The mean over rows stays a torch op.  The
kernels are in ``csrc/cross_entropy.cu``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build

KERNEL = build.Kernel("cross_entropy", "ktpu_xent_fwd_bf16", [
    ctypes.c_void_p, ctypes.c_void_p,                   # logits, targets
    ctypes.c_void_p, ctypes.c_void_p,                   # loss, lse
    ctypes.c_int, ctypes.c_int,                         # rows, vocab
    ctypes.c_void_p,                                    # stream
])
KERNEL_BWD = build.Kernel("cross_entropy", "ktpu_xent_bwd_bf16", [
    ctypes.c_void_p, ctypes.c_void_p,                   # logits, targets
    ctypes.c_void_p, ctypes.c_void_p,                   # lse, grad
    ctypes.c_void_p,                                    # dlogits (may be logits)
    ctypes.c_int, ctypes.c_int,                         # rows, vocab
    ctypes.c_void_p,                                    # stream
])


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
    per row, in f32, rounded once to the logits' dtype (where the VJP of
    JAX's cast to f32 rounds it)."""
    d = torch.exp(logits.float() - lse[:, None])
    d.scatter_add_(1, targets[:, None], torch.full_like(d[:, :1], -1.0))
    return (d * grad[:, None]).to(logits.dtype)


def _check(logits, targets):
    if logits.dim() != 2 or targets.shape != (logits.shape[0],):
        raise ValueError(f"cross_entropy: logits (rows, vocab) and targets (rows,) required, "
                         f"got {tuple(logits.shape)} and {tuple(targets.shape)}")


def cross_entropy_kernel(logits: torch.Tensor,
                         targets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the forward kernel: (loss, lse), each (rows,) f32."""
    KERNEL.load()
    build.check_cuda_tensors("cross_entropy", logits)
    build.check_cuda_tensors("cross_entropy", targets, dtype=torch.int64)
    _check(logits, targets)
    rows, vocab = logits.shape
    loss = torch.empty(rows, device=logits.device, dtype=torch.float32)
    lse = torch.empty_like(loss)
    KERNEL.launch(logits.device, logits.data_ptr(), targets.data_ptr(), loss.data_ptr(),
                  lse.data_ptr(), rows, vocab)
    return loss, lse


def cross_entropy_bwd_kernel(logits: torch.Tensor, targets: torch.Tensor, lse: torch.Tensor,
                             grad: torch.Tensor,
                             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of the backward kernel: dlogits in the logits' dtype.
    ``out`` may be ``logits`` itself: the gradient is then written over
    the logits, in place."""
    KERNEL_BWD.load()
    out = torch.empty_like(logits) if out is None else out
    build.check_cuda_tensors("cross_entropy backward", logits, out)
    build.check_cuda_tensors("cross_entropy backward", targets, dtype=torch.int64)
    build.check_cuda_tensors("cross_entropy backward", lse, grad, dtype=torch.float32)
    _check(logits, targets)
    rows, vocab = logits.shape
    if out.shape != logits.shape or lse.shape != (rows,) or grad.shape != (rows,):
        raise ValueError(f"cross_entropy backward: out like logits, lse and grad ({rows},) "
                         f"required")
    KERNEL_BWD.launch(logits.device, logits.data_ptr(), targets.data_ptr(), lse.data_ptr(),
                      grad.data_ptr(), out.data_ptr(), rows, vocab)
    return out


class _CrossEntropyFn(torch.autograd.Function):
    """Keeps the bf16 logits and the lse; the backward writes the gradient
    OVER the saved logits (2.1 GB not allocated at Llama-3-8B's 8192 x
    128256), so it runs once per forward (a second backward through a
    retained graph raises), and no caller may read the logits after it
    (``loss_fn`` holds none)."""

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
    CUDA tensor launches the kernel (bf16 logits, int64 targets) or
    raises."""
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
