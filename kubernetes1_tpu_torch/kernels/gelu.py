"""K9 tanh-GELU: the hand-written CUDA kernels (forward and backward) and
their plain PyTorch versions.

Replaces ``jax.nn.gelu`` (the tanh approximation, its default) in the JAX
package's ``workloads/bert.py``: on the output of ``x @ w_in`` in
``layer_fn`` and in the MLM transform head of ``forward``.  The GEMMs
around it stay ``torch.matmul``.  The kernels are in ``csrc/gelu.cu``.

Both versions compute in f32 with the exact constants and round once.
JAX on bf16 (XLA:CPU) rounds after each op and casts sqrt(2/pi) to bf16
first, so on bf16 inputs the two differ by at most one bf16 step of the
output, within 2^-7 * |x|; on f32 inputs they agree to f32 rounding.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build

KERNEL = build.Kernel("gelu", "ktpu_gelu_fwd_bf16", [
    ctypes.c_void_p, ctypes.c_void_p,                   # x, y
    ctypes.c_longlong,                                  # n
    ctypes.c_void_p,                                    # stream
])
KERNEL_BWD = build.Kernel("gelu", "ktpu_gelu_bwd_bf16", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, dy, dx
    ctypes.c_longlong,                                  # n
    ctypes.c_void_p,                                    # stream
])
SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
COEFF = 0.044715


def _tanh_part(xf: torch.Tensor) -> torch.Tensor:
    """tanh(sqrt(2/pi) * (x + 0.044715 * x^3)) in f32, jax.nn.gelu's order."""
    return torch.tanh(SQRT_2_OVER_PI * (xf + COEFF * (xf * xf * xf)))


def gelu_plain(x: torch.Tensor) -> torch.Tensor:
    """x * 0.5 * (1 + tanh(...)) in f32, rounded once to x's dtype."""
    xf = x.float()
    return (xf * (0.5 * (1.0 + _tanh_part(xf)))).to(x.dtype)


def gelu_bwd_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The backward the kernel computes, in f32, rounded once:
    dy * (cdf + x * 0.5 * (1 - t^2) * sqrt(2/pi) * (1 + 3 * 0.044715 * x^2))."""
    xf = x.float()
    t = _tanh_part(xf)
    dinner = SQRT_2_OVER_PI * (1.0 + (3.0 * COEFF) * (xf * xf))
    dydx = 0.5 * (1.0 + t) + xf * ((0.5 * (1.0 - t * t)) * dinner)
    return (dy.float() * dydx).to(x.dtype)


def _check(*ts):
    if any(t.shape != ts[0].shape for t in ts) or ts[0].numel() % 8:
        raise ValueError(f"gelu: tensors of one shape with numel % 8 == 0 required, "
                         f"got {[tuple(t.shape) for t in ts]}")


def gelu_kernel(x: torch.Tensor) -> torch.Tensor:
    """One launch of the forward kernel."""
    KERNEL.load()
    build.check_cuda_tensors("gelu", x)
    _check(x)
    y = torch.empty_like(x)
    KERNEL.launch(x.device, x.data_ptr(), y.data_ptr(), x.numel())
    return y


def gelu_bwd_kernel(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """One launch of the backward kernel: dx."""
    KERNEL_BWD.load()
    build.check_cuda_tensors("gelu backward", x, dy)
    _check(x, dy)
    dx = torch.empty_like(x)
    KERNEL_BWD.launch(x.device, x.data_ptr(), dy.data_ptr(), dx.data_ptr(), x.numel())
    return dx


class _GeluFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return gelu_kernel(x)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        return gelu_bwd_kernel(x, dy.contiguous())


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-GELU of a GEMM output (..., n).

    A CPU tensor takes the plain version (autograd differentiates it); a
    CUDA tensor launches the kernel (bf16, numel % 8 == 0) or raises."""
    if x.device.type == "cpu":
        return gelu_plain(x)
    return gelu_on_kernels(x)


def gelu_on_kernels(x: torch.Tensor) -> torch.Tensor:
    """The wrapper's kernel path: the forward kernel alone, or, where a
    gradient is wanted, the autograd Function over both kernels."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _GeluFn.apply(x)
    return gelu_kernel(x)
