"""K8's ReLU mask on the CPU: the (M, C/8) uint8 mask of y > 0 that the
apply writes where the layer has a ReLU and the backward reads in place of
y (``kubernetes1_tpu_torch/kernels/batchnorm.py``).

- The plain mask is the bits of y > 0, bit k of byte (row, g) for channel
  8g + k: a y of exactly 0, of -0.0 or below 0 gives a 0 bit, at C = 8, 24
  and 136 (one byte a row, an odd number of bytes, more than 16 bytes).
- ``bn_bwd_plain`` given that mask equals ``jax.vjp`` of JAX's ``_bn``
  with the ReLU and the residual around it, in f32, to 1e-5 relative to
  max(1, max |reference|) (the bar of ``tests/test_torch_resnet.py``), in
  its cases: a clamped variance and a tie (one row) included.  The mask is
  taken from JAX's own forward output, so the backward is held to JAX's
  gradient through its own ReLU.
- The autograd Function keeps the mask, not y, for the backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes1_tpu.workloads import resnet as jresnet
from kubernetes1_tpu_torch.kernels import batchnorm as tbn

# a constant f32 value whose E[x²] − E[x]² over 3 rows rounds below 0
CLAMPED = np.float32(0.7498327493667603)
CASES = {"37x24": (37, 24), "64x16": (64, 16), "clamped": (3, 8), "tie": (1, 8)}
VARIANTS = {"relu": False, "relu_residual": True}


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _rel_err(got, want) -> float:
    """max |got - want| / max(1, max |want|)."""
    got, want = got.detach().float().numpy(), np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / max(1.0, float(np.max(np.abs(want)))))


def _packed(y: np.ndarray) -> np.ndarray:
    return np.packbits(y > 0, axis=1, bitorder="little")


@pytest.mark.parametrize("C", [8, 24, 136])
def test_relu_mask_plain_is_the_bits_of_y_positive(C):
    M = 37
    y = _np(10 + C, M, C)
    y[0, :] = 0.0
    y[1, :] = -0.0
    y[2, ::3] = 0.0
    y[3, 1::2] = -0.0
    y[4, :] = np.finfo(np.float32).tiny  # the least normal f32: > 0
    yt = torch.from_numpy(y).bfloat16()
    mask = tbn.relu_mask_plain(yt)
    assert mask.dtype == torch.uint8 and tuple(mask.shape) == (M, C // 8)
    np.testing.assert_array_equal(mask.numpy(), _packed(yt.float().numpy()))
    assert (mask[:2] == 0).all() and (mask[4] == 255).all()
    assert torch.equal(tbn.relu_unmask_plain(mask), yt > 0)


@pytest.mark.parametrize("C", [8, 24, 136])
def test_bn_apply_plain_masks_its_rounded_output(C):
    """Where the residual cancels the normalised value to 0 (of either
    sign) the ReLU's output is 0 and its bit 0; the mask is that of the
    bf16 y the apply returns, None without a ReLU."""
    M = 50
    x = torch.from_numpy(_np(20, M, C, scale=2.0)).bfloat16()
    w = torch.from_numpy(np.linspace(0.5, 1.5, C).astype(np.float32)).bfloat16()
    b = torch.from_numpy(np.linspace(-0.3, 0.3, C).astype(np.float32)).bfloat16()
    r = torch.from_numpy(_np(21, M, C)).bfloat16()
    r[:5] = -(x[:5] * w + b)  # y = r + (x*w + b) = 0 exactly in these rows
    for residual in (None, r):
        y, mask = tbn.bn_apply_plain(x, w, b, residual, relu=True)
        np.testing.assert_array_equal(mask.numpy(), _packed(y.float().numpy()))
        assert tbn.bn_apply_plain(x, w, b, residual)[1] is None
    assert (y[:5] == 0).all() and (mask[:5] == 0).all()


def _jax_bn_relu(residual):
    def fn(x, scale, bias, r):
        M, C = x.shape
        y = jresnet._bn(x.reshape(M, 1, 1, C), {"scale": scale, "bias": bias}).reshape(M, C)
        if residual:
            y = r + y
        return jax.nn.relu(y)
    return fn


def _inputs(case):
    M, C = CASES[case]
    x = _np(1, M, C, scale=2.0) + 0.5
    if case == "clamped":
        x[:, 3] = CLAMPED  # channel 3: a clamped variance
    scale = np.random.default_rng(2).uniform(0.5, 1.5, C).astype(np.float32)
    return x, scale, _np(3, C, scale=0.3), _np(4, M, C), _np(5, M, C)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_bn_bwd_plain_with_mask_matches_jax_vjp(case, variant):
    residual = VARIANTS[variant]
    x, scale, bias, r, dy = _inputs(case)
    jy, vjp = jax.vjp(_jax_bn_relu(residual), *(jnp.asarray(a) for a in (x, scale, bias, r)))
    jdx, jds, jdb, jdr = vjp(jnp.asarray(dy))
    if case in ("clamped", "tie"):  # the case covers what it names
        xj = jnp.asarray(x)
        d = np.asarray(jnp.mean(jnp.square(xj), 0) - jnp.square(jnp.mean(xj, 0)))
        assert (d[3] < 0) if case == "clamped" else (d == 0).all(), d
    tx, ts, tb = (torch.from_numpy(a) for a in (x, scale, bias))
    w, _b, stats = tbn.bn_stats_plain(tx, ts, tb)
    mask = torch.from_numpy(_packed(np.asarray(jy)))
    assert torch.equal(tbn.relu_unmask_plain(mask), torch.from_numpy(np.asarray(jy) > 0))
    dx, dr, dscale, dbias = tbn.bn_bwd_plain(tx, mask, torch.from_numpy(dy), w, ts, stats,
                                             residual)
    for got, want in ((dx, jdx), (dscale, jds), (dbias, jdb)):
        assert _rel_err(got, want) <= 1e-5
    assert (dr is None) if not residual else _rel_err(dr, jdr) <= 1e-5


def test_batchnorm_function_saves_the_mask_not_y(monkeypatch):
    """On the kernel path the autograd Function keeps x, the (M, C/8)
    uint8 mask, w, scale and stats: no (M, C) copy of y.  (The kernels are
    swapped for their plain twins, which this machine runs.)"""
    for name, twin in (("bn_stats_kernel", tbn.bn_stats_plain),
                       ("bn_apply_kernel", tbn.bn_apply_plain),
                       ("bn_bwd_kernel", tbn.bn_bwd_plain)):
        monkeypatch.setattr(tbn, name, twin)
    x = torch.from_numpy(_np(30, 40, 24)).requires_grad_(True)
    scale, bias = torch.ones(24, requires_grad=True), torch.zeros(24, requires_grad=True)
    y = tbn.batchnorm_on_kernels(x, scale, bias, relu=True)
    saved = y.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [(40, 24), (40, 3), (24,), (24,), (4, 24)]
    assert saved[1].dtype == torch.uint8
    assert torch.equal(tbn.relu_unmask_plain(saved[1]), y.detach() > 0)
    y.backward(torch.ones_like(y))
    assert x.grad is not None and scale.grad is not None
