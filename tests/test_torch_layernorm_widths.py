"""K7b LayerNorm at every width class its backward kernel takes, on the CPU.

``csrc/layernorm.cu``'s backward keeps a row in registers in 1-4 chunks
of 256 columns a lane (d <= 1024: BERT-large's 1024, BERT-base's 768, the
tiny configs) and walks wider rows in shared memory; every d with
d % 8 == 0 runs.  The plain forward and backward, which the kernels are
held to on the card, are held here to ``jax.vjp`` of the JAX package's
``bert.layernorm`` at d in {8, 64, 768, 1024, 1032, 2048}, one row and
37, in bf16, at ``tests/test_torch_bert.py::
test_layernorm_and_its_vjp_match_jax``'s bf16 tolerances: the output
within one bf16 step (both round the same f32 value once, after sums in
another order), dx within two steps and 1e-3 (rounded once from f32
terms that may cancel), dscale and dbias (f32) within 1e-4.  A step is
the bf16 spacing at the reference value, 2^-8 to 2^-7 of it: that test
writes it as 2^-8 |ref|, half a step at the bottom of a binade, which
its 24 x 96 inputs never reach and 37 rows of 1024 do (an f32 output of
0.048706 between the bf16 neighbours 0.048584 and 0.048828).  The kernel
wrappers take any d % 8 == 0, refuse the rest, and raise on CPU tensors
without running the plain version; the backward's grid is asked of the
library once a width.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes1_tpu.workloads import bert as jbert
from kubernetes1_tpu_torch.kernels import layernorm as tln

WIDTHS = [8, 64, 768, 1024, 1032, 2048]


def _bf16_step(ref: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values (8 significant bits) at |ref|."""
    exp = np.floor(np.log2(np.maximum(np.abs(ref), np.finfo(np.float32).tiny)))
    return np.exp2(exp - 7).astype(np.float32)


def _np(seed, *shape, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale + shift).astype(np.float32)


def _f32(a) -> np.ndarray:
    return np.array(a.detach().float() if isinstance(a, torch.Tensor) else a, dtype=np.float32)


def _rel_err(got, want) -> float:
    """max |got - want| / max(1, max |want|)."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / max(1.0, float(np.max(np.abs(want)))))


def _bf16(a):
    """The bf16 array JAX holds and the same values as a torch bf16 tensor."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


@pytest.mark.parametrize("rows", [1, 37])
@pytest.mark.parametrize("d", WIDTHS)
def test_plain_layernorm_and_its_backward_match_jax_at_each_width(d, rows):
    jx, tx = _bf16(_np(d + rows, rows, d, scale=1.5, shift=0.3))
    jdy, tdy = _bf16(_np(d + rows + 1, rows, d))
    scale = np.random.default_rng(d).uniform(0.5, 1.5, d).astype(np.float32)
    bias = _np(d + 2, d, scale=0.3)
    jy, vjp = jax.vjp(jbert.layernorm, jx, jnp.asarray(scale), jnp.asarray(bias))
    jdx, jds, jdb = vjp(jdy)
    y = tln.layernorm_plain(tx, torch.from_numpy(scale), torch.from_numpy(bias))
    dx, ds, db = tln.layernorm_bwd_plain(tx, torch.from_numpy(scale), tdy)
    assert y.dtype == dx.dtype == torch.bfloat16 and ds.dtype == db.dtype == torch.float32
    jy32, jdx32 = _f32(jy.astype(jnp.float32)), _f32(jdx.astype(jnp.float32))
    assert np.all(np.abs(_f32(y) - jy32) <= _bf16_step(jy32) + 1e-6)
    assert np.all(np.abs(_f32(dx) - jdx32) <= 2 * _bf16_step(jdx32) + 1e-3)
    assert _rel_err(ds, jds) <= 1e-4 and _rel_err(db, jdb) <= 1e-4


def _inputs(d, rows=4):
    x = torch.from_numpy(_np(1, rows, d)).to(torch.bfloat16)
    return x, torch.ones(d), x.clone()


@pytest.mark.parametrize("d", WIDTHS)
def test_kernel_wrappers_take_every_width_that_is_a_multiple_of_8(d):
    """The width passes the wrappers' checks; what stops a CPU tensor is
    the CUDA check that follows."""
    x, scale, dy = _inputs(d)
    with pytest.raises(ValueError, match="CUDA device"):
        tln.layernorm_kernel(x, scale, scale)
    with pytest.raises(ValueError, match="CUDA device"):
        tln.layernorm_bwd_kernel(x, scale, dy)


@pytest.mark.parametrize("d", [4, 12, 1030])
def test_kernel_wrappers_refuse_a_width_that_is_not_a_multiple_of_8(d):
    x, scale, dy = _inputs(d)
    with pytest.raises(ValueError, match="d % 8 == 0"):
        tln.layernorm_kernel(x, scale, scale)
    with pytest.raises(ValueError, match="d % 8 == 0"):
        tln.layernorm_bwd_kernel(x, scale, dy)


def test_backward_kernel_raises_on_cpu_tensors_and_never_runs_the_plain_version(monkeypatch):
    def plain(*_args, **_kwargs):
        raise AssertionError("the kernel wrapper ran the plain version")

    monkeypatch.setattr(tln, "layernorm_bwd_plain", plain)
    monkeypatch.setattr(tln, "layernorm_plain", plain)
    x, scale, dy = _inputs(1024)
    with pytest.raises(ValueError, match="CUDA device"):
        tln.layernorm_bwd_kernel(x, scale, dy)
    with pytest.raises(ValueError, match="CUDA device"):
        tln.layernorm_on_kernels(x.requires_grad_(True), scale, scale)


@pytest.mark.parametrize("rows, want", [(1, 1), (37, 5), (1056, 132), (16384, 132)])
def test_backward_grid_is_asked_once_a_width_and_capped_by_rows(monkeypatch, rows, want):
    """The library's grid at a width (resident blocks, rows a block takes
    at a time) is cached per (device, d); the blocks of a launch are the
    lesser of the resident blocks and one per W rows."""
    monkeypatch.setattr(tln, "_grids", {(0, 1024): (132, 8)})
    assert tln.bwd_blocks(torch.device("cuda", 0), rows, 1024) == want
    assert tln._grids == {(0, 1024): (132, 8)}
