"""K2 RMSNorm at every width class its backward kernel takes, on the CPU.

``csrc/rmsnorm.cu``'s backward keeps a row in registers, a lane holding 4
chunks of 8 columns: one warp a row up to d = 1024, a group of ceil(d /
1024) warps up to d = 16384 (2 at llama_bench's 2048, 4 at Llama-3-8B's
4096, 5 at 4104), and above that a block walks each row in device memory;
every d with d % 8 == 0 runs.  The plain forward and backward, which the
kernel is held to on the card, are held here to ``jax.vjp`` of the JAX
package's ``llama.rmsnorm`` at d in {8, 64, 1024, 2048, 4096, 4104, 8192,
16384, 16392}, one row and 37, in bf16 (inputs and scale), with these
tolerances, a step being the bf16 spacing at the reference value (2^-8 to
2^-7 of it):
- the output within two steps: both round x * r to bf16 with r's last f32
  bits taken from sums of squares in another order, so a value next to a
  rounding boundary lands one step of n = bf16(x r) away, at most 2^-7 of
  n; times the scale that is under two steps of the output, which the
  second rounding keeps within two (measured: two at d = 4104 and 16392,
  37 rows, where n differs; 0 elsewhere);
- dx within two steps of the result plus one step of each of the two terms
  r dn and x r^3 mean(dn x): JAX reaches x through two uses (x * r and the
  f32 cast in the variance), rounds each use's cotangent to bf16 and adds
  them in bf16, so where the terms cancel its error is a part of their
  step, not of the result's; the port rounds the f32 difference once
  (measured: at most half of this bound);
- dscale, which the port sums over the rows in f32 and rounds once, and
  JAX's VJP of the bf16 product sums in bf16: against JAX within rows
  steps of sum |dy n| over the rows (each of JAX's products and running
  sums, fewer than 2 rows roundings, is at most half a step of that sum);
  the gap measured at 37 rows is up to 1.2e-2 of max |dscale| (up to
  ~17,000 steps at small entries), 0 at one row.  That bound is loose, so
  the port's dscale is also held to the exact (f64) sum of JAX's own terms
  dy * bf16(x r): within half a step, plus |dy| times the step by which
  the port's n differs from JAX's where it does (measured: 0.5 steps, 8.2
  where n differs).
``tests/test_torch_train.py``'s f32 bar of 1e-5 does not carry over to
bf16: in f32 both sides compute the same arithmetic in another order
(~1e-7 relative), but in bf16 one f32 ulp before a rounding can move the
result a whole step (2^-8 of it, 3.9e-3), and JAX rounds the intermediate
cotangents to bf16 where the port keeps them in f32.
The kernel wrappers take any d % 8 == 0, refuse the rest, and raise on CPU
tensors without running the plain version; the backward's grid is asked of
the library once a width.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes1_tpu.workloads import llama as jllama
from kubernetes1_tpu_torch.kernels import build
from kubernetes1_tpu_torch.kernels import rmsnorm as trms

WIDTHS = [8, 64, 1024, 2048, 4096, 4104, 8192, 16384, 16392]
EPS = 1e-5  # llama.rmsnorm's default


def _bf16_step(ref: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values (8 significant bits) at |ref|."""
    exp = np.floor(np.log2(np.maximum(np.abs(ref), np.finfo(np.float32).tiny)))
    return np.exp2(exp - 7).astype(np.float32)


def _np(seed, *shape, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale + shift).astype(np.float32)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32), dtype=np.float32)


def _bf16(a):
    """The bf16 array JAX holds and the same values as a torch bf16 tensor."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, torch.from_numpy(_f32(j)).to(torch.bfloat16)


@pytest.mark.parametrize("rows", [1, 37])
@pytest.mark.parametrize("d", WIDTHS)
def test_plain_rmsnorm_and_its_backward_match_jax_at_each_width(d, rows):
    jx, tx = _bf16(_np(d + rows, rows, d, scale=1.5, shift=0.3))
    jdy, tdy = _bf16(_np(d + rows + 1, rows, d))
    js, ts = _bf16(np.random.default_rng(d).uniform(0.5, 1.5, d).astype(np.float32))
    jy, vjp = jax.vjp(jllama.rmsnorm, jx, js)
    jdx, jds = vjp(jdy)
    y = trms.rmsnorm_plain(tx, ts, EPS)
    dx, ds = trms.rmsnorm_bwd_plain(tx, ts, tdy, EPS)
    assert y.dtype == dx.dtype == ds.dtype == torch.bfloat16
    jy, jdx, jds = _f32(jy), _f32(jdx), _f32(jds)
    assert np.all(np.abs(_f32(y) - jy) <= 2 * _bf16_step(jy))

    xf, dyf, sf = _f32(tx), _f32(tdy), _f32(ts)
    r = 1.0 / np.sqrt(np.mean(xf * xf, axis=-1, keepdims=True) + EPS)
    dn = _f32(torch.from_numpy(dyf * sf).to(torch.bfloat16))
    term_a, term_b = r * dn, xf * r ** 3 * np.mean(dn * xf, axis=-1, keepdims=True)
    assert np.all(np.abs(_f32(dx) - jdx)
                  <= 2 * _bf16_step(jdx) + _bf16_step(term_a) + _bf16_step(term_b))

    # dscale against JAX's bf16 sum, then against the exact sum of JAX's terms
    var = jnp.mean(jnp.square(jx.astype(jnp.float32)), axis=-1, keepdims=True)
    n_jax = _f32((jx * jax.lax.rsqrt(var + EPS)).astype(jnp.bfloat16)).astype(np.float64)
    n_port = _f32(torch.from_numpy(xf * r).to(torch.bfloat16)).astype(np.float64)
    terms = dyf.astype(np.float64) * n_jax
    assert np.all(np.abs(_f32(ds) - jds) <= rows * _bf16_step(np.abs(terms).sum(0)))
    exact = terms.sum(0)
    moved = (np.abs(dyf) * np.abs(n_port - n_jax)).sum(0)
    assert np.all(np.abs(_f32(ds) - exact) <= 0.5 * _bf16_step(exact) + moved + 1e-6)


def _inputs(d, rows=4):
    x = torch.from_numpy(_np(1, rows, d)).to(torch.bfloat16)
    return x, torch.ones(d, dtype=torch.bfloat16), x.clone()


@pytest.mark.parametrize("d", WIDTHS)
def test_kernel_wrappers_take_every_width_that_is_a_multiple_of_8(d):
    """The width passes the wrappers' checks; what stops a CPU tensor is
    the CUDA check that follows."""
    x, scale, dy = _inputs(d)
    with pytest.raises(ValueError, match="CUDA device"):
        trms.rmsnorm_kernel(x, scale)
    with pytest.raises(ValueError, match="CUDA device"):
        trms.rmsnorm_bwd_kernel(x, scale, dy)


@pytest.mark.parametrize("d", [4, 12, 4100])
def test_kernel_wrappers_refuse_a_width_that_is_not_a_multiple_of_8(d):
    x, scale, dy = _inputs(d)
    with pytest.raises(ValueError, match="d % 8 == 0"):
        trms.rmsnorm_kernel(x, scale)
    with pytest.raises(ValueError, match="d % 8 == 0"):
        trms.rmsnorm_bwd_kernel(x, scale, dy)


def test_backward_kernel_raises_on_cpu_tensors_and_never_runs_the_plain_version(monkeypatch):
    def plain(*_args, **_kwargs):
        raise AssertionError("the kernel wrapper ran the plain version")

    monkeypatch.setattr(trms, "rmsnorm_bwd_plain", plain)
    monkeypatch.setattr(trms, "rmsnorm_plain", plain)
    x, scale, dy = _inputs(4096)
    with pytest.raises(ValueError, match="CUDA device"):
        trms.rmsnorm_bwd_kernel(x, scale, dy)
    with pytest.raises(ValueError, match="CUDA device"):
        trms.rmsnorm_on_kernels(x.requires_grad_(True), scale)


@pytest.mark.parametrize("rows, want", [(1, 1), (37, 10), (528, 132), (8192, 132)])
def test_backward_grid_is_capped_by_rows(monkeypatch, rows, want):
    """The library's grid at a width (resident blocks, rows a block takes
    at a time) is cached per (device, d); the blocks of a launch are the
    lesser of the resident blocks and one per 4 rows at d = 4096."""
    monkeypatch.setattr(trms, "_grids", {(0, 4096): (132, 4)})
    assert trms.bwd_blocks(torch.device("cuda", 0), rows, 4096) == want
    assert trms._grids == {(0, 4096): (132, 4)}


def test_backward_grid_is_asked_once_a_width(monkeypatch):
    """A width the cache lacks is asked of the library once, on the first
    call; later calls at that width, on any rows, reuse the answer."""
    asked = []

    def grid(d, resident, per_block):
        asked.append(d)
        resident._obj.value, per_block._obj.value = 132, 16 // -(-d // 1024)
        return 0

    class Lib:
        ktpu_rmsnorm_bwd_grid = staticmethod(grid)

    monkeypatch.setattr(trms, "_grids", {})
    monkeypatch.setattr(build, "load_library", lambda name: Lib())
    dev = torch.device("cuda", 0)
    assert [trms.bwd_blocks(dev, rows, 2048) for rows in (8192, 37, 8192)] == [132, 5, 132]
    assert trms.bwd_blocks(dev, 8192, 4096) == 132
    assert asked == [2048, 4096]
    assert trms._grids == {(0, 2048): (132, 8), (0, 4096): (132, 4)}


def test_backward_grid_raises_when_the_library_cannot_size_it(monkeypatch):
    class Lib:
        @staticmethod
        def ktpu_rmsnorm_bwd_grid(d, resident, per_block):
            return 1  # cudaErrorInvalidValue

    monkeypatch.setattr(trms, "_grids", {})
    monkeypatch.setattr(build, "load_library", lambda name: Lib())
    with pytest.raises(build.KernelLaunchError, match="ktpu_rmsnorm_bwd_grid"):
        trms.bwd_blocks(torch.device("cuda", 0), 8192, 4096)
    assert trms._grids == {}
