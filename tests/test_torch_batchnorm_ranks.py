"""K8's split form across ranks, composed over row shards in one process.

``kubernetes1_tpu_torch/kernels/batchnorm.py`` gives batch norm a form
for data parallelism: each rank sums its rows (``bn_sums``), the (2, C)
sums are all-reduced, and ``bn_fold`` folds them over every rank's rows;
the backward sums dy' and dy'·x (``bn_bwd_sums``, which also gives the
rank's dscale and dbias), the sums are all-reduced, and ``bn_bwd_dx``
computes each rank's dx from the global sums.  Here the all-reduce is the
sum of the shards' sums, in f32, on the plain versions the CUDA kernels
are held to on the card.  Over 2, 3 and 4 shards of the rows, with and
without the ReLU and the residual:

- the forward (w, b, stats, y) and dx, dr equal ``bn_stats_plain`` /
  ``bn_apply_plain`` / ``bn_bwd_plain`` on the whole batch, and
  ``jax.vjp`` of JAX's ``resnet._bn`` on the whole batch (the ReLU and
  residual around it), within 1e-5 of max(1, max |reference|): the sums
  are added in another order, a few f32 ulps;
- the shards' dscale and dbias add up to the whole batch's (the train
  step's average of them, times the ranks) and to JAX's, within 1e-5;
- each shard's dscale and dbias are its own rows' alone: taken from the
  global sums they would count every shard n times over.

The same sums go through ``batchnorm_plain(..., group=...)`` over real
gloo ranks in ``tests/test_torch_sharding.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes1_tpu.workloads import resnet as jresnet
from kubernetes1_tpu_torch.kernels import batchnorm as tbn

TOL = 1e-5
M, C = 48, 24  # 48 rows: 2, 3 and 4 shards of equal size
VARIANTS = {"plain": (False, False), "relu": (True, False), "relu_residual": (True, True)}


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel_err(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.detach().float().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / max(1.0, float(np.max(np.abs(want)))))


def _inputs():
    x = _np(1, M, C, scale=2.0) + 0.5
    scale = np.random.default_rng(2).uniform(0.5, 1.5, C).astype(np.float32)
    return x, scale, _np(3, C, scale=0.3), _np(4, M, C), _np(5, M, C)


def _jax_bn(relu, residual):
    def fn(x, scale, bias, r):
        y = jresnet._bn(x.reshape(M, 1, 1, C), {"scale": scale, "bias": bias}).reshape(M, C)
        if residual:
            y = r + y
        return jax.nn.relu(y) if relu else y
    return fn


def _split(x, scale, bias, r, dy, relu, residual, n):
    """The split form over n shards of the rows: per shard (y, dx, dr,
    dscale, dbias), and the global (w, b, stats)."""
    shards = [slice(i * M // n, (i + 1) * M // n) for i in range(n)]
    sums = sum(tbn.bn_sums_plain(x[s]) for s in shards)  # the all-reduce
    w, b, stats = tbn.bn_fold_plain(sums, M, scale, bias, dtype=x.dtype)
    outs = [tbn.bn_apply_plain(x[s], w, b, r[s] if residual else None, relu) for s in shards]
    bwd = [tbn.bn_bwd_sums_plain(x[s], mask, dy[s], stats)
           for s, (_y, mask) in zip(shards, outs)]
    gsums = sum(b_[0] for b_ in bwd)  # the all-reduce
    dxs = [tbn.bn_bwd_dx_plain(x[s], mask, dy[s], w, scale, stats, gsums, M, residual)
           for s, (_y, mask) in zip(shards, outs)]
    y = torch.cat([o[0] for o in outs])
    dx = torch.cat([d[0] for d in dxs])
    dr = torch.cat([d[1] for d in dxs]) if residual else None
    return (w, b, stats), y, dx, dr, [b_[1] for b_ in bwd], [b_[2] for b_ in bwd]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("n", [2, 3, 4])
def test_split_over_shards_equals_the_whole_batch(n, variant):
    relu, residual = VARIANTS[variant]
    x, scale, bias, r, dy = (_t(a) for a in _inputs())
    (w, b, stats), y, dx, dr, dscales, dbiases = _split(x, scale, bias, r, dy, relu,
                                                        residual, n)
    w0, b0, stats0 = tbn.bn_stats_plain(x, scale, bias)
    for got, want in ((w, w0), (b, b0), (stats, stats0)):
        assert _rel_err(got, want) <= TOL
    y0, mask0 = tbn.bn_apply_plain(x, w0, b0, r if residual else None, relu)
    assert _rel_err(y, y0) <= TOL
    dx0, dr0, dscale0, dbias0 = tbn.bn_bwd_plain(x, mask0, dy, w0, scale, stats0, residual)
    assert _rel_err(dx, dx0) <= TOL
    assert (dr is None and dr0 is None) if not residual else _rel_err(dr, dr0) <= TOL
    assert _rel_err(sum(dscales), dscale0) <= TOL
    assert _rel_err(sum(dbiases), dbias0) <= TOL


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("n", [2, 4])
def test_split_over_shards_equals_jax_vjp_of_bn(n, variant):
    relu, residual = VARIANTS[variant]
    x, scale, bias, r, dy = _inputs()
    jy, vjp = jax.vjp(_jax_bn(relu, residual), *(jnp.asarray(a) for a in (x, scale, bias, r)))
    jdx, jds, jdb, jdr = vjp(jnp.asarray(dy))
    _wbs, y, dx, dr, dscales, dbiases = _split(*(_t(a) for a in (x, scale, bias, r, dy)),
                                               relu, residual, n)
    assert _rel_err(y, jy) <= TOL
    assert _rel_err(dx, jdx) <= TOL
    assert _rel_err(sum(dscales), jds) <= TOL
    assert _rel_err(sum(dbiases), jdb) <= TOL
    if residual:
        assert _rel_err(dr, jdr) <= TOL


def test_each_shard_keeps_its_own_dscale_and_dbias():
    """dscale and dbias of a shard are its rows' alone: the sums of its
    own dy' and dy'·x, not the global ones (which would count each shard
    n times once the train step averages)."""
    x, scale, bias, r, dy = (_t(a) for a in _inputs())
    _wbs, _y, _dx, _dr, dscales, dbiases = _split(x, scale, bias, r, dy, True, False, 2)
    w, b, stats = tbn.bn_stats_plain(x, scale, bias)
    _y, mask = tbn.bn_apply_plain(x, w, b, None, True)
    for i, (ds, db) in enumerate(zip(dscales, dbiases)):
        rows = slice(i * M // 2, (i + 1) * M // 2)
        dyf = torch.where(tbn.relu_unmask_plain(mask[rows]), dy[rows], 0.0)
        assert _rel_err(db, dyf.sum(0)) <= TOL
        assert _rel_err(ds, ((dyf * x[rows]).sum(0) - dyf.sum(0) * stats[0]) * stats[1]) <= TOL
    assert _rel_err(dbiases[0], dbiases[1]) > 1e-2  # the shards' own rows differ


def test_split_at_one_shard_is_the_one_launch_arithmetic():
    """One rank: the split plain versions give bn_stats_plain's fold and
    bn_bwd_plain's backward from the same sums (the kernels are held to
    the same bits on the card)."""
    x, scale, bias, r, dy = (_t(a) for a in _inputs())
    (w, b, stats), y, dx, dr, dscales, dbiases = _split(x, scale, bias, r, dy, True, True, 1)
    w0, b0, stats0 = tbn.bn_stats_plain(x, scale, bias)
    _y0, mask0 = tbn.bn_apply_plain(x, w0, b0, r, True)
    dx0, dr0, dscale0, dbias0 = tbn.bn_bwd_plain(x, mask0, dy, w0, scale, stats0, True)
    for got, want in ((w, w0), (b, b0), (stats, stats0), (dx, dx0), (dr, dr0),
                      (dscales[0], dscale0), (dbiases[0], dbias0)):
        assert _rel_err(got, want) <= TOL

