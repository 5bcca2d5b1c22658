"""K8's split form across ranks, composed over row shards in one process.

``kubernetes1_tpu_torch/kernels/batchnorm.py`` gives batch norm a form
for data parallelism: each rank sums its rows (``bn_sums``), the (2, C)
sums are all-reduced, and ``bn_fold_apply`` folds them over every rank's
rows and applies them to the rank's own;
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
gloo ranks in ``tests/test_torch_sharding.py``; here, two gloo ranks (each
a process that imports torch and the port, never JAX) each hold half the
rows: ``bn_fold_apply_plain`` of the all-reduced sums, and autograd of
``batchnorm_plain(..., group=...)`` through it, against ``jax.vjp`` of
JAX's ``_bn`` on the whole batch, within the same 1e-5.
"""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes1_tpu.workloads import resnet as jresnet
from kubernetes1_tpu_torch.kernels import batchnorm as tbn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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



# ------------------------------------------------------------ two gloo ranks

_WORKER = r"""
import pickle
import sys
import torch
import torch.distributed as dist
from kubernetes1_tpu_torch.kernels import batchnorm as tbn

rank, n, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(tmp + "/store", n), rank=rank,
                        world_size=n)
try:
    with open(tmp + "/in.pkl", "rb") as f:
        data = pickle.load(f)
    x, scale, bias, r, dy = (torch.from_numpy(a) for a in data["inputs"])
    h = x.shape[0] // n
    rows = slice(rank * h, (rank + 1) * h)
    out = {}
    for name, (relu, residual) in data["variants"].items():
        res = r[rows] if residual else None
        sums = tbn.bn_sums_plain(x[rows])
        dist.all_reduce(sums)
        y, mask, w, b, stats = tbn.bn_fold_apply_plain(x[rows], sums, x.shape[0], scale, bias,
                                                       res, relu)
        leaves = [t.clone().requires_grad_(True) for t in (x[rows], scale, bias, r[rows])]
        y2 = tbn.batchnorm_plain(*leaves[:3], leaves[3] if residual else None, relu,
                                 group=dist.group.WORLD)
        y2.backward(dy[rows])
        out[name] = dict(y=y, w=w, b=b, stats=stats, y2=y2.detach(), dx=leaves[0].grad,
                         dscale=leaves[1].grad, dbias=leaves[2].grad, dr=leaves[3].grad)
    torch.save(out, tmp + "/out%d.pt" % rank)
finally:
    dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    """Each of 2 gloo ranks' results for every variant, on its half of
    ``_inputs()``'s rows."""
    tmp = tmp_path_factory.mktemp("bn-ranks")
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump({"inputs": _inputs(), "variants": VARIANTS}, f)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), "2", str(tmp)], cwd=REPO,
                              env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(errs)
    return [torch.load(tmp / f"out{r}.pt", weights_only=False) for r in range(2)]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_fold_apply_over_two_gloo_ranks_equals_jax_vjp_of_bn(gloo_ranks, variant):
    """The split forward's plain twin over 2 ranks: both ranks fold the
    same (w, b, stats), the whole batch's; the ranks' y together, and the
    gradients of batchnorm_plain over the group (dx, dr by rows; dscale,
    dbias summed over the ranks), are JAX's."""
    relu, residual = VARIANTS[variant]
    x, scale, bias, r, dy = _inputs()
    jy, vjp = jax.vjp(_jax_bn(relu, residual), *(jnp.asarray(a) for a in (x, scale, bias, r)))
    jdx, jds, jdb, jdr = vjp(jnp.asarray(dy))
    ranks = [g[variant] for g in gloo_ranks]
    for key in ("w", "b", "stats"):
        assert torch.equal(ranks[0][key], ranks[1][key])
    w0, b0, stats0 = tbn.bn_stats_plain(*(_t(a) for a in (x, scale, bias)))
    for key, want in (("w", w0), ("b", b0), ("stats", stats0)):
        assert _rel_err(ranks[0][key], want) <= TOL
    for rk in ranks:
        assert torch.equal(rk["y"], rk["y2"])
    assert _rel_err(torch.cat([rk["y"] for rk in ranks]), jy) <= TOL
    assert _rel_err(torch.cat([rk["dx"] for rk in ranks]), jdx) <= TOL
    assert _rel_err(ranks[0]["dscale"] + ranks[1]["dscale"], jds) <= TOL
    assert _rel_err(ranks[0]["dbias"] + ranks[1]["dbias"], jdb) <= TOL
    if residual:
        assert _rel_err(torch.cat([rk["dr"] for rk in ranks]), jdr) <= TOL
