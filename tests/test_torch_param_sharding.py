"""Parameter sharding in the PyTorch port against the JAX package's
placement and its sharded step.

``kubernetes1_tpu_torch/workloads/sharding.py`` places every leaf of Llama
and BERT by JAX's ``param_specs`` over a ``(dp, fsdp, tp)`` ``DeviceMesh``
of one process per device; the train steps gather the fsdp blocks where a
layer runs, split heads and d_ff over tp (the tp "copy" and "reduce"), look
up the embedding by vocab block and take K5's vocab-parallel loss.  The
ranks here are gloo processes on the CPU that import torch and the port,
never JAX, spawned once per world for the whole file (1+2+4+8 processes,
started together); the JAX side runs on the conftest's 8 virtual devices.
From weights carried from JAX's ``init_params(key(0))``
(``params_from_jax``, then ``shard_params``):

- every rank's block of every leaf is, bit for bit, the JAX leaf's
  ``addressable_shards`` entry on device r of ``make_mesh(1, 2, 2)`` and of
  ``make_mesh(2, 2, 2)``;
- in f32 at (1,1,2), (1,2,1) and (1,2,2), and at (1,2,2) under remat (the
  fsdp gathers inside the checkpointed parts, run again in the backward),
  the sharded step's loss, every
  gathered gradient after the first step and every gathered parameter
  after three equal the one-process whole-batch step within ``F32_TOL`` of
  each leaf's largest magnitude (the bar of ``tests/test_torch_sharding.py``:
  the tp partial sums and the vocab-parallel lse are the same f32 sums in
  another order).  Over tp the
  parameters after three steps take ``F32_TP_PARAM_TOL``: measured 1.57e-5
  for Llama (gradients 1.1e-6), at one element of 8192 whose first
  gradient is 1.06e-8, AdamW's eps, where m / (sqrt(v) + eps) turns a
  difference of 7.6e-10 in the gradient (the tp partial sums) into 3 % of
  that element's update;
- in bf16 on (2,2,2), the 3-step loss trajectory equals JAX's
  ``train_demo`` on ``make_mesh(dp=2, fsdp=2, tp=2)`` within 5e-2
  (``tests/test_workloads.py:81``);
- ranks that hold the same block of a leaf (every rank for a replicated
  leaf) hold the same bits after the steps;
- each rank holds its specs' share of the parameters and of AdamW's state;
- K5's vocab-parallel plain twin over 2 and 4 blocks equals
  ``jax.nn.log_softmax``'s loss and ``jax.grad`` over the whole vocab at
  1e-6, with targets in every block and at both edges of each;
- a sharded step given whole weights raises; ``make_mesh()`` and
  ``auto_mesh()`` raise without a card unless asked for the CPU; a dim
  that does not divide raises.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes1_tpu.workloads import bert as jbert
from kubernetes1_tpu.workloads import llama as jllama
from kubernetes1_tpu.workloads import sharding as jsh
from kubernetes1_tpu_torch.kernels import cross_entropy as tce
from kubernetes1_tpu_torch.workloads import bert as tbert
from kubernetes1_tpu_torch.workloads import llama as tllama
from kubernetes1_tpu_torch.workloads import sharding

REPO = Path(__file__).resolve().parent.parent
F32_TOL = 1e-5
F32_TP_PARAM_TOL = 2e-5  # see the module docstring
JAX_LOSS_TOL = 5e-2  # tests/test_workloads.py:81
XENT_TOL = 1e-6
STEPS = 3
MODELS = ("llama", "bert")
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
DEMO = {"llama": (8, 64, 3e-4), "bert": (8, 32, 1e-3)}  # global batch, seq, lr
F32_MESHES = ((1, 1, 2), (1, 2, 1), (1, 2, 2))
F32_CASES = [(m, False) for m in F32_MESHES] + [((1, 2, 2), True)]  # (mesh, remat)
PLACED_MESHES = ((1, 2, 2), (2, 2, 2))
BF16_MESH = (2, 2, 2)
WHOLE_MESH = (1, 1, 2)
JMOD = {"llama": jllama, "bert": jbert}
TMOD = {"llama": tllama, "bert": tbert}


def _configs(model, dt, remat=False):
    jcfg = dataclasses.replace(JMOD[model].tiny(), dtype=DTYPES[dt][0])
    tcfg = dataclasses.replace(TMOD[model].tiny(), dtype=DTYPES[dt][1], remat=remat)
    return jcfg, tcfg


def _batch(model, jcfg):
    """The global batch each JAX train_demo makes, as numpy."""
    batch, n, _lr = DEMO[model]
    if model == "llama":
        return (np.random.default_rng(0).integers(0, jcfg.vocab, (batch, n)),)
    return tuple(np.asarray(a) for a in jbert.synthetic_batch(jcfg, batch, n))


def _tree(model, dt):
    jcfg, _ = _configs(model, dt)
    return jax.tree.map(np.asarray, JMOD[model].init_params(jcfg, jax.random.key(0)))


def _torch_params(model, tree, tcfg):
    if model == "llama":
        return tllama.params_from_jax(tree, tcfg, "cpu", dtype=torch.float32)
    return tbert.params_from_jax(tree, tcfg, "cpu")


def _jax_demo(model, mesh):
    """JAX's bf16 train_demo on ``mesh`` step by step: its 3 losses."""
    jcfg, _ = _configs(model, "bf16")
    batch = [jnp.asarray(a, jnp.int32) for a in _batch(model, jcfg)]
    jmod = JMOD[model]
    with jsh.use_mesh(mesh):
        params, opt_state, tx = jmod.make_train_state(jcfg, mesh, lr=DEMO[model][2])
        step = jmod.make_train_step(jcfg, mesh, tx)
        losses = []
        for _ in range(STEPS):
            params, opt_state, loss = step(params, opt_state, *batch)
            losses.append(float(loss))
    return losses


def _jax_shards(model, mesh):
    """JAX's placement on ``mesh`` by its ``make_train_state``: (the whole
    tree as numpy, and per device index each leaf's shard in the port's
    ``param_leaves`` order, a stacked layer leaf's shard split into its
    layers).  The whole tree is what the ranks shard: jit's init is not
    the eager ``init_params`` bit for bit (XLA multiplies by
    1/sqrt(fan_in) where fan_in is not a square of a power of two)."""
    jcfg, tcfg = _configs(model, "f32")
    devices = list(mesh.devices.flat)
    with jsh.use_mesh(mesh):
        params, _, _ = JMOD[model].make_train_state(jcfg, mesh)
    whole = jax.tree.map(np.asarray, params)
    out = {r: {} for r in range(len(devices))}

    def walk(tree, path):
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                walk(leaf, path + (key,))
                continue
            for sh in leaf.addressable_shards:
                out[devices.index(sh.device)][path + (key,)] = np.asarray(sh.data)

    walk(params, ())
    order = []
    for r, leaves in out.items():
        tree = {k[-1]: v for k, v in leaves.items() if len(k) == 1}
        tree["layers"] = {k[-1]: v for k, v in leaves.items() if len(k) == 2}
        order.append(TMOD[model].param_leaves(_torch_params(model, tree, tcfg)))
    return whole, order


# ------------------------------------------------------------ gloo ranks

_WORKER = r"""
import pickle
import sys
import torch
import torch.distributed as dist
from kubernetes1_tpu_torch.workloads import bert, llama, sharding

rank, n, store, inp, out = int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, n), rank=rank, world_size=n)
try:
    with open(inp, "rb") as f:
        jobs = pickle.load(f)
    mods = {"llama": llama, "bert": bert}
    res = []
    for job in jobs:
        mod, cfg = mods[job["model"]], job["cfg"]
        mesh = sharding.make_mesh(*job["mesh"], device_type="cpu")
        if job["model"] == "llama":
            params = llama.params_from_jax(job["tree"], cfg, "cpu", dtype=torch.float32)
        else:
            params = bert.params_from_jax(job["tree"], cfg, "cpu")
        specs = sharding.spec_leaves(mod.param_specs(cfg), cfg.n_layers, mod.param_leaves)
        if job["kind"] == "placement":
            blocks = sharding.shard_params(params, mod.param_specs(cfg), mesh)
            res.append(dict(blocks=mod.param_leaves(blocks)))
            continue
        if job["kind"] == "whole":  # whole weights handed to a sharded step
            try:
                mod.make_train_step(cfg, params, None, mesh=mesh)
                res.append(dict(error=None))
            except ValueError as e:
                res.append(dict(error=str(e)))
            continue
        _, opt = mod.make_train_state(cfg, "cpu", lr=job["lr"], params=params, mesh=mesh)
        step = mod.make_train_step(cfg, params, opt, mesh=mesh)
        leaves = mod.param_leaves(params)
        batch = [torch.from_numpy(a) for a in job["batch"]]
        losses = []
        for i in range(job["steps"]):
            losses.append(step(*batch).item())
            if i == 0:
                grads = [sharding.gather_tensor(p.grad, s, mesh) for p, s in zip(leaves, specs)]
        state = [t for p in leaves for t in opt.state[p].values()]
        res.append(dict(
            losses=losses, grads=grads, coord=tuple(mesh.get_coordinate()),
            blocks=[p.detach().clone() for p in leaves],
            params=mod.param_leaves(sharding.gather_params(params, mod.param_specs(cfg), mesh)),
            param_numel=sum(p.numel() for p in leaves), state_numel=sum(t.numel() for t in state),
            want_numel=sharding.spec_numel([job["shapes"][i] for i in range(len(leaves))],
                                           specs, mesh)))
    torch.save(res, out % rank)
finally:
    dist.destroy_process_group()
"""


def _start(tmp, n, jobs):
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(jobs, f)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    logs = [open(tmp / f"err{r}.log", "w") for r in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(n), str(tmp / "store"), str(tmp / "in.pkl"),
         str(tmp / "out%d.pt")], cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=logs[r])
        for r in range(n)]
    return tmp, n, procs, logs


def _finish(run):
    tmp, n, procs, logs = run
    try:
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    errs = "\n".join((tmp / f"err{r}.log").read_text()[-3000:] for r in range(n))
    assert rcs == [0] * n, errs
    return [torch.load(tmp / f"out{r}.pt", weights_only=False) for r in range(n)]


def _job(kind, mesh, model, dt, tree, remat=False):
    jcfg, tcfg = _configs(model, dt, remat)
    whole = TMOD[model].param_leaves(_torch_params(model, tree, tcfg))
    return dict(kind=kind, mesh=mesh, model=model, cfg=tcfg, tree=tree, batch=_batch(model, jcfg),
                lr=DEMO[model][2], steps=STEPS, shapes=[tuple(t.shape) for t in whole])


@pytest.fixture(scope="module")
def trees():
    return {(m, dt): _tree(m, dt) for m in MODELS for dt in DTYPES}


@pytest.fixture(scope="module")
def placements():
    return {(m, mesh): _jax_shards(m, jsh.make_mesh(*mesh))
            for m in MODELS for mesh in PLACED_MESHES}


@pytest.fixture(scope="module")
def ranks(trees, placements, tmp_path_factory):
    """world size -> (the jobs, each rank's results per job); the worlds
    of 2, 4 and 8 ranks run at once."""
    worlds = {2: [], 4: [], 8: []}
    for mesh, remat in F32_CASES:
        for m in MODELS:
            worlds[int(np.prod(mesh))].append(_job("f32-remat" if remat else "f32", mesh, m,
                                                   "f32", trees[m, "f32"], remat))
    for mesh in PLACED_MESHES:
        for m in MODELS:
            worlds[int(np.prod(mesh))].append(_job("placement", mesh, m, "f32",
                                                   placements[m, mesh][0]))
    for m in MODELS:
        worlds[8].append(_job("bf16", BF16_MESH, m, "bf16", trees[m, "bf16"]))
        worlds[2].append(_job("whole", WHOLE_MESH, m, "f32", trees[m, "f32"]))
    runs = {n: _start(tmp_path_factory.mktemp(f"world{n}"), n, jobs) for n, jobs in worlds.items()}
    return {n: (worlds[n], _finish(run)) for n, run in runs.items()}


def _results(ranks, kind, mesh, model):
    """Each rank's result of the job (kind, mesh, model)."""
    jobs, per_rank = ranks[int(np.prod(mesh))]
    i = next(i for i, j in enumerate(jobs)
             if (j["kind"], j["mesh"], j["model"]) == (kind, mesh, model))
    return [res[i] for res in per_rank]


def _whole_batch(model, tree):
    """The one-process f32 step on the whole batch: (losses, gradients
    after the first step, parameters after the last)."""
    jcfg, tcfg = _configs(model, "f32")
    mod = TMOD[model]
    params = _torch_params(model, tree, tcfg)
    _, opt = mod.make_train_state(tcfg, "cpu", params=params, lr=DEMO[model][2])
    step = mod.make_train_step(tcfg, params, opt)
    leaves = mod.param_leaves(params)
    batch = [torch.from_numpy(np.array(a)) for a in _batch(model, jcfg)]
    losses = []
    for i in range(STEPS):
        losses.append(step(*batch).item())
        if i == 0:
            grads = [p.grad.clone() for p in leaves]
    return losses, grads, [p.detach() for p in leaves]


def _leaf_err(got, want) -> float:
    """max |got - want| over the leaf's largest magnitude."""
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("mesh", PLACED_MESHES, ids=lambda m: "x".join(map(str, m)))
def test_every_rank_holds_the_jax_shard_of_device_r(ranks, placements, model, mesh):
    want = placements[model, mesh][1]
    got = _results(ranks, "placement", mesh, model)
    assert len(got) == len(want)
    for r, (res, leaves) in enumerate(zip(got, want)):
        assert len(res["blocks"]) == len(leaves)
        for i, (a, b) in enumerate(zip(res["blocks"], leaves)):
            assert a.shape == b.shape and torch.equal(a, b), (model, mesh, r, i)
    # the mesh splits something: a leaf whose blocks differ between ranks
    assert not torch.equal(got[0]["blocks"][0], got[-1]["blocks"][0])


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("mesh,remat", F32_CASES, ids=[
    "x".join(map(str, m)) + ("-remat" if r else "") for m, r in F32_CASES])
def test_sharded_f32_step_equals_the_whole_batch_step(ranks, trees, model, mesh, remat):
    losses, grads, params = _whole_batch(model, trees[model, "f32"])
    got = _results(ranks, "f32-remat" if remat else "f32", mesh, model)[0]
    for a, b in zip(got["losses"], losses):
        assert abs(a - b) <= F32_TOL * max(1.0, abs(b))
    assert len(got["grads"]) == len(grads)
    for i, (g, w) in enumerate(zip(got["grads"], grads)):
        assert _leaf_err(g, w) <= F32_TOL, (model, mesh, "grad", i, _leaf_err(g, w))
    tol = F32_TOL if mesh[2] == 1 else F32_TP_PARAM_TOL
    for i, (p, w) in enumerate(zip(got["params"], params)):
        assert _leaf_err(p, w) <= tol, (model, mesh, "param", i, _leaf_err(p, w))


@pytest.mark.parametrize("model", MODELS)
def test_bf16_trajectory_matches_jax_train_demo_on_dp2_fsdp2_tp2(ranks, model):
    jlosses = _jax_demo(model, jsh.make_mesh(*BF16_MESH))
    tlosses = _results(ranks, "bf16", BF16_MESH, model)[0]["losses"]
    assert max(abs(a - b) for a, b in zip(jlosses, tlosses)) <= JAX_LOSS_TOL, (jlosses, tlosses)
    assert tlosses[-1] < tlosses[0]


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("kind,mesh", [("f32", (1, 2, 2)), ("bf16", BF16_MESH)],
                         ids=["f32-1x2x2", "bf16-2x2x2"])
def test_ranks_that_hold_one_block_hold_the_same_bits(ranks, model, kind, mesh):
    """After the steps, every rank's block of a leaf equals that of every
    other rank at the same block coordinates (a replicated leaf: every
    rank), and the losses agree."""
    runs = _results(ranks, kind, mesh, model)
    cfg = _configs(model, "f32")[1]
    specs = sharding.spec_leaves(TMOD[model].param_specs(cfg), cfg.n_layers,
                                 TMOD[model].param_leaves)
    replicated = 0
    for i, spec in enumerate(specs):
        axes = [sharding.DIMS.index(a) for e in spec for a in sharding._axes(e)]
        replicated += not axes
        by_block = {}
        for res in runs:
            key = tuple(res["coord"][a] for a in axes)
            first = by_block.setdefault(key, res["blocks"][i])
            assert torch.equal(first, res["blocks"][i]), (model, mesh, i, key)
        assert len(by_block) == int(np.prod([mesh[a] for a in axes]))
    assert replicated > 0
    assert all(res["losses"] == runs[0]["losses"] for res in runs)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("mesh", F32_MESHES + (BF16_MESH,), ids=lambda m: "x".join(map(str, m)))
def test_each_rank_holds_its_share_of_params_and_adamw_state(ranks, model, mesh):
    kind = "bf16" if mesh == BF16_MESH else "f32"
    for res in _results(ranks, kind, mesh, model):
        assert res["param_numel"] == res["want_numel"]
        assert res["state_numel"] == 2 * res["want_numel"]  # AdamW's m and v
    whole = sum(int(np.prod(s)) for s in _job(kind, mesh, model, kind,
                                              _tree(model, kind))["shapes"])
    assert res["want_numel"] < whole


@pytest.mark.parametrize("model", MODELS)
def test_a_sharded_step_refuses_whole_weights(ranks, model):
    """Whole weights over tp would run every head on both ranks and add
    the ranks' sums: the step raises before it runs, naming the fix."""
    for res in _results(ranks, "whole", WHOLE_MESH, model):
        assert res["error"] is not None and "make_train_state(mesh=)" in res["error"]
        assert "is (" in res["error"] and "block of" in res["error"]


# ------------------------------------------------------- in one process


@pytest.mark.parametrize("blocks", [2, 4])
def test_vocab_parallel_cross_entropy_plain_over_blocks_matches_jax(blocks):
    rows, vocab = 12, 64
    width = vocab // blocks
    rng = np.random.default_rng(blocks)
    logits = (rng.standard_normal((rows, vocab)) * 3).astype(np.float32)
    # every block, and both edges of each
    targets = np.array([b * width + e for b in range(blocks) for e in (0, width - 1)]
                       + list(rng.integers(0, vocab, rows - 2 * blocks)))[:rows]
    cot = rng.uniform(0.5, 1.5, rows).astype(np.float32)

    def jloss(x):
        logp = jax.nn.log_softmax(x, axis=-1)
        return -jnp.take_along_axis(logp, jnp.asarray(targets)[:, None], axis=-1)[:, 0]

    want, vjp = jax.vjp(jloss, jnp.asarray(logits))
    want_grad = np.asarray(vjp(jnp.asarray(cot))[0])
    x, t, g = (torch.from_numpy(a) for a in (logits, targets.astype(np.int64), cot))
    parts = [tce.cross_entropy_part_plain(x[:, b * width:(b + 1) * width], t, b * width)
             for b in range(blocks)]
    lse = torch.logsumexp(torch.stack([p[0] for p in parts]), dim=0)
    loss = lse - sum(p[1] for p in parts)
    np.testing.assert_allclose(loss.numpy(), np.asarray(want), rtol=XENT_TOL, atol=XENT_TOL)
    grad = torch.cat([tce.cross_entropy_bwd_plain(x[:, b * width:(b + 1) * width],
                                                  t - b * width, lse, g)
                      for b in range(blocks)], dim=1)
    np.testing.assert_allclose(grad.numpy(), want_grad, rtol=XENT_TOL, atol=XENT_TOL)
    # the autograd Function over a group of one: the block is the vocab
    xl = x.clone().requires_grad_(True)
    one = tce.cross_entropy_vocab_parallel(xl, t, 0, None)
    one.backward(g)
    np.testing.assert_allclose(one.detach().numpy(), np.asarray(want), rtol=XENT_TOL,
                               atol=XENT_TOL)
    np.testing.assert_allclose(xl.grad.numpy(), want_grad, rtol=XENT_TOL, atol=XENT_TOL)


def test_lookup_of_a_bf16_table_adds_its_gradient_rows_in_f32():
    """BERT's lookup over fsdp reads the gathered bf16 table: a row picked
    many times (the MASK token) gets its gradients' f32 sum, rounded once."""
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.standard_normal((6, 8)).astype(np.float32)).to(torch.bfloat16)
    tokens = torch.from_numpy(np.concatenate([np.full(600, 2), rng.integers(0, 6, 40)]))
    g = torch.from_numpy(rng.standard_normal((640, 8)).astype(np.float32)).to(torch.bfloat16)
    t = table.clone().requires_grad_(True)
    out = sharding.Layout().lookup(t, tokens, ("tp", None), torch.bfloat16)
    assert torch.equal(out, table[tokens])
    out.backward(g)
    want = torch.zeros(6, 8).index_add_(0, tokens, g.float()).to(torch.bfloat16)
    assert torch.equal(t.grad, want)
    naive = table.clone().requires_grad_(True)
    naive[tokens].backward(g)
    assert not torch.equal(naive.grad, want)  # bf16 adds: the rounding this avoids


def test_mesh_without_a_card_raises_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    for call in (sharding.make_mesh, sharding.auto_mesh):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # asked for the CPU, they go on to want a process group
    with pytest.raises(RuntimeError, match="torchrun"):
        sharding.make_mesh(device_type="cpu")


class _Coord:
    """Enough of a DeviceMesh for the placement arithmetic."""

    def __init__(self, shape, coord):
        self.mesh_dim_names, self.shape, self._coord = sharding.DIMS, shape, coord

    def get_coordinate(self):
        return self._coord


def test_a_dim_that_does_not_divide_raises():
    # BERT-large's vocab splits over tp=2 (15261 rows a rank), not over 4
    t = torch.zeros(30522, 8)
    assert sharding.shard_tensor(t, ("tp", None), _Coord((1, 1, 2), (0, 0, 1))).shape == (15261, 8)
    with pytest.raises(ValueError, match="does not divide"):
        sharding.shard_tensor(t, ("tp", None), _Coord((1, 1, 4), (0, 0, 1)))
    # a tuple entry splits major-first: ("tp", "fsdp") at tp=1, fsdp=0 of (2, 2)
    t = torch.arange(8.0)
    got = sharding.shard_tensor(t, (("tp", "fsdp"),), _Coord((1, 2, 2), (0, 0, 1)))
    assert got.tolist() == [4.0, 5.0]
