"""Data parallelism in the PyTorch port against the JAX package's mesh.

``kubernetes1_tpu_torch/workloads/sharding.py`` builds JAX's ``(dp, fsdp,
tp)`` mesh as a ``DeviceMesh`` over one process per device; the Llama,
BERT and ResNet train steps take ``mesh=``: each data rank takes its rows
of the global batch, ResNet's batch norm takes its statistics over every
rank's rows (K8's split form with an all-reduce), BERT divides by the
global masked count, and the gradients are averaged (summed for BERT)
before the update.  The ranks here are gloo processes on the CPU that
import torch and the port, never JAX, spawned once per mesh for the whole
file (2 ranks, and 4 for Llama's dp=2 x fsdp=2); the JAX side runs here
on the conftest's virtual devices.  From weights carried from JAX's
``init_params(key(0))`` (``params_from_jax``):

- the mesh helpers: dims, ``auto_mesh``'s shape, ValueError past the
  world (``tests/test_workloads.py:27-32``), a tp mesh's dims;
- in f32, each model's data-parallel step (the loss, every gradient leaf
  after the first step, every parameter after three; Llama's and BERT's
  gathered from the ranks' blocks, where fsdp splits them) equals the one-process
  step on the whole batch within ``F32_TOL`` of each leaf's largest
  magnitude: the same sums in another order (the batch split, the
  all-reduce), a few f32 ulps of the leaf, where 1e-5 leaves room for the
  steps' amplification of them;
- BERT's batch gives the two ranks different masked counts;
- in bf16, the 3-step loss trajectory equals JAX's ``train_demo`` on
  ``make_mesh(dp=2)`` (and Llama's on ``make_mesh(dp=2, fsdp=2)``) within
  5e-2 (``tests/test_workloads.py:81``);
- every rank's parameters are the same bits after the steps;
- K8's autograd Function over the split kernels (each swapped for its
  plain version) equals the whole batch's plain batch norm;
- over one data rank, each model's steps through ``mesh=`` issue no
  collective and are the steps without a mesh, bit for bit;
- ``resnet_bench.run`` and ``llama_bench.run`` over 2 ranks report
  ``n_devices == 2``, the global batch, and the FLOPs of the whole batch
  (the one-process run's count); ``run_sweep`` refuses 2 ranks; each
  payload's ``python -m`` main on 2 launched ranks prints and writes its
  result from rank 0 alone.
"""

import dataclasses
import json
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
from kubernetes1_tpu.workloads import resnet as jresnet
from kubernetes1_tpu.workloads import sharding as jsh
from kubernetes1_tpu_torch.kernels import batchnorm as tbn
from kubernetes1_tpu_torch.workloads import bert as tbert
from kubernetes1_tpu_torch.workloads import llama as tllama
from kubernetes1_tpu_torch.workloads import llama_bench, resnet_bench
from kubernetes1_tpu_torch.workloads import resnet as tresnet

REPO = Path(__file__).resolve().parent.parent
F32_TOL = 1e-5
JAX_LOSS_TOL = 5e-2  # tests/test_workloads.py:81
STEPS = 3
MODELS = ("llama", "bert", "resnet")
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# each train_demo's defaults: global batch, sequence or image side, lr
DEMO = {"llama": (8, 64, 3e-4), "bert": (8, 32, 1e-3), "resnet": (8, 32, 0.1)}
BN_M, BN_C = 48, 16


def _configs(model, dt):
    jmod, tmod = {"llama": (jllama, tllama), "bert": (jbert, tbert),
                  "resnet": (jresnet, tresnet)}[model]
    jcfg = dataclasses.replace(jmod.tiny(), dtype=DTYPES[dt][0])
    tcfg = dataclasses.replace(tmod.tiny(), dtype=DTYPES[dt][1])
    return jcfg, tcfg


def _batch(model, jcfg):
    """The global batch each JAX train_demo makes, as numpy."""
    batch, n, _lr = DEMO[model]
    rng = np.random.default_rng(0)
    if model == "llama":
        return (rng.integers(0, jcfg.vocab, (batch, n)),)
    if model == "bert":
        return tuple(np.asarray(a) for a in jbert.synthetic_batch(jcfg, batch, n))
    return (rng.normal(size=(batch, n, n, 3)).astype(np.float32),
            rng.integers(0, jcfg.num_classes, batch))


def _torch_params(model, tree, tcfg):
    if model == "llama":
        return tllama.params_from_jax(tree, tcfg, "cpu", dtype=torch.float32)
    return {"bert": tbert, "resnet": tresnet}[model].params_from_jax(tree, tcfg, "cpu")


def _jax_demo(model, mesh, dt):
    """JAX's train_demo on ``mesh``, step by step: (its 3 losses, the
    initial weights as numpy)."""
    jcfg, _ = _configs(model, dt)
    batch = [jnp.asarray(a, jnp.int32 if a.dtype.kind == "i" else jnp.float32)
             for a in _batch(model, jcfg)]
    with jsh.use_mesh(mesh):
        if model == "resnet":
            import optax

            params = jresnet.init_params(jcfg, jax.random.key(0))
            tx = optax.sgd(0.1, momentum=0.9)
            opt_state = jax.jit(tx.init)(params)
            step = jresnet.make_train_step(jcfg, tx)
        else:
            jmod = jllama if model == "llama" else jbert
            params, opt_state, tx = jmod.make_train_state(jcfg, mesh, lr=DEMO[model][2])
            step = jmod.make_train_step(jcfg, mesh, tx)
        tree = jax.tree.map(np.asarray, params)  # the step donates its params
        losses = []
        for _ in range(STEPS):
            params, opt_state, loss = step(params, opt_state, *batch)
            losses.append(float(loss))
    return losses, tree


def _jax_tree(model, dt):
    """JAX's initial weights from key(0), as numpy (what its train_demo
    starts from)."""
    jcfg, _ = _configs(model, dt)
    jmod = {"llama": jllama, "bert": jbert, "resnet": jresnet}[model]
    return jax.tree.map(np.asarray, jmod.init_params(jcfg, jax.random.key(0)))


# ------------------------------------------------------------ gloo ranks

_WORKER = r"""
import pickle
import sys
import torch
import torch.distributed as dist
from kubernetes1_tpu_torch.kernels import batchnorm as tbn
from kubernetes1_tpu_torch.workloads import bert, llama, llama_bench, resnet, resnet_bench
from kubernetes1_tpu_torch.workloads import sharding

rank, n, store, inp, out = int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, n), rank=rank, world_size=n)
try:
    with open(inp, "rb") as f:
        data = pickle.load(f)
    res = {}
    mesh = sharding.make_mesh(**data["mesh"])
    res["mesh"] = (mesh.mesh_dim_names, tuple(mesh.shape), sharding.data_ranks(mesh),
                   tuple(sharding.auto_mesh("cpu").shape))
    tp_mesh = sharding.make_mesh(tp=n, device_type="cpu")
    res["tp_mesh"] = (tp_mesh.mesh_dim_names, tuple(tp_mesh.shape), sharding.data_ranks(tp_mesh))
    for call, exc in ((lambda: sharding.make_mesh(dp=2 * n, device_type="cpu"), ValueError),
                      (lambda: sharding.shard_batch(torch.zeros(n + 1), mesh), ValueError)):
        try:
            call()
            res.setdefault("not_raised", []).append(exc.__name__)
        except exc:
            pass
    mods = {"llama": llama, "bert": bert, "resnet": resnet}

    def train(model, case, mesh):
        mod = mods[model]
        if model == "llama":
            params = llama.params_from_jax(case["tree"], case["cfg"], "cpu", dtype=torch.float32)
            _, opt = llama.make_train_state(case["cfg"], "cpu", lr=case["lr"], params=params,
                                            mesh=mesh)
        elif model == "bert":
            params = bert.params_from_jax(case["tree"], case["cfg"], "cpu")
            _, opt = bert.make_train_state(case["cfg"], "cpu", lr=case["lr"], params=params,
                                           mesh=mesh)
        else:
            params = resnet.params_from_jax(case["tree"], case["cfg"], "cpu")
            _, opt = resnet.make_train_state(case["cfg"], "cpu", params=params, mesh=mesh)
        step = mod.make_train_step(case["cfg"], params, opt, mesh=mesh)
        leaves = mod.param_leaves(params)
        batch = [torch.from_numpy(a) for a in case["batch"]]

        def whole(ts):  # Llama's and BERT's blocks gathered from the ranks
            if mesh is None or model == "resnet":
                return ts
            specs = sharding.spec_leaves(mod.param_specs(case["cfg"]), case["cfg"].n_layers,
                                         mod.param_leaves)
            return [sharding.gather_tensor(t, s, mesh) for t, s in zip(ts, specs)]

        losses = []
        for i in range(case["steps"]):
            losses.append(step(*batch).item())
            if i == 0:
                grads = whole([p.grad.clone() for p in leaves])
        return dict(losses=losses, grads=grads, params=whole([p.detach() for p in leaves]))

    for (model, dt), case in data["cases"].items():
        res[model, dt] = train(model, case, mesh)
    if "world1" in data:
        # one data rank: the steps through mesh= issue no collective and are
        # the steps without a mesh, bit for bit
        calls = []
        real = {name: getattr(dist, name) for name in ("all_reduce", "broadcast",
                                                       "all_gather_into_tensor",
                                                       "reduce_scatter_tensor")}
        for name, fn in real.items():
            setattr(dist, name, lambda *a, _fn=fn, _name=name, **k: (calls.append(_name),
                                                                     _fn(*a, **k))[1])
        try:
            for model, case in data["world1"].items():
                res["world1", model] = [train(model, case, m) for m in (mesh, None)]
        finally:
            for name, fn in real.items():
                setattr(dist, name, fn)
        res["world1_calls"] = calls
    if "bn" in data:
        x, scale, bias, r, dy = (torch.from_numpy(a) for a in data["bn"])
        b = x.shape[0] // n
        rows = slice(rank * b, (rank + 1) * b)
        # the kernel path's autograd Function, each kernel its plain twin
        tbn.bn_sums_kernel = tbn.bn_sums_plain
        tbn.bn_fold_apply_kernel = tbn.bn_fold_apply_plain
        tbn.bn_bwd_sums_kernel = tbn.bn_bwd_sums_plain
        tbn.bn_bwd_dx_kernel = tbn.bn_bwd_dx_plain
        leaves = [t.clone().requires_grad_(True) for t in (x[rows], scale, bias, r[rows])]
        y = tbn.batchnorm_on_kernels(*leaves, True, group=sharding.data_group(mesh))
        y.backward(dy[rows])
        res["bn"] = [y.detach()] + [t.grad for t in leaves]
    if "bench" in data:
        res["resnet_bench"] = resnet_bench.run(batch=2, steps=1, size=32, warmup=1,
                                               profile=True, device="cpu", mesh=mesh)
        res["llama_bench"] = llama_bench.run("tiny", 4, 32, 1, "adamw", warmup=1, profile=True,
                                             device="cpu", mesh=mesh)
        try:
            llama_bench.run_sweep([2, 4], "tiny", 32, 1, "adamw", device="cpu", mesh=mesh)
        except ValueError:
            res["sweep_refused"] = True
    for v in res.values():
        if isinstance(v, dict):
            v.pop("profile", None)
    torch.save(res, out % rank)
finally:
    dist.destroy_process_group()
"""


def _spawn(tmp, n, data):
    """Run the worker on n gloo ranks; each rank's results."""
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(data, f)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    logs = [open(tmp / f"err{r}.log", "w") for r in range(n)]
    procs = []
    try:
        for r in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _WORKER, str(r), str(n), str(tmp / "store"),
                 str(tmp / "in.pkl"), str(tmp / "out%d.pt")],
                cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=logs[r]))
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    errs = "\n".join((tmp / f"err{r}.log").read_text() for r in range(n))
    assert rcs == [0] * n, errs
    return [torch.load(tmp / f"out{r}.pt", weights_only=False) for r in range(n)]


def _case(model, dt, tree):
    jcfg, tcfg = _configs(model, dt)
    return dict(tree=tree, cfg=tcfg, batch=_batch(model, jcfg), lr=DEMO[model][2], steps=STEPS)


def _bn_inputs():
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((BN_M, BN_C)) * 2 + 0.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, BN_C).astype(np.float32)
    bias, r, dy = ((rng.standard_normal(s) * 0.3).astype(np.float32)
                   for s in ((BN_C,), (BN_M, BN_C), (BN_M, BN_C)))
    return x, scale, bias, r, dy


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's bf16 train_demo step by step on make_mesh(dp=2) for every
    model, and Llama's on make_mesh(dp=2, fsdp=2): key -> (losses, the
    initial weights as numpy)."""
    out = {(m, "dp2"): _jax_demo(m, jsh.make_mesh(dp=2), "bf16") for m in MODELS}
    out["llama", "dp2fsdp2"] = _jax_demo("llama", jsh.make_mesh(dp=2, fsdp=2), "bf16")
    return out


@pytest.fixture(scope="module")
def f32_trees():
    return {m: _jax_tree(m, "f32") for m in MODELS}


@pytest.fixture(scope="module")
def two_ranks(jax_runs, f32_trees, tmp_path_factory):
    cases = {(m, "bf16"): _case(m, "bf16", jax_runs[m, "dp2"][1]) for m in MODELS}
    cases.update({(m, "f32"): _case(m, "f32", f32_trees[m]) for m in MODELS})
    return _spawn(tmp_path_factory.mktemp("dp2"), 2,
                  dict(mesh=dict(dp=2, device_type="cpu"), cases=cases, bn=_bn_inputs(),
                       bench=True))


@pytest.fixture(scope="module")
def four_ranks(jax_runs, f32_trees, tmp_path_factory):
    cases = {("llama", "bf16"): _case("llama", "bf16", jax_runs["llama", "dp2fsdp2"][1]),
             ("llama", "f32"): _case("llama", "f32", f32_trees["llama"])}
    return _spawn(tmp_path_factory.mktemp("dp2fsdp2"), 4,
                  dict(mesh=dict(dp=2, fsdp=2, device_type="cpu"), cases=cases))


@pytest.fixture(scope="module")
def one_rank(f32_trees, tmp_path_factory):
    """One gloo rank: each model's f32 steps through make_mesh(dp=1) and
    without a mesh, and the collectives the meshed steps issued."""
    return _spawn(tmp_path_factory.mktemp("dp1"), 1,
                  dict(mesh=dict(dp=1, device_type="cpu"), cases={},
                       world1={m: _case(m, "f32", f32_trees[m]) for m in MODELS}))[0]


def _whole_batch(model, tree):
    """The one-process f32 step on the whole batch, from the same weights:
    (losses, gradients after the first step, parameters after the last)."""
    jcfg, tcfg = _configs(model, "f32")
    mod = {"llama": tllama, "bert": tbert, "resnet": tresnet}[model]
    params = _torch_params(model, tree, tcfg)
    kw = {} if model == "resnet" else {"lr": DEMO[model][2]}
    _, opt = mod.make_train_state(tcfg, "cpu", params=params, **kw)
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


def test_mesh_helpers_over_two_ranks(two_ranks):
    for res in two_ranks:
        names, shape, ranks, auto = res["mesh"]
        assert names == ("dp", "fsdp", "tp") and shape == (2, 1, 1) and ranks == 2
        assert auto == (1, 2, 1)  # every rank fsdp, up to 8
        assert res["tp_mesh"] == (("dp", "fsdp", "tp"), (1, 1, 2), 1)
        assert "not_raised" not in res, res["not_raised"]


def test_mesh_helpers_over_four_ranks(four_ranks):
    for res in four_ranks:
        names, shape, ranks, auto = res["mesh"]
        assert names == ("dp", "fsdp", "tp") and shape == (2, 2, 1) and ranks == 4
        assert auto == (1, 4, 1)
        assert res["tp_mesh"] == (("dp", "fsdp", "tp"), (1, 1, 4), 1)
        assert "not_raised" not in res, res["not_raised"]


def test_bert_ranks_see_different_masked_counts():
    jcfg, _ = _configs("bert", "bf16")
    _tokens, mask = _batch("bert", jcfg)
    half = mask.shape[0] // 2
    assert mask[:half].sum() != mask[half:].sum()


@pytest.mark.parametrize("model", MODELS)
def test_data_parallel_step_equals_the_whole_batch_step_f32(two_ranks, f32_trees, model):
    losses, grads, params = _whole_batch(model, f32_trees[model])
    got = two_ranks[0][model, "f32"]
    for a, b in zip(got["losses"], losses):
        assert abs(a - b) <= F32_TOL * max(1.0, abs(b))
    assert len(got["grads"]) == len(grads)
    for i, (g, w) in enumerate(zip(got["grads"], grads)):
        assert _leaf_err(g, w) <= F32_TOL, (model, i, _leaf_err(g, w))
    for i, (p, w) in enumerate(zip(got["params"], params)):
        assert _leaf_err(p, w) <= F32_TOL, (model, i, _leaf_err(p, w))


def test_llama_dp2_fsdp2_step_equals_the_whole_batch_step_f32(four_ranks, f32_trees):
    losses, grads, params = _whole_batch("llama", f32_trees["llama"])
    got = four_ranks[0]["llama", "f32"]
    for a, b in zip(got["losses"], losses):
        assert abs(a - b) <= F32_TOL * max(1.0, abs(b))
    for g, w in zip(got["grads"], grads):
        assert _leaf_err(g, w) <= F32_TOL
    for p, w in zip(got["params"], params):
        assert _leaf_err(p, w) <= F32_TOL


@pytest.mark.parametrize("model", MODELS)
def test_bf16_trajectory_matches_jax_train_demo_on_dp2(two_ranks, jax_runs, model):
    jlosses = jax_runs[model, "dp2"][0]
    tlosses = two_ranks[0][model, "bf16"]["losses"]
    assert max(abs(a - b) for a, b in zip(jlosses, tlosses)) <= JAX_LOSS_TOL
    assert tlosses[-1] < tlosses[0]


def test_llama_bf16_trajectory_matches_jax_train_demo_on_dp2_fsdp2(four_ranks, jax_runs):
    jlosses = jax_runs["llama", "dp2fsdp2"][0]
    tlosses = four_ranks[0]["llama", "bf16"]["losses"]
    assert max(abs(a - b) for a, b in zip(jlosses, tlosses)) <= JAX_LOSS_TOL


def test_jax_runs_are_train_demo(jax_runs):
    """The step-by-step JAX runs are what train_demo computes: its final
    loss, from the same initial weights and batch."""
    cfg, _ = _configs("llama", "bf16")
    final = jllama.train_demo(cfg, jsh.make_mesh(dp=2), steps=STEPS)
    assert final == pytest.approx(jax_runs["llama", "dp2"][0][-1], abs=1e-6)


@pytest.mark.parametrize("ranks", ["two", "four"])
def test_every_rank_holds_the_same_bits(two_ranks, four_ranks, ranks):
    runs = two_ranks if ranks == "two" else four_ranks
    for key, first in runs[0].items():
        if not isinstance(key, tuple):
            continue
        for other in runs[1:]:
            assert other[key]["losses"] == first["losses"], key
            for p, q in zip(first["params"], other[key]["params"]):
                assert torch.equal(p, q), key


@pytest.mark.parametrize("model", MODELS)
def test_one_data_rank_step_is_the_step_without_a_mesh(one_rank, model):
    """Over one data rank the steps issue no collective (no broadcast, no
    all-reduce of gradients or loss, ResNet's batch norm on its one-launch
    path) and give the steps without a mesh bit for bit."""
    meshed, alone = one_rank["world1", model]
    assert meshed["losses"] == alone["losses"]
    for a, b in zip(meshed["grads"] + meshed["params"], alone["grads"] + alone["params"]):
        assert torch.equal(a, b)
    assert one_rank["world1_calls"] == []


def test_split_batchnorm_function_over_two_ranks_equals_the_whole_batch(two_ranks):
    x, scale, bias, r, dy = (torch.from_numpy(a) for a in _bn_inputs())
    leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias, r)]
    y = tbn.batchnorm_plain(*leaves, True)
    y.backward(dy)
    ys, dxs, dss, dbs, drs = zip(*(res["bn"] for res in two_ranks))
    for got, want in ((torch.cat(ys), y), (torch.cat(dxs), leaves[0].grad),
                      (torch.cat(drs), leaves[3].grad), (sum(dss), leaves[1].grad),
                      (sum(dbs), leaves[2].grad)):
        assert _leaf_err(got.detach(), want.detach()) <= F32_TOL


def test_bench_payloads_count_the_global_batch_over_two_ranks(two_ranks):
    # the ranks' runs, in one process (the profiled step too)
    rn = resnet_bench.run(batch=2, steps=1, size=32, warmup=1, profile=True, device="cpu")
    lb = llama_bench.run("tiny", 4, 32, 1, "adamw", warmup=1, profile=True, device="cpu")
    assert rn["n_devices"] == lb["n_devices"] == 1
    for res in two_ranks:
        r2, l2 = res["resnet_bench"], res["llama_bench"]
        assert r2["n_devices"] == l2["n_devices"] == 2
        assert r2["batch"] == 2 and l2["batch"] == 4
        assert r2["flops_per_step"] == rn["flops_per_step"]
        assert l2["exec_flops_per_step"] == lb["exec_flops_per_step"]
        assert l2["model_flops_per_step"] == lb["model_flops_per_step"]
        assert r2["imgs_per_sec_per_device"] == pytest.approx(r2["imgs_per_sec"] / 2, abs=0.1)
        assert l2["tokens_per_sec_per_device"] == pytest.approx(l2["tokens_per_sec"] / 2,
                                                                abs=0.1)
        # the same weights and global batch as the one-process run: the
        # bf16 loss within the JAX suite's bar (ResNet-50's first, before
        # SGD at lr 0.1 on 2 images has a chance to diverge)
        assert abs(r2["first_loss"] - rn["first_loss"]) <= JAX_LOSS_TOL
        assert abs(l2["final_loss"] - lb["final_loss"]) <= JAX_LOSS_TOL
        assert res["sweep_refused"]


# each payload's global batch and its other arguments
PAYLOAD_ARGS = {
    "resnet_bench": (2, ["--steps", "1", "--size", "32"]),
    "llama_bench": (4, ["--preset", "tiny", "--seq", "32", "--steps", "1",
                        "--optimizer", "adamw"]),
}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("payload", sorted(PAYLOAD_ARGS))
def test_payload_main_over_two_launched_ranks_reports_from_rank_0_alone(tmp_path, payload):
    """``python -m <payload>`` on 2 ranks as ``torchrun`` starts them (the
    launcher's environment, one --out for both): rank 0 alone prints the
    result and writes the file, which holds the run over both ranks."""
    out = tmp_path / "r.json"
    batch, args = PAYLOAD_ARGS[payload]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "WORLD_SIZE": "2",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}
    procs = [subprocess.Popen(
        [sys.executable, "-m", f"kubernetes1_tpu_torch.workloads.{payload}", "--device", "cpu",
         "--no-profile", "--out", str(out), "--batch", str(batch), *args],
        cwd=REPO, env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(err for _, err in outs)
    (out0, _), (out1, _) = outs
    assert out1 == ""
    lines = out0.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(out.read_text())
    assert json.loads(lines[0]) == res
    assert res["n_devices"] == 2 and res["batch"] == batch


# ------------------------------------------------------- in one process


def test_no_mesh_without_a_launcher(monkeypatch, capsys):
    """Without a launcher's environment and without a group, an entry point
    runs on one device, makes no group, and says where more cards are
    visible how to use them."""
    from torch import distributed as dist

    from kubernetes1_tpu_torch.workloads import sharding

    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    assert sharding.launched_mesh(torch.device("cpu")) is None
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="torchrun"):
        sharding.make_mesh(dp=1, device_type="cpu")
    assert sharding.data_ranks(None) == 1 and sharding.is_rank0()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "H100")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    capsys.readouterr()
    assert sharding.launched_mesh(torch.device("cuda")) is None
    line = capsys.readouterr().out
    assert "4 cards visible" in line and "cuda:0" in line
    assert "torchrun --nproc-per-node=4" in line and line.count("\n") == 1


def test_gradient_buckets_keep_order_dtype_and_limit():
    from kubernetes1_tpu_torch.workloads import sharding

    ts = [torch.zeros(n, dtype=dt) for n, dt in ((10, torch.float32), (20, torch.float32),
                                                 (100, torch.float32), (5, torch.float32),
                                                 (5, torch.bfloat16), (5, torch.float32))]
    buckets = sharding._buckets(ts, limit=128)
    assert [[t.numel() for t in b] for b in buckets] == [[10, 20], [100], [5], [5], [5]]
    assert [t for b in buckets for t in b] == ts
