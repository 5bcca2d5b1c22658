"""Parity of the PyTorch port's ResNet (model, train step, bench payload)
against the JAX package, on the CPU.

The same inputs, drawn with numpy from a seed, go through the JAX function
and its counterpart in ``kubernetes1_tpu_torch``; weights are carried from
the JAX pytree by ``params_from_jax`` (conv HWIO -> OIHW).

- Batch norm (K8): ``bn_bwd_plain`` (the formula the CUDA backward
  computes), autograd of the plain forward, and the autograd Function with
  each kernel swapped for its plain twin, against ``jax.vjp`` of JAX's
  ``_bn`` with the ReLU and residual around it, in f32: 1e-5 relative to
  max(1, max |reference|), including a clamped variance and a tie.
- ``_conv`` and the max pool against JAX's "SAME" on 15, 16 and 17 pixels.
- ``forward``: f32 logits 1e-4 relative to max(1, max |reference|); bf16
  loss 5e-2 (tests/test_workloads.py:81).  The full-width config (one
  block per stage) runs at 64 x 64: at 32 x 32 its last stage is 1 x 1,
  so batch 2 gives the batch statistics M = 2 rows, where E[x²] − E[x]²
  cancels to a few significant bits and one ulp of summation order in
  either framework moves the logits by ~1e-3; at 64 x 64 (M = 8) both
  agree to ~2e-5.
- Every gradient leaf (f32, relative L2 1e-4) and a 3-step SGD trajectory
  against JAX's ``make_train_step`` (f32 1e-3, bf16 5e-2).
- The launches per train step that ``chip_smoke.py`` asserts on the card.

JAX sums the bf16 gradients of the folded ``w`` and ``b`` in bf16; the
port sums them in f32 (a known deviation, invisible in f32).
"""

import dataclasses
import json
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubernetes1_tpu.workloads import resnet as jresnet
from kubernetes1_tpu_torch import optim as toptim
from kubernetes1_tpu_torch.kernels import batchnorm as tbn
from kubernetes1_tpu_torch.kernels import cross_entropy as txent
from kubernetes1_tpu_torch.workloads import benchguard, gpu_peaks
from kubernetes1_tpu_torch.workloads import resnet as tresnet
from kubernetes1_tpu_torch.workloads import resnet_bench

REPO = Path(__file__).resolve().parent.parent
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
FULL_WIDTH_ONE_BLOCK = ((1, 64), (1, 128), (1, 256), (1, 512))
# the keys of the JAX payload's result (resnet_bench.py:106-124)
JAX_RESULT_KEYS = {"workload", "device_kind", "platform", "n_devices", "device_granularity",
                   "batch", "image_size", "steps", "compile_s", "step_time_ms", "imgs_per_sec",
                   "imgs_per_sec_per_device", "flops_per_step", "peak_flops_per_device", "mfu",
                   "final_loss", "profile"}
# a constant f32 value whose E[x²] − E[x]² over 3 rows rounds below 0
CLAMPED = np.float32(0.7498327493667603)


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel_err(got, want) -> float:
    """max |got - want| / max(1, max |want|)."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.detach().float().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / max(1.0, float(np.max(np.abs(want)))))


def _rel_l2(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


# ------------------------------------------------- batch norm against JAX


def _jax_bn(relu, residual):
    def fn(x, scale, bias, r):
        M, C = x.shape
        y = jresnet._bn(x.reshape(M, 1, 1, C), {"scale": scale, "bias": bias}).reshape(M, C)
        if residual:
            y = r + y
        return jax.nn.relu(y) if relu else y
    return fn


def _bn_inputs(case):
    """x (M, C), scale, bias, r, dy for one named case."""
    M, C = {"37x24": (37, 24), "64x16": (64, 16), "clamped": (3, 8), "tie": (1, 8)}[case]
    x = _np(1, M, C, scale=2.0) + 0.5
    if case == "clamped":
        x[:, 3] = CLAMPED  # channel 3: a clamped variance
    scale = np.random.default_rng(2).uniform(0.5, 1.5, C).astype(np.float32)
    bias = _np(3, C, scale=0.3)
    return x, scale, bias, _np(4, M, C), _np(5, M, C)


VARIANTS = {"plain": (False, False), "relu": (True, False), "relu_residual": (True, True)}


@pytest.fixture
def bn_kernels_as_plain(monkeypatch):
    """The three kernel functions replaced by their plain twins; yields
    the count of calls, as the kernels' launch counters would count them."""
    calls = Counter()
    for name, twin, counter in (("bn_stats_kernel", tbn.bn_stats_plain, "bn_stats"),
                                ("bn_apply_kernel", tbn.bn_apply_plain, "bn_apply"),
                                ("bn_bwd_kernel", tbn.bn_bwd_plain, "bn_bwd")):
        def counted(*a, _twin=twin, _counter=counter, **k):
            calls[_counter] += 1
            return _twin(*a, **k)
        monkeypatch.setattr(tbn, name, counted)
    return calls


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("case", ["37x24", "64x16", "clamped", "tie"])
def test_batchnorm_forward_and_vjp_match_jax(bn_kernels_as_plain, case, variant):
    relu, residual = VARIANTS[variant]
    x, scale, bias, r, dy = _bn_inputs(case)
    jfn = _jax_bn(relu, residual)
    jy, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (x, scale, bias, r)))
    jdx, jds, jdb, jdr = vjp(jnp.asarray(dy))
    if case in ("clamped", "tie"):  # the case covers what it names
        xj = jnp.asarray(x)
        d = np.asarray(jnp.mean(jnp.square(xj), 0) - jnp.square(jnp.mean(xj, 0)))
        assert (d[3] < 0) if case == "clamped" else (d == 0).all(), d

    tx, ts, tb, tr_, tdy = (_t(a) for a in (x, scale, bias, r, dy))
    rr = tr_ if residual else None
    w, b, stats = tbn.bn_stats_plain(tx, ts, tb)
    y, mask = tbn.bn_apply_plain(tx, w, b, rr, relu)
    assert _rel_err(y, jy) <= 1e-5
    dx, dr, dscale, dbias = tbn.bn_bwd_plain(tx, mask, tdy, w, ts, stats, residual)
    for got, want in ((dx, jdx), (dscale, jds), (dbias, jdb)):
        assert _rel_err(got, want) <= 1e-5
    assert (dr is None) if not residual else _rel_err(dr, jdr) <= 1e-5

    # autograd of the plain forward, and the Function on the kernels' twins
    for fn in (tbn.batchnorm_plain, tbn.batchnorm_on_kernels):
        leaves = [a.clone().requires_grad_(True) for a in (tx, ts, tb, tr_)]
        out = fn(*leaves[:3], leaves[3] if residual else None, relu)
        assert _rel_err(out, jy) <= 1e-5
        out.backward(tdy)
        for leaf, want in zip(leaves, (jdx, jds, jdb, jdr)):
            if leaf is leaves[3] and not residual:
                assert leaf.grad is None
            else:
                assert _rel_err(leaf.grad, want) <= 1e-5
    assert dict(bn_kernels_as_plain) == {"bn_stats": 1, "bn_apply": 1, "bn_bwd": 1}


def test_batchnorm_bf16_plain_rounds_w_and_b_to_bf16():
    """bf16 activations: w and b are the f32 fold rounded once, the output
    bf16, and the backward's dx bf16 with f32 dscale and dbias."""
    x = _t(_np(6, 50, 16, scale=3.0)).bfloat16()
    scale, bias = _t(np.linspace(0.5, 1.5, 16)), _t(np.linspace(-1, 1, 16))
    w, b, stats = tbn.bn_stats_plain(x, scale, bias)
    xf = x.float()
    inv = torch.rsqrt(xf.var(0, unbiased=False) + tbn.EPS) * scale
    assert w.dtype == b.dtype == torch.bfloat16 and stats.dtype == torch.float32
    assert torch.allclose(w.float(), inv, rtol=2 ** -8)
    y, mask = tbn.bn_apply_plain(x, w, b, relu=True)
    dx, dr, ds, db = tbn.bn_bwd_plain(x, mask, torch.ones_like(x), w, scale, stats)
    assert y.dtype == dx.dtype == torch.bfloat16 and ds.dtype == db.dtype == torch.float32
    assert dr is None and (y >= 0).all()


def test_batchnorm_kernel_path_refuses_channels_not_a_multiple_of_8():
    with pytest.raises(ValueError, match="C % 8"):
        tbn._check("bn_stats", torch.zeros(4, 12))
    resident = 2 * 132  # two blocks of 512 on each of an H100's SMs
    assert tbn.num_partials(1, 8, resident) == 1
    assert tbn.num_partials(128 * 112 * 112, 64, resident) == resident
    assert tbn.num_partials(128 * 7 * 7, 2048, resident) == resident // 16


# ------------------------------------------------------ conv and max pool


def test_same_padding_worked_cases():
    sp = tresnet.same_padding
    assert sp(224, 7, 2) == (2, 3)
    assert sp(56, 3, 2) == (0, 1)
    assert sp(56, 1, 2) == (0, 0)
    assert sp(15, 7, 2) == (3, 3)
    assert sp(112, 3, 2) == (0, 1)
    assert sp(56, 3, 1) == (1, 1)


@pytest.mark.parametrize("size", [15, 16, 17])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 3, 7])
def test_conv_same_padding_matches_jax(size, stride, k):
    x, w = _np(7, 2, size, size, 5), _np(8, k, k, 5, 6)  # NHWC, HWIO
    want = jresnet._conv(jnp.asarray(x), jnp.asarray(w), stride, jnp.float32)
    got = tresnet._conv(_t(x).permute(0, 3, 1, 2), _t(w).permute(3, 2, 0, 1), stride,
                        torch.float32)
    assert _rel_err(got.permute(0, 2, 3, 1), want) <= 1e-5


@pytest.mark.parametrize("size", [15, 16, 17])
def test_max_pool_same_padding_matches_jax(size):
    x = _np(9, 2, size, size, 4)
    want = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max, (1, 3, 3, 1),
                                 (1, 2, 2, 1), "SAME")
    got = tresnet._max_pool(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape and torch.equal(got, _t(want))


# ------------------------------------------------------ forward and loss


def _carried(dt: str, stages=None, seed: int = 1):
    jcfg = dataclasses.replace(jresnet.tiny(), dtype=DTYPES[dt][0])
    if stages is not None:
        jcfg = dataclasses.replace(jcfg, num_classes=1000, stages=stages)
    tcfg = tresnet.ResNetConfig(num_classes=jcfg.num_classes, stages=jcfg.stages,
                                dtype=DTYPES[dt][1])
    params = jresnet.init_params(jcfg, jax.random.key(seed))
    return jcfg, tcfg, params, tresnet.params_from_jax(jax.tree.map(np.asarray, params),
                                                       tcfg, "cpu")


def _batch(cfg, batch, size, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, size, size, 3)).astype(np.float32),
            rng.integers(0, cfg.num_classes, batch))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("config,size", [("tiny", 16), ("full_width_one_block", 64)])
def test_forward_and_loss_match_jax(config, size, dt):
    jcfg, tcfg, params, tparams = _carried(dt, FULL_WIDTH_ONE_BLOCK if config != "tiny" else None)
    images, labels = _batch(jcfg, 2, size, 10)
    with torch.no_grad():
        logits = tresnet.forward(tcfg, tparams, torch.from_numpy(images))
        loss = tresnet.loss_fn(tcfg, tparams, torch.from_numpy(images),
                               torch.from_numpy(labels)).item()
    assert logits.dtype == torch.float32 and logits.shape == (2, jcfg.num_classes)

    @jax.jit
    def jfwd(p, x, y):
        return jresnet.forward(jcfg, p, x), jresnet.loss_fn(jcfg, p, x, y)

    want, jloss = jfwd(params, jnp.asarray(images), jnp.asarray(labels, jnp.int32))
    if dt == "f32":
        assert _rel_err(logits, want) <= 1e-4
        assert abs(loss - float(jloss)) <= 1e-4
    else:
        assert abs(loss - float(jloss)) <= 5e-2


def test_every_gradient_leaf_matches_jax_grad_f32():
    jcfg, tcfg, params, tparams = _carried("f32")
    images, labels = _batch(jcfg, 4, 16, 11)
    jgrads = jax.jit(jax.grad(lambda p, x, y: jresnet.loss_fn(jcfg, p, x, y)))(
        params, jnp.asarray(images), jnp.asarray(labels, jnp.int32))
    leaves = tresnet.param_leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    tresnet.loss_fn(tcfg, tparams, torch.from_numpy(images), torch.from_numpy(labels)).backward()
    want = tresnet.param_leaves(jax.tree.map(np.asarray, jgrads))
    assert len(want) == len(leaves) == 3 + 2 * 3 * 3 + 2 * 3 + 2
    for p, w in zip(leaves, want):
        w = w.transpose(3, 2, 0, 1) if w.ndim == 4 else w  # HWIO -> OIHW
        assert _rel_l2(p.grad, _t(w)) <= 1e-4


@pytest.mark.parametrize("dt,tol", [("f32", 1e-3), ("bf16", 5e-2)])
def test_three_step_sgd_trajectory_matches_jax_train_step(dt, tol):
    jcfg, tcfg, jparams, tparams = _carried(dt, seed=3)
    images, labels = _batch(jcfg, 8, 16, 12)
    tx = optax.sgd(0.1, momentum=0.9)
    opt_state = tx.init(jparams)
    jstep = jresnet.make_train_step(jcfg, tx)
    jlosses = []
    for _ in range(3):
        jparams, opt_state, loss = jstep(jparams, opt_state, jnp.asarray(images),
                                         jnp.asarray(labels, jnp.int32))
        jlosses.append(float(loss))
    _, opt = tresnet.make_train_state(tcfg, "cpu", params=tparams)
    step = tresnet.make_train_step(tcfg, tparams, opt)
    tlosses = [step(torch.from_numpy(images), torch.from_numpy(labels)).item()
               for _ in range(3)]
    assert max(abs(a - b) for a, b in zip(jlosses, tlosses)) <= tol
    assert tlosses[2] < tlosses[0]
    if dt == "f32":  # the weights after three updates, too
        for p, w in zip(tresnet.param_leaves(tparams),
                        tresnet.param_leaves(jax.tree.map(np.asarray, jparams))):
            w = w.transpose(3, 2, 0, 1) if w.ndim == 4 else w
            assert _rel_l2(p.detach(), _t(w)) <= 1e-3


def test_make_train_state_is_sgd_momentum_over_f32_leaves():
    cfg = tresnet.tiny()
    params, opt = tresnet.make_train_state(cfg, "cpu", seed=1)
    leaves = tresnet.param_leaves(params)
    assert all(p.dtype == torch.float32 and p.requires_grad for p in leaves)
    assert isinstance(opt, toptim.SGD)
    group = opt.param_groups[0]
    assert len(group["params"]) == len(leaves)
    assert (group["lr"], group["momentum"]) == (0.1, 0.9)
    assert params["stem"]["conv"].shape == (64, 3, 7, 7)  # OIHW
    again, _ = tresnet.make_train_state(cfg, "cpu", seed=1)
    assert torch.equal(again["stem"]["conv"], params["stem"]["conv"])


# ----------------------------------- the kernel path, kernels swapped for plain


def test_resnet50_train_step_launches_53_of_each_kernel(bn_kernels_as_plain, monkeypatch):
    """ResNet-50 (all 16 blocks, full width) at 64 x 64: one step on the
    kernels' autograd Functions (each kernel swapped for its plain twin)
    launches each K8 entry point once per batch-norm layer, 53 in all, and
    the cross-entropy over the f32 logits (K5) once forward and once
    backward, and gives the plain model's loss and gradients."""
    def xent(x, t):
        bn_kernels_as_plain["cross_entropy_f32"] += 1
        return txent.cross_entropy_plain(x, t), txent.cross_entropy_lse_plain(x)

    def xent_bwd(logits, targets, lse, grad, out=None):
        bn_kernels_as_plain["cross_entropy_f32_bwd"] += 1
        return out.copy_(txent.cross_entropy_bwd_plain(logits, targets, lse, grad))

    monkeypatch.setattr(txent, "cross_entropy_kernel", xent)
    monkeypatch.setattr(txent, "cross_entropy_bwd_kernel", xent_bwd)
    cfg = tresnet.ResNetConfig(dtype=torch.float32)
    assert tresnet.num_bn_layers(cfg) == 53 and tresnet.num_bn_layers(tresnet.tiny()) == 9
    params = tresnet.init_params(cfg, torch.Generator().manual_seed(0))
    leaves = tresnet.param_leaves(params)
    images, labels = (torch.from_numpy(a) for a in _batch(cfg, 2, 64, 13))
    results = []
    for ops in (tresnet.PLAIN, tresnet.Ops(tbn.batchnorm_on_kernels,
                                           txent.cross_entropy_on_kernels)):
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        bn_kernels_as_plain.clear()
        loss = tresnet.loss_fn(cfg, params, images, labels, ops)
        loss.backward()
        results.append((loss.item(), [p.grad.clone() for p in leaves]))
    assert dict(bn_kernels_as_plain) == {"bn_stats": 53, "bn_apply": 53, "bn_bwd": 53,
                                         "cross_entropy_f32": 1, "cross_entropy_f32_bwd": 1}
    (k_loss, k_grads), (p_loss, p_grads) = results[1], results[0]
    assert abs(k_loss - p_loss) <= 1e-5
    assert all(_rel_l2(g, w) <= 1e-4 for g, w in zip(k_grads, p_grads))


def test_train_demo_decreases_loss_on_cpu():
    """The analog of test_resnet_dp_step_decreases_loss: the fixed batch
    is memorized."""
    cfg = tresnet.tiny()
    l1 = tresnet.train_demo(cfg, steps=1, batch=8, size=16, device="cpu")
    l6 = tresnet.train_demo(cfg, steps=6, batch=8, size=16, device="cpu")
    assert np.isfinite(l1) and np.isfinite(l6)
    assert l6 < l1


# ------------------------------------------------------------ bench payload


def test_bench_run_on_cpu_keeps_every_result_key(tmp_path):
    out = tmp_path / "r.json"
    resnet_bench.main(["--device", "cpu", "--batch", "2", "--steps", "1", "--size", "32",
                       "--no-profile", "--out", str(out)])
    res = json.loads(out.read_text())
    assert JAX_RESULT_KEYS <= set(res)
    assert res["workload"] == "resnet50" and res["platform"] == "cpu"
    assert res["batch"] == 2 and res["image_size"] == 32 and res["steps"] == 1
    assert res["flops_per_step"] > 0 and res["peak_flops_per_device"] == 0.0
    assert res["mfu"] is None and res["profile"] is None and np.isfinite(res["first_loss"])


def test_entry_points_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tresnet.train_demo(),
                 lambda: tresnet.make_train_state(tresnet.tiny()),
                 lambda: tresnet.bench_imgs_per_sec(batch=2, size=32, steps=1),
                 lambda: resnet_bench.run(batch=2, steps=1, size=32)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("module", ["resnet", "resnet_bench"])
def test_module_main_refuses_without_a_card(module, tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = tmp_path / "r.json"
    res = subprocess.run([sys.executable, "-m", f"kubernetes1_tpu_torch.workloads.{module}",
                          *(["--out", str(out)] if module == "resnet_bench" else [])],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "final loss" not in res.stdout
    if module == "resnet_bench":
        assert "no CUDA device" in json.loads(out.read_text())["error"]
    else:
        assert "no CUDA device" in res.stderr


def test_gpu_peaks(monkeypatch):
    assert gpu_peaks.peak_flops_per_device("cpu") == (0.0, "device")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    names = iter(["NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe", "Some Other GPU"])
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: next(names))
    assert gpu_peaks.peak_flops_per_device("cuda") == (989e12, "gpu")
    assert gpu_peaks.peak_flops_per_device("cuda") == (756e12, "gpu")
    assert gpu_peaks.peak_flops_per_device("cuda") == (0.0, "device")


class _Event:
    def __init__(self, key, device_type, us, count=1):
        self.key, self.device_type, self.count = key, device_type, count
        self.self_device_time_total = us


def test_collect_profile_summarizes_device_ops_and_never_raises():
    events = [_Event("aten::conv2d", "DeviceType.CPU", 900.0),
              _Event("bn_partial_kernel", "DeviceType.CUDA", 30.0),
              _Event("cudnn_conv", "DeviceType.CUDA", 70.0),
              _Event("idle", "DeviceType.CUDA", 0.0)]
    res = benchguard.summarize_device_ops(events, top_n=1)
    assert res["top_ops"] == [{"op": "cudnn_conv", "category": "kernel",
                               "self_time_pct": 70.0, "bound_by": None}]
    assert res["bound"] == "unknown" and res["ops_counted"] == 2
    assert res["device_time_us"] == 100.0
    assert "error" in benchguard.summarize_device_ops(events[:1])
    err = benchguard.collect_profile(lambda: 1 / 0)
    assert err["error"].startswith("ZeroDivisionError")


def test_profile_summary_leaves_out_user_annotations():
    """A record_function range (the optimizer's step) also shows on the
    device with the self time of the kernels inside it; counting it would
    count those kernels twice."""
    ann = _Event("Optimizer.step#AdamW.step", "DeviceType.CUDA", 40.0)
    ann.is_user_annotation = True
    events = [_Event("multi_tensor_apply_kernel", "DeviceType.CUDA", 40.0),
              _Event("nvjet_gemm", "DeviceType.CUDA", 60.0), ann]
    res = benchguard.summarize_device_ops(events, top_n=5)
    assert res["device_time_us"] == 100.0 and res["ops_counted"] == 2
    assert [r["op"] for r in res["top_ops"]] == ["nvjet_gemm", "multi_tensor_apply_kernel"]


def test_acquisition_watchdog_stands_down_when_cancelled():
    timer = benchguard.device_acquisition_watchdog("", 60.0)
    assert timer.daemon
    timer.cancel()
    timer.join(timeout=5)
    assert not timer.is_alive()
