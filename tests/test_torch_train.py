"""Parity of the PyTorch port's Llama training half against the JAX package.

The same inputs, drawn with numpy from a seed, go through the JAX function
and its counterpart in ``kubernetes1_tpu_torch`` on the CPU; weights are
carried from the JAX pytree by ``params_from_jax`` (f32 master weights, as
the JAX train state keeps them).

- Each op's backward: ``*_bwd_plain`` (the formula the CUDA backward
  kernel computes) and autograd of the plain forward, against ``jax.vjp``
  of the JAX function, in f32: 1e-5 (attention 1e-4, the JAX suite's own
  bar, tests/test_workloads.py:93), relative to max(1, max |reference|),
  since a summed gradient (dscale) may be in the tens.
- The autograd Functions that carry the kernels on the card, run here with
  each kernel swapped for its plain twin: their wiring (argument order,
  saved tensors, the in-place cross-entropy backward, remat) and the
  launches per train step that ``chip_smoke.py`` asserts on the card.
- The loss (f32 1e-4, bf16 5e-2 as tests/test_workloads.py:81), every
  gradient leaf (f32, relative L2 1e-4) and a three-step AdamW trajectory
  against JAX's ``make_train_step`` on a 1-device mesh (f32 1e-3: Adam's
  first steps move a weight by about lr * sign(g), so a gradient near zero
  can flip its step; bf16 5e-2).  The embedding gradient differs in one
  way that the f32 tests cannot see: the port sums repeated rows in f32
  (index backward on the f32 table), JAX in bf16 before its cast; the port
  keeps the f32 sum.
"""

import dataclasses
import os
import subprocess
import sys
from collections import Counter
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes1_tpu.workloads import llama as jllama
from kubernetes1_tpu.workloads import sharding as jsh
from kubernetes1_tpu_torch import optim as toptim
from kubernetes1_tpu_torch.kernels import attention as tattention
from kubernetes1_tpu_torch.kernels import cross_entropy as txent
from kubernetes1_tpu_torch.kernels import rmsnorm as trmsnorm
from kubernetes1_tpu_torch.kernels import rope as trope
from kubernetes1_tpu_torch.kernels import swiglu as tswiglu
from kubernetes1_tpu_torch.workloads import llama as tllama

REPO = Path(__file__).resolve().parent.parent
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# (B, S, H, Hkv, hd): MHA, GQA 2 and 4, S not a power of two
SHAPES = [(2, 13, 4, 2, 16), (1, 37, 8, 2, 64), (2, 24, 4, 4, 32), (1, 20, 8, 2, 16)]


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


def _autograd(fn, inputs, cotangents):
    """Gradients of sum(out * cotangent) w.r.t. each input."""
    leaves = [x.clone().requires_grad_(True) for x in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, cotangents)
    return [x.grad for x in leaves]


# ------------------------------------------------- each op's VJP against JAX


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
class TestBackwardAgainstJaxVjp:
    def test_rmsnorm(self, shape):
        B, S, H, _Hkv, hd = shape
        x, dy = _np(0, B, S, H * hd), _np(1, B, S, H * hd)
        scale = np.random.default_rng(2).uniform(0.5, 1.5, H * hd).astype(np.float32)
        _, vjp = jax.vjp(jllama.rmsnorm, jnp.asarray(x), jnp.asarray(scale))
        jdx, jds = vjp(jnp.asarray(dy))
        dx, ds = trmsnorm.rmsnorm_bwd_plain(_t(x), _t(scale), _t(dy))
        assert _rel_err(dx, jdx) <= 1e-5 and _rel_err(ds, jds) <= 1e-5
        adx, ads = _autograd(trmsnorm.rmsnorm_plain, [_t(x), _t(scale)], [_t(dy)])
        assert _rel_err(adx, jdx) <= 1e-5 and _rel_err(ads, jds) <= 1e-5

    def test_rope(self, shape):
        B, S, H, Hkv, hd = shape
        q, k = _np(3, B, S, H, hd), _np(4, B, S, Hkv, hd)
        dq, dk = _np(5, B, S, H, hd), _np(6, B, S, Hkv, hd)
        theta = jllama.tiny().rope_theta
        pos = jnp.broadcast_to(jnp.arange(S), (B, S))
        rot = partial(jllama.rope, positions=pos, theta=theta)
        jdq = jax.vjp(rot, jnp.asarray(q))[1](jnp.asarray(dq))[0]
        jdk = jax.vjp(rot, jnp.asarray(k))[1](jnp.asarray(dk))[0]
        gq, gk = trope.rope_bwd_plain(_t(dq), _t(dk), theta)
        assert _rel_err(gq, jdq) <= 1e-5 and _rel_err(gk, jdk) <= 1e-5
        aq, ak = _autograd(lambda a, b: trope.rope_plain(a, b, theta), [_t(q), _t(k)],
                           [_t(dq), _t(dk)])
        assert _rel_err(aq, jdq) <= 1e-5 and _rel_err(ak, jdk) <= 1e-5

    def test_attention(self, shape):
        B, S, H, Hkv, hd = shape
        q, k, v = _np(7, B, S, H, hd), _np(8, B, S, Hkv, hd), _np(9, B, S, Hkv, hd)
        do = _np(10, B, S, H, hd)
        _, vjp = jax.vjp(jllama.attention, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp(jnp.asarray(do))
        tq, tk, tv = _t(q), _t(k), _t(v)
        o = tattention.attention_plain(tq, tk, tv)
        lse = tattention.attention_lse_plain(tq, tk)
        got = tattention.attention_bwd_plain(tq, tk, tv, o, lse, _t(do))
        assert all(_rel_err(g, w) <= 1e-4 for g, w in zip(got, want))
        auto = _autograd(tattention.attention_plain, [tq, tk, tv], [_t(do)])
        assert all(_rel_err(g, w) <= 1e-4 for g, w in zip(auto, want))

    def test_swiglu(self, shape):
        B, S, H, _Hkv, hd = shape
        g, u, dy = (_np(s, B * S, 2 * H * hd) for s in (11, 12, 13))
        _, vjp = jax.vjp(lambda a, b: jax.nn.silu(a) * b, jnp.asarray(g), jnp.asarray(u))
        jdg, jdu = vjp(jnp.asarray(dy))
        dg, du = tswiglu.swiglu_bwd_plain(_t(g), _t(u), _t(dy))
        assert _rel_err(dg, jdg) <= 1e-5 and _rel_err(du, jdu) <= 1e-5
        adg, adu = _autograd(tswiglu.swiglu_plain, [_t(g), _t(u)], [_t(dy)])
        assert _rel_err(adg, jdg) <= 1e-5 and _rel_err(adu, jdu) <= 1e-5

    def test_cross_entropy(self, shape):
        B, S, H, _Hkv, hd = shape
        rows, vocab = B * S, H * hd + 3  # a vocab that is no multiple of 8
        logits = _np(14, rows, vocab, scale=3.0)
        targets = np.random.default_rng(15).integers(0, vocab, rows)
        grad = _np(16, rows)

        def jnll(x):  # the per-row loss of jllama.loss_fn
            logp = jax.nn.log_softmax(x.astype(jnp.float32), axis=-1)
            return -jnp.take_along_axis(logp, jnp.asarray(targets)[:, None], axis=-1)[:, 0]

        jloss, vjp = jax.vjp(jnll, jnp.asarray(logits))
        (jd,) = vjp(jnp.asarray(grad))
        tl, tt = _t(logits), torch.from_numpy(targets)
        assert _rel_err(txent.cross_entropy_plain(tl, tt), jloss) <= 1e-5
        lse = txent.cross_entropy_lse_plain(tl)
        assert _rel_err(txent.cross_entropy_bwd_plain(tl, tt, lse, _t(grad)), jd) <= 1e-5
        (ad,) = _autograd(lambda x: txent.cross_entropy_plain(x, tt), [tl], [_t(grad)])
        assert _rel_err(ad, jd) <= 1e-5


def test_rope_bwd_plain_is_the_inverse_rotation():
    """Rotating by +angle, then by -angle, gives the input back (f32)."""
    q, k = _t(_np(17, 2, 9, 4, 16)), _t(_np(18, 2, 9, 2, 16))
    q2, k2 = trope.rope_bwd_plain(*trope.rope_plain(q, k, 1e4), 1e4)
    assert torch.allclose(q2, q, atol=1e-5) and torch.allclose(k2, k, atol=1e-5)


def test_cross_entropy_bf16_backward_rounds_once():
    """bf16 logits: the gradient is the f32 (softmax - onehot) * g rounded
    once to bf16, as the VJP of JAX's astype(float32) rounds it."""
    logits = _t(_np(19, 6, 50, scale=4.0)).bfloat16()
    t = torch.arange(6) * 7
    g = torch.full((6,), 1 / 6)
    lse = txent.cross_entropy_lse_plain(logits)
    got = txent.cross_entropy_bwd_plain(logits, t, lse, g)
    p = torch.exp(logits.float() - torch.logsumexp(logits.float(), -1, keepdim=True))
    want = (p - torch.nn.functional.one_hot(t, 50)) * g[:, None]
    assert got.dtype == torch.bfloat16 and torch.equal(got, want.bfloat16())
    # each element within half a bf16 step of the f32 value: one rounding
    assert bool(((got.float() - want).abs() <= want.abs() * 2.0 ** -8).all())


# ----------------------------------- the kernel path, kernels swapped for plain


def _xent_bwd_twin(logits, targets, lse, grad, out=None):
    out = torch.empty_like(logits) if out is None else out
    return out.copy_(txent.cross_entropy_bwd_plain(logits, targets, lse, grad))


# module, kernel function, its plain twin, the launch counter's name
TWINS = [
    (trmsnorm, "rmsnorm_kernel", trmsnorm.rmsnorm_plain, "rmsnorm"),
    (trmsnorm, "rmsnorm_bwd_kernel", trmsnorm.rmsnorm_bwd_plain, "rmsnorm_bwd"),
    (trope, "rope_kernel",
     lambda q, k, theta, inverse=False: (trope.rope_bwd_plain if inverse else trope.rope_plain)(
         q, k, theta), "rope"),
    (tattention, "attention_kernel",
     lambda q, k, v, with_lse=False, causal=True: (
         tattention.attention_plain(q, k, v, causal),
         tattention.attention_lse_plain(q, k, causal) if with_lse else None),
     "attention"),
    (tattention, "attention_bwd_kernel", tattention.attention_bwd_plain, "attention_bwd"),
    (tswiglu, "swiglu_kernel", tswiglu.swiglu_plain, "swiglu"),
    (tswiglu, "swiglu_bwd_kernel", tswiglu.swiglu_bwd_plain, "swiglu_bwd"),
    (txent, "cross_entropy_kernel",
     lambda x, t: (txent.cross_entropy_plain(x, t), txent.cross_entropy_lse_plain(x)),
     "cross_entropy"),
    (txent, "cross_entropy_bwd_kernel", _xent_bwd_twin, "cross_entropy_bwd"),
]
ON_KERNELS = tllama.Ops(trmsnorm.rmsnorm_on_kernels, trope.rope_on_kernels,
                        tattention.attention_on_kernels, tswiglu.swiglu_on_kernels,
                        txent.cross_entropy_on_kernels)


def launches_per_step(L: int) -> dict:
    """The kernel launches of one train step with L layers under remat
    "save_attn", as chip_smoke.py asserts them on the card.  Remat
    recomputes both checkpointed halves of each layer in backward, but
    stops (early, by torch.utils.checkpoint's default) once the tensors
    that backward needs exist again: in the first half that is the
    q/k/v products' input, so RoPE runs no second time."""
    return {"attention": L, "attention_bwd": L, "rmsnorm": 4 * L + 1, "rmsnorm_bwd": 2 * L + 1,
            "rope": L, "rope_bwd": L, "swiglu": 2 * L, "swiglu_bwd": L,
            "cross_entropy": 1, "cross_entropy_bwd": 1}


@pytest.fixture
def kernels_as_plain(monkeypatch):
    """Every kernel function replaced by its plain twin; yields the count
    of calls, as the kernels' launch counters would count them."""
    calls = Counter()
    for mod, name, twin, counter in TWINS:
        def counted(*a, _twin=twin, _counter=counter, **k):
            # RoPE's backward is its forward kernel called with inverse=True
            calls[_counter + ("_bwd" if k.get("inverse") else "")] += 1
            return _twin(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("op", ["rmsnorm", "rope", "attention", "swiglu", "cross_entropy"])
def test_autograd_function_gradients_equal_plain_autograd(kernels_as_plain, op):
    """f32: each Function (kernels swapped for their plain twins) gives the
    gradients that autograd of the plain forward gives, and launches its
    forward and its backward once."""
    B, S, H, Hkv, hd = 2, 13, 4, 2, 16
    if op == "rmsnorm":
        inputs = [_t(_np(20, B, S, H * hd)), _t(np.linspace(0.5, 1.5, H * hd))]
        fns = (trmsnorm.rmsnorm_on_kernels, trmsnorm.rmsnorm_plain)
    elif op == "rope":
        inputs = [_t(_np(21, B, S, H, hd)), _t(_np(22, B, S, Hkv, hd))]
        fns = (lambda q, k: trope.rope_on_kernels(q, k, 1e4),
               lambda q, k: trope.rope_plain(q, k, 1e4))
    elif op == "attention":
        inputs = [_t(_np(23, B, S, H, hd)), _t(_np(24, B, S, Hkv, hd)), _t(_np(25, B, S, Hkv, hd))]
        fns = (tattention.attention_on_kernels, tattention.attention_plain)
    elif op == "swiglu":
        inputs = [_t(_np(26, B * S, 32)), _t(_np(27, B * S, 32))]
        fns = (tswiglu.swiglu_on_kernels, tswiglu.swiglu_plain)
    else:
        targets = torch.from_numpy(np.random.default_rng(28).integers(0, 77, B * S))
        inputs = [_t(_np(29, B * S, 77, scale=3.0))]
        fns = (lambda x: txent.cross_entropy_on_kernels(x, targets),
               lambda x: txent.cross_entropy_plain(x, targets))
    outs = fns[1](*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    cot = [_t(_np(30 + i, *o.shape)) for i, o in enumerate(outs)]
    got = _autograd(fns[0], inputs, cot)
    want = _autograd(fns[1], inputs, cot)
    assert all(_rel_err(g, w) <= 1e-5 for g, w in zip(got, want))
    assert kernels_as_plain[op] == 1 and kernels_as_plain[op + "_bwd"] == 1


def test_cross_entropy_function_refuses_a_second_backward(kernels_as_plain):
    """Its backward writes over the saved logits, so a retained graph's
    second backward would read gradients as logits: it raises instead."""
    logits = _t(_np(40, 6, 50)).requires_grad_(True)
    loss = txent.cross_entropy_on_kernels(logits, torch.arange(6) * 7).mean()
    loss.backward(retain_graph=True)
    with pytest.raises(RuntimeError, match="second backward"):
        loss.backward()
    assert kernels_as_plain["cross_entropy_bwd"] == 1


def _carried(dt: str, seed: int = 3, **cfg_kw):
    jcfg = dataclasses.replace(jllama.tiny(), dtype=DTYPES[dt][0], **cfg_kw)
    tcfg = dataclasses.replace(tllama.tiny(), dtype=DTYPES[dt][1], **cfg_kw)
    params = jllama.init_params(jcfg, jax.random.key(seed))
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu",
                                     dtype=torch.float32)
    return jcfg, tcfg, params, tparams


def _grads(tcfg, tparams, tokens, ops):
    leaves = tllama.param_leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    loss = tllama.loss_fn(tcfg, tparams, tokens, ops)
    loss.backward()
    return loss.item(), [p.grad.clone() for p in leaves]


def _rel_l2(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.parametrize("policy", ["save_attn", "full", None])
def test_kernel_path_train_step_equals_plain(kernels_as_plain, policy):
    """The model on the kernels' autograd Functions (each kernel swapped
    for its plain twin), with remat "save_attn", "full" or off, gives the
    plain model's loss and gradients; under "save_attn" the launches per
    step are the ones chip_smoke.py asserts."""
    kw = {"remat": policy is not None, "remat_policy": policy or "save_attn"}
    _jcfg, tcfg, _params, tparams = _carried("f32", n_layers=3, **kw)
    toks = torch.from_numpy(np.random.default_rng(31).integers(0, tcfg.vocab, (2, 19)))
    want_loss, want = _grads(tcfg, tparams, toks, tllama.PLAIN)
    kernels_as_plain.clear()
    loss, got = _grads(tcfg, tparams, toks, ON_KERNELS)
    assert abs(loss - want_loss) <= 1e-5
    assert all(_rel_l2(g, w) <= 1e-5 for g, w in zip(got, want))
    if policy == "save_attn":
        assert dict(kernels_as_plain) == launches_per_step(tcfg.n_layers)
    elif policy == "full":
        assert kernels_as_plain["attention"] == 2 * tcfg.n_layers
    else:
        assert kernels_as_plain["attention"] == tcfg.n_layers


def test_remat_on_and_off_give_equal_loss_and_gradients():
    _jcfg, tcfg, _params, tparams = _carried("f32")
    toks = torch.from_numpy(np.random.default_rng(32).integers(0, tcfg.vocab, (3, 17)))
    base = _grads(tcfg, tparams, toks, tllama.KERNELS)
    for policy in ("save_attn", "full"):
        cfg = dataclasses.replace(tcfg, remat=True, remat_policy=policy)
        loss, grads = _grads(cfg, tparams, toks, tllama.KERNELS)
        assert loss == pytest.approx(base[0], abs=1e-6)
        assert all(_rel_l2(g, w) <= 1e-6 for g, w in zip(grads, base[1]))
    with pytest.raises(ValueError, match="remat_policy"):
        _grads(dataclasses.replace(tcfg, remat=True, remat_policy="none"), tparams, toks,
               tllama.KERNELS)


# ------------------------------------------------------ loss and gradients


@pytest.mark.parametrize("dt,tol", [("f32", 1e-4), ("bf16", 5e-2)])
def test_loss_matches_jax(dt, tol):
    jcfg, tcfg, params, tparams = _carried(dt)
    toks = np.random.default_rng(33).integers(0, jcfg.vocab, (4, 16))
    jloss = float(jax.jit(lambda p, t: jllama.loss_fn(jcfg, p, t))(params,
                                                                 jnp.asarray(toks, jnp.int32)))
    with torch.no_grad():
        tloss = tllama.loss_fn(tcfg, tparams, torch.from_numpy(toks)).item()
    assert abs(jloss - tloss) <= tol


def test_every_gradient_leaf_matches_jax_grad_f32():
    jcfg, tcfg, params, tparams = _carried("f32")
    toks = np.random.default_rng(34).integers(0, jcfg.vocab, (4, 16))
    jgrads = jax.jit(jax.grad(lambda p, t: jllama.loss_fn(jcfg, p, t)))(
        params, jnp.asarray(toks, jnp.int32))
    _loss, grads = _grads(tcfg, tparams, torch.from_numpy(toks), tllama.KERNELS)
    want = ([jgrads["embed"]]
            + [jgrads["layers"][key][i] for i in range(tcfg.n_layers) for key in tllama.LAYER_KEYS]
            + [jgrads["final_norm"], jgrads["unembed"]])
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert _rel_l2(g, _t(w)) <= 1e-4


@pytest.mark.parametrize("dt,tol", [("f32", 1e-3), ("bf16", 5e-2)])
def test_three_step_trajectory_matches_jax_train_step(dt, tol):
    jcfg, tcfg, _params, _ = _carried(dt)
    mesh = jsh.make_mesh(dp=1, fsdp=1, tp=1, devices=jax.devices()[:1])
    toks = np.random.default_rng(35).integers(0, jcfg.vocab, (4, 16))
    lr = 1e-3
    with jsh.use_mesh(mesh):
        jparams, opt_state, tx = jllama.make_train_state(jcfg, mesh, lr=lr)
        # the JAX step donates its params: copy them out before it runs
        tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu",
                                         dtype=torch.float32)
        jstep = jllama.make_train_step(jcfg, mesh, tx)
        jlosses = []
        for _ in range(3):
            jparams, opt_state, loss = jstep(jparams, opt_state, jnp.asarray(toks, jnp.int32))
            jlosses.append(float(loss))
    _, opt = tllama.make_train_state(tcfg, "cpu", lr=lr, params=tparams)
    step = tllama.make_train_step(tcfg, tparams, opt)
    tlosses = [step(torch.from_numpy(toks)).item() for _ in range(3)]
    assert max(abs(a - b) for a, b in zip(jlosses, tlosses)) <= tol
    assert tlosses[2] < tlosses[0]


def test_make_train_state_is_adamw_over_f32_leaves():
    cfg = tllama.tiny()
    params, opt = tllama.make_train_state(cfg, "cpu", lr=1e-3, seed=1)
    leaves = tllama.param_leaves(params)
    assert all(p.dtype == torch.float32 and p.requires_grad for p in leaves)
    assert isinstance(opt, toptim.AdamW)
    group = opt.param_groups[0]
    assert len(group["params"]) == len(leaves) == 3 + 9 * cfg.n_layers
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (
        1e-3, (0.9, 0.999), 1e-8, 0.1)
    again, _ = tllama.make_train_state(cfg, "cpu", seed=1)
    assert torch.equal(again["embed"], params["embed"])


def test_train_demo_memorizes_the_fixed_batch_on_cpu():
    cfg = tllama.tiny()
    l1 = tllama.train_demo(cfg, steps=1, batch=8, seq=32, device="cpu")
    l8 = tllama.train_demo(cfg, steps=8, batch=8, seq=32, device="cpu")
    assert np.isfinite(l1) and np.isfinite(l8)
    assert l8 < l1


def test_train_demo_without_a_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tllama.train_demo()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tllama.make_train_state(tllama.tiny())


def test_module_main_trains_and_refuses_without_a_card():
    """`python -m kubernetes1_tpu_torch.workloads.llama` runs train_demo
    (the JAX module's default), which needs the card."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run([sys.executable, "-m", "kubernetes1_tpu_torch.workloads.llama"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr and "final loss" not in res.stdout


def test_serving_forward_is_unchanged_by_the_training_half():
    """forward still returns f32 logits from bf16 weights, and casts each
    f32 master weight to the compute dtype the same way."""
    _jcfg, tcfg, _params, tparams = _carried("bf16")
    toks = torch.from_numpy(np.random.default_rng(36).integers(0, tcfg.vocab, (2, 9)))
    bf16 = {"embed": tparams["embed"].bfloat16(), "final_norm": tparams["final_norm"].bfloat16(),
            "unembed": tparams["unembed"].bfloat16(),
            "layers": [{k: v.bfloat16() for k, v in lp.items()} for lp in tparams["layers"]]}
    with torch.inference_mode():
        a = tllama.forward(tcfg, tparams, toks)
        b = tllama.forward(tcfg, bf16, toks)
    assert a.dtype == torch.float32 and torch.equal(a, b)
