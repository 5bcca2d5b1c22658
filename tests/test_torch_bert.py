"""Parity of the PyTorch port's BERT masked-LM model and train step against
the JAX package.

The same inputs, drawn with numpy from a seed, go through the JAX function
and its counterpart in ``kubernetes1_tpu_torch`` on the CPU; weights are
carried from the JAX pytree by ``params_from_jax`` (f32 master weights, as
the JAX train state keeps them).  JAX runs on one device.

Tolerances, each stated where it is used:
- non-causal attention (K7a), f32: 1e-4 relative to max(1, max |ref|),
  the JAX suite's own bar (tests/test_workloads.py:93), forward and VJP;
- LayerNorm (K7b): f32 1e-5 forward and VJP; bf16 forward within one bf16
  step of the output (both round the same f32 value once, which may sit
  on either side of a rounding boundary after sums in another order);
- tanh-GELU (K9): f32 1e-5 forward and VJP; bf16 forward within
  2^-7 * |x| of JAX, which rounds after each op on XLA:CPU and casts
  sqrt(2/pi) to bf16, where the port rounds once;
- the cross-entropy over f32 logits (K5-f32): 1e-5;
- the model: logits f32 1e-4 and bf16 1e-1, the loss f32 1e-4 and bf16
  5e-2 (tests/test_workloads.py:81), every gradient leaf f32 relative L2
  1e-4, a three-step AdamW trajectory f32 1e-3 and bf16 5e-2 (Adam's first
  steps move a weight by about lr * sign(g), so a gradient near zero can
  flip its step).  The embedding gradient differs in one way that the f32
  tests cannot see: the port sums the gather's repeated rows in f32 (index
  backward on the f32 table), JAX in bf16 before its cast; the port keeps
  the f32 sum.
"""

import dataclasses
from collections import Counter
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes1_tpu.workloads import bert as jbert
from kubernetes1_tpu.workloads import sharding as jsh
from kubernetes1_tpu_torch import optim as toptim
from kubernetes1_tpu_torch.kernels import attention as tattention
from kubernetes1_tpu_torch.kernels import cross_entropy as txent
from kubernetes1_tpu_torch.kernels import gelu as tgelu
from kubernetes1_tpu_torch.kernels import layernorm as tln
from kubernetes1_tpu_torch.workloads import bert as tbert

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
BF16_STEP = 2.0 ** -8  # one bf16 rounding step, relative to the value


def _np(seed, *shape, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale + shift).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _f32(a) -> np.ndarray:
    return np.array(a.detach().float() if isinstance(a, torch.Tensor) else a, dtype=np.float32)


def _rel_err(got, want) -> float:
    """max |got - want| / max(1, max |want|)."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / max(1.0, float(np.max(np.abs(want)))))


def _rel_l2(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _autograd(fn, inputs, cotangents):
    """Gradients of sum(out * cotangent) w.r.t. each input."""
    leaves = [x.clone().requires_grad_(True) for x in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, cotangents)
    return [x.grad for x in leaves]


# ------------------------------------------------- each op against JAX


@pytest.mark.parametrize("S", [32, 40, 70])
def test_noncausal_attention_and_its_vjp_match_jax(S):
    """K7a's plain version, forward and backward (the kernel's formula and
    autograd of the forward), against jax.nn.dot_product_attention with no
    mask, f32 at 1e-4; S = 40 and 70 are no multiple of the kernel's
    64-row tiles."""
    B, H, hd = 2, 4, 16
    q, k, v, do = (_np(s, B, S, H, hd) for s in (1, 2, 3, 4))
    jout, vjp = jax.vjp(jax.nn.dot_product_attention, jnp.asarray(q), jnp.asarray(k),
                        jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = _t(q), _t(k), _t(v)
    o = tattention.attention_plain(tq, tk, tv, causal=False)
    assert _rel_err(o, jout) <= 1e-4
    assert _rel_err(tattention.attention(tq, tk, tv, causal=False), jout) <= 1e-4
    lse = tattention.attention_lse_plain(tq, tk, causal=False)
    got = tattention.attention_bwd_plain(tq, tk, tv, o, lse, _t(do), causal=False)
    assert all(_rel_err(g, w) <= 1e-4 for g, w in zip(got, want))
    auto = _autograd(partial(tattention.attention_plain, causal=False), [tq, tk, tv], [_t(do)])
    assert all(_rel_err(g, w) <= 1e-4 for g, w in zip(auto, want))


def _old_causal_attention(q, k, v):
    """The causal plain version as it stood before the ``causal`` flag,
    kept verbatim as the reference for the flag's default."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, H // Hkv, hd)
    logits = torch.einsum("btkgh,bskh->bkgts", qg.float(), k.float())
    logits = logits * (1.0 / np.sqrt(hd))
    causal = torch.ones(S, S, dtype=torch.bool).tril()
    logits = logits.masked_fill(~causal, tattention.MASK_VALUE)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskh->btkgh", probs.float(), v.float())
    return out.to(q.dtype).reshape(B, S, H, hd), torch.logsumexp(logits, -1).reshape(B, H, S)


@pytest.mark.parametrize("shape", [(2, 13, 4, 2, 16), (1, 37, 8, 2, 64), (2, 24, 4, 4, 32)])
def test_causal_attention_is_unchanged_by_the_flag(shape):
    """attention(q, k, v) and attention(..., causal=True) give, bit for
    bit, what the causal-only version gave, on the Llama parity inputs."""
    B, S, H, Hkv, hd = shape
    q, k, v = _t(_np(7, B, S, H, hd)), _t(_np(8, B, S, Hkv, hd)), _t(_np(9, B, S, Hkv, hd))
    want, want_lse = _old_causal_attention(q, k, v)
    for out in (tattention.attention(q, k, v), tattention.attention(q, k, v, causal=True),
                tattention.attention_plain(q, k, v, True)):
        assert torch.equal(out, want)
    assert torch.equal(tattention.attention_lse_plain(q, k), want_lse)
    nc = tattention.attention_plain(q, k, v, causal=False)
    assert not torch.equal(nc, want)  # the flag does reach the mask


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_layernorm_and_its_vjp_match_jax(dt):
    """K7b's plain version against jax.vjp of bert.layernorm (two-pass
    variance, f32 scale and bias): f32 at 1e-5, forward and backward; bf16
    forward within one bf16 step, and its backward (dx rounded once to
    bf16, dscale and dbias f32) within a step of dx and 1e-4 of the sums."""
    jdt, tdt = DTYPES[dt]
    rows, d = 24, 96
    x = _np(10, rows, d, scale=2.0, shift=0.7)
    dy = _np(11, rows, d)
    scale = np.random.default_rng(12).uniform(0.5, 1.5, d).astype(np.float32)
    bias = _np(13, d, scale=0.3)
    jx = jnp.asarray(x).astype(jdt)
    jy, vjp = jax.vjp(jbert.layernorm, jx, jnp.asarray(scale), jnp.asarray(bias))
    jdx, jds, jdb = vjp(jnp.asarray(dy).astype(jdt))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
    tdy = torch.from_numpy(np.array(jnp.asarray(dy).astype(jdt).astype(jnp.float32))).to(tdt)
    y = tln.layernorm_plain(tx, _t(scale), _t(bias))
    dx, ds, db = tln.layernorm_bwd_plain(tx, _t(scale), tdy)
    adx, ads, adb = _autograd(tln.layernorm_plain, [tx, _t(scale), _t(bias)], [tdy])
    assert y.dtype == tdt and dx.dtype == tdt and ds.dtype == db.dtype == torch.float32
    if dt == "f32":
        assert _rel_err(y, jy) <= 1e-5
        for got in ((dx, ds, db), (adx, ads, adb)):
            assert all(_rel_err(g, w) <= 1e-5 for g, w in zip(got, (jdx, jds, jdb)))
    else:
        jy32 = _f32(jy.astype(jnp.float32))
        assert np.all(np.abs(_f32(y) - jy32) <= BF16_STEP * np.abs(jy32) + 1e-6)
        jdx32 = _f32(jdx.astype(jnp.float32))
        assert np.all(np.abs(_f32(dx) - jdx32) <= 2 * BF16_STEP * np.abs(jdx32) + 1e-3)
        assert _rel_err(ds, jds) <= 1e-4 and _rel_err(db, jdb) <= 1e-4


def test_gelu_matches_jax():
    """K9's plain version against jax.nn.gelu (tanh approximation): f32 at
    1e-5 forward and VJP; on bf16 inputs within 2^-7 * |x| of JAX's."""
    x = _np(14, 64, 48, scale=3.0)
    dy = _np(15, 64, 48)
    jy, vjp = jax.vjp(jax.nn.gelu, jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(dy))
    assert _rel_err(tgelu.gelu_plain(_t(x)), jy) <= 1e-5
    assert _rel_err(tgelu.gelu_bwd_plain(_t(x), _t(dy)), jdx) <= 1e-5
    (adx,) = _autograd(tgelu.gelu_plain, [_t(x)], [_t(dy)])
    assert _rel_err(adx, jdx) <= 1e-5
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jyb = _f32(jax.jit(jax.nn.gelu)(xb).astype(jnp.float32))
    txb = torch.from_numpy(_f32(xb.astype(jnp.float32))).bfloat16()
    yb = tgelu.gelu_plain(txb)
    assert yb.dtype == torch.bfloat16
    assert np.all(np.abs(_f32(yb) - jyb) <= 2.0 ** -7 * np.abs(_f32(txb)))


def test_gelu_rounds_once():
    """bf16: the output is the exact value rounded once, within half a
    bf16 step (2^-8 relative), plus 1e-6 absolute for f32's own error in
    1 + tanh near -1, where x is far below 0 and the output is tiny."""
    x = _t(_np(16, 200, scale=4.0)).bfloat16()
    xf = x.float().double()
    want = xf * 0.5 * (1 + torch.tanh(np.sqrt(2 / np.pi) * (xf + 0.044715 * xf ** 3)))
    got = tgelu.gelu_plain(x).double()
    assert bool(((got - want).abs() <= want.abs() * BF16_STEP + 1e-6).all())


def test_cross_entropy_over_f32_logits_matches_jax():
    """K5's f32 instantiation, plain: the per-row NLL of mlm_loss_fn
    (log_softmax, take_along_axis) and its VJP, at 1e-5; f32 gradients are
    not rounded."""
    rows, vocab = 20, 301
    logits = _np(17, rows, vocab, scale=3.0)
    targets = np.random.default_rng(18).integers(0, vocab, rows)
    grad = _np(19, rows)

    def jnll(x):
        logp = jax.nn.log_softmax(x, axis=-1)
        return -jnp.take_along_axis(logp, jnp.asarray(targets)[:, None], axis=-1)[:, 0]

    jloss, vjp = jax.vjp(jnll, jnp.asarray(logits))
    (jd,) = vjp(jnp.asarray(grad))
    tl, tt = _t(logits), torch.from_numpy(targets)
    assert _rel_err(txent.cross_entropy(tl, tt), jloss) <= 1e-5
    lse = txent.cross_entropy_lse_plain(tl)
    got = txent.cross_entropy_bwd_plain(tl, tt, lse, _t(grad))
    assert got.dtype == torch.float32 and _rel_err(got, jd) <= 1e-5
    (ad,) = _autograd(lambda x: txent.cross_entropy_plain(x, tt), [tl], [_t(grad)])
    assert _rel_err(ad, jd) <= 1e-5


# ------------------------------------------------------------------ model


def test_synthetic_batch_equals_jax():
    for cfg, shape, seed in ((jbert.tiny(), (4, 16), 0), (jbert.bert_large(), (2, 512), 3)):
        jt, jm = jbert.synthetic_batch(cfg, *shape, seed=seed)
        tcfg = tbert.tiny() if cfg.vocab == 256 else tbert.bert_large()
        tt, tm = tbert.synthetic_batch(tcfg, *shape, seed=seed)
        assert tt.dtype == torch.int64 and tm.dtype == torch.int32
        assert np.array_equal(np.asarray(jt), tt.numpy())
        assert np.array_equal(np.asarray(jm), tm.numpy())


def test_configs_match_jax():
    for jcfg, tcfg in ((jbert.bert_large(), tbert.bert_large()), (jbert.tiny(), tbert.tiny())):
        for f in ("vocab", "d_model", "n_layers", "n_heads", "d_ff", "max_seq", "remat"):
            assert getattr(jcfg, f) == getattr(tcfg, f), f
        assert jcfg.head_dim == tcfg.head_dim
    assert tbert.bert_large().dtype == torch.bfloat16


def _carried(dt: str, seed: int = 3, **cfg_kw):
    jcfg = dataclasses.replace(jbert.tiny(), dtype=DTYPES[dt][0], **cfg_kw)
    tcfg = dataclasses.replace(tbert.tiny(), dtype=DTYPES[dt][1], **cfg_kw)
    params = jbert.init_params(jcfg, jax.random.key(seed))
    tparams = tbert.params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return jcfg, tcfg, params, tparams


def test_params_from_jax_splits_the_layer_axis():
    _jcfg, tcfg, params, tparams = _carried("f32")
    assert len(tparams["layers"]) == tcfg.n_layers
    assert torch.equal(tparams["layers"][1]["w_in"], _t(params["layers"]["w_in"][1]))
    assert tparams["layers"][0]["w_out"].shape == (tcfg.d_ff, tcfg.d_model)
    leaves = tbert.param_leaves(tparams)
    assert len(leaves) == 6 + 10 * tcfg.n_layers
    assert len(jax.tree.leaves(params)) == 6 + len(tbert.LAYER_KEYS)  # JAX stacks layers
    assert all(p.dtype == torch.float32 for p in leaves)
    bad = jax.tree.map(np.asarray, params)
    bad["layers"].pop("wq")
    with pytest.raises(ValueError, match="layer keys"):
        tbert.params_from_jax(bad, tcfg, "cpu")


@pytest.mark.parametrize("dt,tol_logits,tol_loss", [("f32", 1e-4, 1e-4), ("bf16", 1e-1, 5e-2)])
def test_forward_and_loss_match_jax(dt, tol_logits, tol_loss):
    jcfg, tcfg, params, tparams = _carried(dt)
    toks, mask = jbert.synthetic_batch(jcfg, 4, 16, seed=1)
    jlogits = jax.jit(lambda p, t: jbert.forward(jcfg, p, t))(params, toks)
    jloss = float(jax.jit(lambda p, t, m: jbert.mlm_loss_fn(jcfg, p, t, m))(params, toks, mask))
    tt, tm = tbert.synthetic_batch(tcfg, 4, 16, seed=1)
    with torch.no_grad():
        logits = tbert.forward(tcfg, tparams, tt)
        loss = tbert.mlm_loss_fn(tcfg, tparams, tt, tm).item()
    assert logits.dtype == torch.float32 and logits.shape == (4, 16, tcfg.vocab)
    assert np.max(np.abs(_f32(logits) - _f32(jlogits))) <= tol_logits
    assert abs(loss - jloss) <= tol_loss


def _grads(tcfg, tparams, tokens, mask, ops=tbert.KERNELS):
    leaves = tbert.param_leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    loss = tbert.mlm_loss_fn(tcfg, tparams, tokens, mask, ops)
    loss.backward()
    return loss.item(), [p.grad.clone() for p in leaves]


def test_every_gradient_leaf_matches_jax_grad_f32():
    jcfg, tcfg, params, tparams = _carried("f32")
    toks, mask = jbert.synthetic_batch(jcfg, 4, 16, seed=2)
    jgrads = jax.jit(jax.grad(lambda p, t, m: jbert.mlm_loss_fn(jcfg, p, t, m)))(
        params, toks, mask)
    tt, tm = tbert.synthetic_batch(tcfg, 4, 16, seed=2)
    _loss, grads = _grads(tcfg, tparams, tt, tm)
    want = ([jgrads["embed"], jgrads["pos_embed"]]
            + [jgrads["layers"][key][i] for i in range(tcfg.n_layers)
               for key in tbert.LAYER_KEYS]
            + [jgrads[key] for key in tbert.TOP_KEYS[2:]])
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert _rel_l2(g, _t(w)) <= 1e-4


@pytest.mark.parametrize("dt,tol", [("f32", 1e-3), ("bf16", 5e-2)])
def test_three_step_trajectory_matches_jax_train_step(dt, tol):
    jcfg, tcfg, _params, _ = _carried(dt)
    mesh = jsh.make_mesh(dp=1, fsdp=1, tp=1, devices=jax.devices()[:1])
    toks, mask = jbert.synthetic_batch(jcfg, 4, 16, seed=4)
    lr = 1e-3
    with jsh.use_mesh(mesh):
        jparams, opt_state, tx = jbert.make_train_state(jcfg, mesh, lr=lr)
        # the JAX step donates its params: copy them out before it runs
        tparams = tbert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
        jstep = jbert.make_train_step(jcfg, mesh, tx)
        jlosses = []
        for _ in range(3):
            jparams, opt_state, loss = jstep(jparams, opt_state, toks, mask)
            jlosses.append(float(loss))
    _, opt = tbert.make_train_state(tcfg, "cpu", lr=lr, params=tparams)
    step = tbert.make_train_step(tcfg, tparams, opt)
    tt, tm = tbert.synthetic_batch(tcfg, 4, 16, seed=4)
    tlosses = [step(tt, tm).item() for _ in range(3)]
    assert max(abs(a - b) for a, b in zip(jlosses, tlosses)) <= tol
    assert tlosses[2] < tlosses[0]


def test_remat_on_and_off_give_equal_loss_and_gradients():
    _jcfg, tcfg, _params, tparams = _carried("f32")
    tt, tm = tbert.synthetic_batch(tcfg, 3, 17, seed=5)
    base = _grads(tcfg, tparams, tt, tm)
    loss, grads = _grads(dataclasses.replace(tcfg, remat=True), tparams, tt, tm)
    assert loss == pytest.approx(base[0], abs=1e-6)
    assert all(_rel_l2(g, w) <= 1e-6 for g, w in zip(grads, base[1]))


def test_make_train_state_is_adamw_wd_001_over_f32_leaves():
    cfg = tbert.tiny()
    params, opt = tbert.make_train_state(cfg, "cpu", lr=1e-3, seed=1)
    leaves = tbert.param_leaves(params)
    assert all(p.dtype == torch.float32 and p.requires_grad for p in leaves)
    assert isinstance(opt, toptim.AdamW)
    group = opt.param_groups[0]
    assert len(group["params"]) == len(leaves) == 6 + 10 * cfg.n_layers
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (
        1e-3, (0.9, 0.999), 1e-8, 0.01)
    again, _ = tbert.make_train_state(cfg, "cpu", seed=1)
    assert torch.equal(again["embed"], params["embed"])
    assert torch.equal(params["layers"][0]["ln1_scale"], torch.ones(cfg.d_model))


# ------------------------------ the analogs of tests/test_workloads.py:113-158


def test_train_demo_memorizes_the_fixed_masked_batch_on_cpu():
    cfg = tbert.tiny()
    l1 = tbert.train_demo(cfg, steps=1, batch=8, seq=32, device="cpu")
    l12 = tbert.train_demo(cfg, steps=12, batch=8, seq=32, device="cpu")
    assert np.isfinite(l1) and np.isfinite(l12)
    assert l12 < l1


def test_masked_positions_drive_the_loss():
    """Loss ignores unmasked positions: a mask of ones everywhere and a
    mask with one position give different losses, and a mask with none
    gives 0 (0 / max(0, 1))."""
    cfg = tbert.tiny()
    params, _opt = tbert.make_train_state(cfg, "cpu", seed=0)
    tokens, _ = tbert.synthetic_batch(cfg, 2, 8)
    one = torch.zeros_like(tokens)
    one[0, 0] = 1
    with torch.no_grad():
        l_full = tbert.mlm_loss_fn(cfg, params, tokens, torch.ones_like(tokens)).item()
        l_one = tbert.mlm_loss_fn(cfg, params, tokens, one).item()
        l_none = tbert.mlm_loss_fn(cfg, params, tokens, torch.zeros_like(tokens)).item()
    assert np.isfinite(l_full) and np.isfinite(l_one)
    assert l_full != l_one
    assert l_none == 0.0


def test_train_demo_without_a_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbert.train_demo()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbert.make_train_state(tbert.tiny())


# ----------------------------------- the kernel path, kernels swapped for plain


def _xent_kernel_twin(x, t):
    return txent.cross_entropy_plain(x, t), txent.cross_entropy_lse_plain(x)


def _xent_bwd_twin(logits, targets, lse, grad, out=None):
    out = torch.empty_like(logits) if out is None else out
    return out.copy_(txent.cross_entropy_bwd_plain(logits, targets, lse, grad))


# module, kernel function, its plain twin
TWINS = [
    (tln, "layernorm_kernel", tln.layernorm_plain),
    (tln, "layernorm_bwd_kernel", tln.layernorm_bwd_plain),
    (tgelu, "gelu_kernel", tgelu.gelu_plain),
    (tgelu, "gelu_bwd_kernel", tgelu.gelu_bwd_plain),
    (tattention, "attention_kernel",
     lambda q, k, v, with_lse=False, causal=True: (
         tattention.attention_plain(q, k, v, causal),
         tattention.attention_lse_plain(q, k, causal) if with_lse else None)),
    (tattention, "attention_bwd_kernel", tattention.attention_bwd_plain),
    (txent, "cross_entropy_kernel", _xent_kernel_twin),
    (txent, "cross_entropy_bwd_kernel", _xent_bwd_twin),
]
ON_KERNELS = tbert.Ops(tln.layernorm_on_kernels,
                       partial(tattention.attention_on_kernels, causal=False),
                       tgelu.gelu_on_kernels, txent.cross_entropy_on_kernels)


def _counter_name(name: str, args, kwargs) -> str:
    """The launch counter a kernel call bumps, named as chip_smoke.py's
    KERNELS: non-causal attention and the cross-entropy over f32 logits
    count apart from causal attention and bf16 logits."""
    base = name.replace("_kernel", "").replace("_bwd", "")
    bwd = "_bwd" in name
    if base == "cross_entropy" and args[0].dtype == torch.float32:
        base = "cross_entropy_f32"
    if base == "attention" and not kwargs.get("causal", args[6] if bwd and len(args) > 6
                                              else True):
        base = "attention_noncausal"
    return base + ("_bwd" if bwd else "")


def launches_per_step(L: int, remat: bool = True) -> dict:
    """The kernel launches of one BERT train step with L layers, as
    chip_smoke.py asserts them on the card.  Full remat (JAX's
    jax.checkpoint on the whole layer) runs each layer's forward twice,
    the second time in backward (torch.utils.checkpoint stops early only
    once every saved tensor exists again, and the layer's last op, the
    second LayerNorm, saves its input): attention and GELU twice, both
    LayerNorms twice; the final LayerNorm and the head's GELU once."""
    f = 2 if remat else 1
    return {"attention_noncausal": f * L, "attention_noncausal_bwd": L,
            "layernorm": 2 * f * L + 1,
            "layernorm_bwd": 2 * L + 1, "gelu": f * L + 1, "gelu_bwd": L + 1,
            "cross_entropy_f32": 1, "cross_entropy_f32_bwd": 1}


@pytest.fixture
def kernels_as_plain(monkeypatch):
    """Every kernel function replaced by its plain twin; yields the count
    of calls, as the kernels' launch counters would count them."""
    calls = Counter()
    for mod, name, twin in TWINS:
        def counted(*a, _twin=twin, _name=name, **k):
            calls[_counter_name(_name, a, k)] += 1
            return _twin(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("op", ["attention_noncausal", "layernorm", "gelu", "cross_entropy_f32"])
def test_autograd_function_gradients_equal_plain_autograd(kernels_as_plain, op):
    """f32: each Function (kernels swapped for their plain twins) gives the
    gradients that autograd of the plain forward gives, and launches its
    forward and its backward once."""
    B, S, H, hd = 2, 13, 4, 16
    if op == "attention_noncausal":
        inputs = [_t(_np(20 + i, B, S, H, hd)) for i in range(3)]
        fns = (partial(tattention.attention_on_kernels, causal=False),
               partial(tattention.attention_plain, causal=False))
    elif op == "layernorm":
        inputs = [_t(_np(23, B, S, 32, shift=0.5)), _t(np.linspace(0.5, 1.5, 32)),
                  _t(_np(24, 32))]
        fns = (tln.layernorm_on_kernels, tln.layernorm_plain)
    elif op == "gelu":
        inputs = [_t(_np(25, B * S, 40, scale=2.0))]
        fns = (tgelu.gelu_on_kernels, tgelu.gelu_plain)
    else:
        targets = torch.from_numpy(np.random.default_rng(26).integers(0, 77, B * S))
        inputs = [_t(_np(27, B * S, 77, scale=3.0))]
        fns = (lambda x: txent.cross_entropy_on_kernels(x, targets),
               lambda x: txent.cross_entropy_plain(x, targets))
    outs = fns[1](*inputs)
    cot = [_t(_np(30, *outs.shape))]
    got = _autograd(fns[0], inputs, cot)
    want = _autograd(fns[1], inputs, cot)
    assert all(_rel_err(g, w) <= 1e-5 for g, w in zip(got, want))
    assert kernels_as_plain[op] == 1 and kernels_as_plain[op + "_bwd"] == 1


@pytest.mark.parametrize("remat", [True, False])
def test_kernel_path_train_step_equals_plain(kernels_as_plain, remat):
    """The model on the kernels' autograd Functions (each kernel swapped
    for its plain twin), with remat on or off, gives the plain model's
    loss and gradients, with the launches per step that chip_smoke.py
    asserts on the card."""
    _jcfg, tcfg, _params, tparams = _carried("f32", n_layers=3, remat=remat)
    tt, tm = tbert.synthetic_batch(tcfg, 2, 19, seed=6)
    want_loss, want = _grads(tcfg, tparams, tt, tm, tbert.PLAIN)
    kernels_as_plain.clear()
    loss, got = _grads(tcfg, tparams, tt, tm, ON_KERNELS)
    assert abs(loss - want_loss) <= 1e-5
    assert all(_rel_l2(g, w) <= 1e-5 for g, w in zip(got, want))
    assert dict(kernels_as_plain) == launches_per_step(tcfg.n_layers, remat)
