"""Parity of the PyTorch port's Llama model against the JAX package.

The same inputs, drawn with numpy from a seed, go through the JAX
function and its counterpart in ``kubernetes1_tpu_torch`` on the CPU;
weights are carried from the JAX pytree by ``params_from_jax``.  On the
CPU each kernel wrapper runs its plain PyTorch version, so these tests
hold the plain versions (the references the CUDA kernels are compared
with on the card) to JAX.

Tolerances: f32 at 1e-5 (RMSNorm, RoPE) and 1e-4 (attention, the JAX
suite's own bar, tests/test_workloads.py:93); bf16 at 2e-2 on outputs
below 4 in magnitude, where one bf16 rounding step is at most 2^-6:
the two frameworks sum in different orders, so an f32 intermediate may
round to the neighbouring bf16 value.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes1_tpu.workloads import llama as jllama
from kubernetes1_tpu_torch.kernels import attention as tattention
from kubernetes1_tpu_torch.kernels import rmsnorm as trmsnorm
from kubernetes1_tpu_torch.kernels import rope as trope
from kubernetes1_tpu_torch.kernels import swiglu as tswiglu
from kubernetes1_tpu_torch.workloads import llama as tllama

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"rmsnorm": {"f32": 1e-5, "bf16": 2e-2},
       "rope": {"f32": 1e-5, "bf16": 2e-2},
       "attention": {"f32": 1e-4, "bf16": 2e-2},
       "swiglu": {"f32": 1e-5, "bf16": 2e-2}}
# (B, S, H, Hkv, hd): MHA, GQA H/Hkv = 2 and 4, S not a power of two
SHAPES = [(2, 13, 4, 2, 16), (1, 37, 8, 2, 64), (2, 100, 4, 4, 32), (1, 24, 8, 2, 16)]


def _pair(a: np.ndarray, dt: str):
    """The same values as a JAX array and a torch tensor of dtype `dt`
    (rounded to bf16 once, by JAX, for both)."""
    j = jnp.asarray(a, DTYPES[dt][0])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(DTYPES[dt][1])
    return j, t


def _inputs(rng, shape, dt):
    # bf16 cases draw from [-1, 1] so outputs stay below 4 (see TOL)
    a = rng.standard_normal(shape) if dt == "f32" else rng.uniform(-1, 1, shape)
    return _pair(a.astype(np.float32), dt)


def _err(j, t) -> float:
    return float(np.max(np.abs(np.asarray(j.astype(jnp.float32)) - t.float().numpy())))


def _configs(dt: str):
    jcfg = dataclasses.replace(jllama.tiny(), dtype=DTYPES[dt][0])
    tcfg = dataclasses.replace(tllama.tiny(), dtype=DTYPES[dt][1])
    return jcfg, tcfg


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
class TestOpsAgainstJax:
    def test_rmsnorm(self, shape, dt):
        B, S, H, _Hkv, hd = shape
        rng = np.random.default_rng(0)
        jx, tx = _inputs(rng, (B, S, H * hd), dt)
        scale = rng.uniform(0.5, 1.5, H * hd).astype(np.float32)
        j = jllama.rmsnorm(jx, jnp.asarray(scale))
        t = trmsnorm.rmsnorm(tx, torch.from_numpy(scale))
        assert t.dtype == tx.dtype and t.shape == tx.shape
        assert _err(j, t) <= TOL["rmsnorm"][dt]

    def test_rope(self, shape, dt):
        B, S, H, Hkv, hd = shape
        rng = np.random.default_rng(1)
        jq, tq = _inputs(rng, (B, S, H, hd), dt)
        jk, tk = _inputs(rng, (B, S, Hkv, hd), dt)
        pos = jnp.broadcast_to(jnp.arange(S), (B, S))
        theta = jllama.tiny().rope_theta
        tq2, tk2 = trope.rope(tq, tk, theta)
        assert _err(jllama.rope(jq, pos, theta), tq2) <= TOL["rope"][dt]
        assert _err(jllama.rope(jk, pos, theta), tk2) <= TOL["rope"][dt]

    def test_attention(self, shape, dt):
        B, S, H, Hkv, hd = shape
        rng = np.random.default_rng(2)
        jq, tq = _inputs(rng, (B, S, H, hd), dt)
        jk, tk = _inputs(rng, (B, S, Hkv, hd), dt)
        jv, tv = _inputs(rng, (B, S, Hkv, hd), dt)
        t = tattention.attention(tq, tk, tv)
        assert t.shape == tq.shape and t.dtype == tq.dtype
        assert _err(jllama.attention(jq, jk, jv), t) <= TOL["attention"][dt]

    def test_swiglu(self, shape, dt):
        """K4: silu(g) * u on the two GEMM outputs (rows, d_ff), against
        the JAX layer's jax.nn.silu(g) * u."""
        B, S, H, _Hkv, hd = shape
        rng = np.random.default_rng(3)
        jg, tg = _inputs(rng, (B * S, 2 * H * hd), dt)
        ju, tu = _inputs(rng, (B * S, 2 * H * hd), dt)
        t = tswiglu.swiglu(tg, tu)
        assert t.shape == tg.shape and t.dtype == tg.dtype
        assert _err(jax.nn.silu(jg) * ju, t) <= TOL["swiglu"][dt]


def test_rope_is_half_split_not_interleaved():
    """Position 1 rotates lane i with lane i + hd/2 (jnp.split), never with
    its odd neighbour, whatever the JAX docstring says."""
    hd = 8
    q = torch.zeros(1, 2, 1, hd)
    q[0, 1, 0, 0] = 1.0  # lane 0 at position 1
    out, _ = trope.rope_plain(q, q.clone(), theta=10000.0)
    nz = torch.nonzero(out[0, 1, 0]).flatten().tolist()
    assert nz == [0, hd // 2]
    assert out[0, 1, 0, hd // 2].item() == pytest.approx(np.sin(1.0), abs=1e-6)


def test_rmsnorm_casts_before_scale():
    """(x * rsqrt(var + eps)) rounds to bf16 BEFORE the product with the
    bf16 scale, as in the JAX function: the result equals two roundings."""
    x = torch.tensor([[1.0, 3.0, 5.0, 7.0]], dtype=torch.bfloat16)
    scale = torch.tensor([1.1, 0.9, 1.3, 0.7])
    r = torch.rsqrt(x.float().square().mean(-1, keepdim=True) + 1e-5)
    want = (x.float() * r).bfloat16() * scale.bfloat16()
    assert torch.equal(trmsnorm.rmsnorm(x, scale), want)


# ------------------------------------------------------------------ model


def _carried(dt: str, seed: int = 3):
    jcfg, tcfg = _configs(dt)
    params = jllama.init_params(jcfg, jax.random.key(seed))
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return jcfg, tcfg, params, tparams


def test_params_from_jax_splits_layers_and_keeps_layout():
    jcfg, tcfg, params, tparams = _carried("f32")
    assert len(tparams["layers"]) == tcfg.n_layers
    for i, lp in enumerate(tparams["layers"]):
        for key in tllama.LAYER_KEYS:
            want = np.asarray(params["layers"][key][i])
            assert tuple(lp[key].shape) == want.shape  # (d_in, d_out), no transpose
            assert np.array_equal(lp[key].numpy(), want)
    for key in ("embed", "final_norm", "unembed"):
        assert np.array_equal(tparams[key].numpy(), np.asarray(params[key]))


def test_params_from_jax_rejects_mismatched_tree():
    _jcfg, tcfg, params, _ = _carried("f32")
    tree = jax.tree.map(np.asarray, params)
    with pytest.raises(ValueError):
        tllama.params_from_jax(tree, dataclasses.replace(tcfg, n_layers=3), "cpu")
    del tree["layers"]["wq"]
    with pytest.raises(ValueError):
        tllama.params_from_jax(tree, tcfg, "cpu")


def test_init_params_shapes_and_distributions():
    cfg = tllama.tiny(d_model=128, d_ff=256)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0))
    jshapes = jax.eval_shape(lambda k: jllama.init_params(jllama.tiny(d_model=128, d_ff=256), k),
                             jax.random.key(0))
    assert tuple(params["embed"].shape) == jshapes["embed"].shape
    assert tuple(params["unembed"].shape) == jshapes["unembed"].shape
    for key in tllama.LAYER_KEYS:
        assert tuple(params["layers"][0][key].shape) == jshapes["layers"][key].shape[1:]
    assert all(t.dtype == cfg.dtype for t in params["layers"][1].values())
    assert torch.equal(params["final_norm"], torch.ones(128, dtype=cfg.dtype))
    # normal / sqrt(fan_in): w_down's fan-in is d_ff
    std = params["layers"][0]["w_down"].float().std().item()
    assert abs(std * np.sqrt(cfg.d_ff) - 1.0) < 0.05
    again = tllama.init_params(cfg, torch.Generator().manual_seed(0))
    assert torch.equal(again["embed"], params["embed"])


def test_forward_f32_matches_jax():
    jcfg, tcfg, params, tparams = _carried("f32")
    toks = np.random.default_rng(4).integers(0, jcfg.vocab, (2, 21))
    j = jax.jit(lambda p, t: jllama.forward(jcfg, p, t))(params, jnp.asarray(toks, jnp.int32))
    t = tllama.forward(tcfg, tparams, torch.from_numpy(toks))
    assert t.dtype == torch.float32 and tuple(t.shape) == (2, 21, jcfg.vocab)
    assert float(np.max(np.abs(np.asarray(j) - t.numpy()))) <= 1e-4


def test_forward_bf16_matches_jax():
    """bf16: the next-token loss within the JAX suite's bf16 bar (5e-2,
    tests/test_workloads.py:81, set there on this loss), and every logit
    within 1e-1.  The logits cannot meet 5e-2 each: XLA fuses the bf16
    elementwise chains and keeps f32 inside a fusion, the port rounds
    after every op, so a logit of magnitude 2-4 (bf16 step 1.6e-2) ends
    up a few steps away."""
    jcfg, tcfg, params, tparams = _carried("bf16")
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 21))
    jtoks = jnp.asarray(toks, jnp.int32)
    j = np.asarray(jax.jit(lambda p, t: jllama.forward(jcfg, p, t))(params, jtoks))
    t = tllama.forward(tcfg, tparams, torch.from_numpy(toks))
    assert float(np.max(np.abs(j - t.numpy()))) <= 1e-1
    jloss = float(jax.jit(lambda p, t: jllama.loss_fn(jcfg, p, t))(params, jtoks))
    logp = torch.log_softmax(tllama.forward(tcfg, tparams, torch.from_numpy(toks[:, :-1])), -1)
    tloss = -logp.gather(-1, torch.from_numpy(toks[:, 1:])[..., None]).mean().item()
    assert abs(jloss - tloss) <= 5e-2


def test_forward_kernel_ops_equal_plain_ops_on_cpu():
    """On CPU tensors the kernel wrappers ARE the plain versions."""
    _jcfg, tcfg, _params, tparams = _carried("bf16")
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, tcfg.vocab, (3, 9)))
    assert torch.equal(tllama.forward(tcfg, tparams, toks, tllama.KERNELS),
                       tllama.forward(tcfg, tparams, toks, tllama.PLAIN))


@pytest.mark.parametrize("max_seq", [128, 8192])
def test_seq_bucket_matches_jax(max_seq):
    for n in list(range(0, 70)) + [127, 128, 129, 1000, 1024, 1025, 8192, 9000]:
        assert tllama._seq_bucket(n, max_seq) == jllama._seq_bucket(n, max_seq)


def test_llama_3_8b_config_matches_jax():
    j, t = jllama.llama_3_8b(), tllama.llama_3_8b()
    for f in dataclasses.fields(tllama.LlamaConfig):
        if f.name != "dtype":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.dtype == torch.bfloat16 and t.head_dim == j.head_dim == 128
