"""The attention backward's two passes in the PyTorch port against JAX.

On the card the attention backward is D = rowsum(dO * O), then a dK/dV
pass and a dQ pass (``csrc/attention.cu``), each written once with no
atomics.  Their plain versions (``kernels/attention.py``
``attention_bwd_dkdv_plain`` and ``attention_bwd_dq_plain``; the ring's
accumulating forms ``kernels/ringattention.py`` ``block_bwd_dkdv_op_plain``
and ``block_bwd_dq_op_plain``) are what ``chip_smoke.py`` holds each kernel
to.  Here, on the CPU in f32, with inputs drawn with numpy from a seed,
each pass and their composition are held to ``jax.grad`` of the JAX
package's ``llama.attention`` (causal) and of BERT's non-causal
``jax.nn.dot_product_attention`` (``workloads/bert.py:129``), at the JAX
suite's attention bar (1e-4, ``tests/test_workloads.py:93``) relative to
max(1, max |reference|): ragged lengths (37, 100, 130), GQA 1, 2 and 4,
head dims 16 to 128.  A two-block ring, each block pair's passes run with
the ring's final lse and D and summed, is held to the dense gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes1_tpu.workloads import llama as jllama
from kubernetes1_tpu_torch.kernels import attention as tattention
from kubernetes1_tpu_torch.kernels import build
from kubernetes1_tpu_torch.kernels import ringattention as tring

TOL = 1e-4  # tests/test_workloads.py:93, the JAX suite's attention bar
# (B, S, H, Hkv, hd): S not a multiple of the kernels' 64-row tiles, GQA
# 1, 2, 4 and 4, every head dim the kernels take
SHAPES = [(2, 37, 4, 4, 16), (1, 100, 8, 4, 64), (2, 130, 4, 1, 32), (1, 100, 8, 2, 128)]
# the two-block ring: blocks of 37, 50 and 65 rows (S = 74, 100, 130)
RING_SHAPES = [(2, 74, 4, 4, 16), (1, 100, 8, 4, 64), (1, 130, 8, 2, 128)]
CAUSAL = [pytest.param(True, id="causal"), pytest.param(False, id="noncausal")]


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel_err(got, want) -> float:
    """max |got - want| / max(1, max |want|)."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / max(1.0, float(np.max(np.abs(want)))))


def _jax_attention(causal):
    """Llama's causal attention, or BERT's call with no mask."""
    if causal:
        return jllama.attention
    return lambda q, k, v: jax.nn.dot_product_attention(q, k, v)


def _inputs(shape, seed):
    B, S, H, Hkv, hd = shape
    return (_np(seed, B, S, H, hd), _np(seed + 1, B, S, Hkv, hd), _np(seed + 2, B, S, Hkv, hd),
            _np(seed + 3, B, S, H, hd))


def _jax_grads(q, k, v, do, causal):
    """jax.grad of <attention(q, k, v), dO>: the VJP with cotangent dO."""
    attn = _jax_attention(causal)

    def f(q, k, v):
        return jnp.sum(attn(q, k, v) * jnp.asarray(do))

    return jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


def _port_stats(q, k, v, do, causal):
    """The forward's output and lse, and D = rowsum(dO * O), as the
    backward kernels get them."""
    o = tattention.attention_plain(q, k, v, causal)
    lse = tattention.attention_lse_plain(q, k, causal)
    return o, lse, tattention.delta_plain(o, do)


@pytest.mark.parametrize("causal", CAUSAL)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_dkdv_pass_matches_jax_grad(shape, causal):
    q, k, v, do = _inputs(shape, 11)
    want = _jax_grads(q, k, v, do, causal)
    tq, tk, tv, tdo = map(_t, (q, k, v, do))
    _o, lse, delta = _port_stats(tq, tk, tv, tdo, causal)
    dk, dv = tattention.attention_bwd_dkdv_plain(tq, tk, tv, tdo, lse, delta, causal)
    assert dk.dtype == dv.dtype == torch.float32 and dk.shape == tk.shape
    assert _rel_err(dk, want[1]) <= TOL and _rel_err(dv, want[2]) <= TOL


@pytest.mark.parametrize("causal", CAUSAL)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_dq_pass_matches_jax_grad(shape, causal):
    q, k, v, do = _inputs(shape, 21)
    want = _jax_grads(q, k, v, do, causal)
    tq, tk, tv, tdo = map(_t, (q, k, v, do))
    _o, lse, delta = _port_stats(tq, tk, tv, tdo, causal)
    dq = tattention.attention_bwd_dq_plain(tq, tk, tv, tdo, lse, delta, causal)
    assert dq.dtype == torch.float32 and dq.shape == tq.shape
    assert _rel_err(dq, want[0]) <= TOL


@pytest.mark.parametrize("causal", CAUSAL)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_composition_matches_jax_grad(shape, causal):
    """attention_bwd_plain (D, then both passes) is the whole gradient,
    and its dq, dk, dv are exactly the passes' outputs."""
    q, k, v, do = _inputs(shape, 31)
    want = _jax_grads(q, k, v, do, causal)
    tq, tk, tv, tdo = map(_t, (q, k, v, do))
    o, lse, delta = _port_stats(tq, tk, tv, tdo, causal)
    got = tattention.attention_bwd_plain(tq, tk, tv, o, lse, tdo, causal)
    assert all(_rel_err(g, w) <= TOL for g, w in zip(got, want))
    passes = (tattention.attention_bwd_dq_plain(tq, tk, tv, tdo, lse, delta, causal),
              *tattention.attention_bwd_dkdv_plain(tq, tk, tv, tdo, lse, delta, causal))
    assert all(torch.equal(g, p) for g, p in zip(got, passes))


@pytest.mark.parametrize("causal", CAUSAL)
@pytest.mark.parametrize("shape", RING_SHAPES, ids=str)
def test_two_block_ring_accumulation_matches_dense_grad(shape, causal):
    """Ring attention's backward over two blocks: each (q block, kv block)
    pair the ring folds (the diagonals, the block behind, and, non-causal,
    the block ahead) runs the two passes in their accumulating forms with
    the ring's final lse and D; the sums are the dense gradient."""
    q, k, v, do = _inputs(shape, 41)
    want = _jax_grads(q, k, v, do, causal)
    tq, tk, tv, tdo = map(_t, (q, k, v, do))
    Sb = tq.shape[1] // 2
    blk = [slice(0, Sb), slice(Sb, 2 * Sb)]
    qs, ks, vs, dos = ([t[:, s].contiguous() for s in blk] for t in (tq, tk, tv, tdo))
    # the ring's forward: each rank folds its blocks into (o, lse)
    final = []
    for r in range(2):
        acc = None
        for src in range(2):
            if causal and src > r:
                continue
            part = tring.block_attn_plain(qs[r], ks[src], vs[src], r * Sb, src * Sb, causal)
            acc = part if acc is None else tring.merge_plain(acc[0].float(), acc[1], *part)
        final.append(acc)
    dq = [torch.zeros(t.shape) for t in qs]
    dk, dv = ([torch.zeros(t.shape) for t in ks] for _ in range(2))
    delta = [tring.delta_plain(final[r][0], dos[r]) for r in range(2)]
    for r in range(2):
        for src in range(2):
            if causal and src > r:
                continue
            pair_causal = causal and src == r
            args = (qs[r], ks[src], vs[src], dos[r], final[r][1], delta[r], pair_causal)
            tring.block_bwd_dkdv_op_plain(*args, dk[src], dv[src])
            tring.block_bwd_dq_op_plain(*args, dq[r])
    for got, w in zip((torch.cat(dq, 1), torch.cat(dk, 1), torch.cat(dv, 1)), want):
        assert _rel_err(got, w) <= TOL


@pytest.mark.parametrize("causal", CAUSAL)
def test_ring_block_bwd_op_plain_adds_both_passes(causal):
    """``block_bwd_op_plain`` (the ring's plain block backward) fills D
    from o and adds block_bwd_plain's partials, the passes' outputs."""
    q, k, v, do = map(_t, _inputs((1, 37, 4, 2, 16), 51))
    o, lse, delta = _port_stats(q, k, v, do, causal)
    bufs = [torch.ones(t.shape) for t in (q, k, v)]
    d = torch.empty_like(lse)
    tring.block_bwd_op_plain(q, k, v, do, lse, d, causal, *bufs, o=o)
    assert torch.equal(d, delta)
    want = tring.block_bwd_plain(q, k, v, do, lse, delta, causal)
    for b, w in zip(bufs, want):
        assert torch.equal(b, 1.0 + w)


def test_attention_compile_log_empty_without_a_build(tmp_path, monkeypatch):
    """ptxas's report for the attention kernels is kept beside the library
    (built with -Xptxas -v); with no library built there is none."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    assert "-Xptxas" in build._flags("attention") and "-Xptxas" not in build._flags("rope")
    assert build._lib_path("attention").parent == tmp_path
    assert build.compile_log("attention") == ""
