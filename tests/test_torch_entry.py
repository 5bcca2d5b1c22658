"""The PyTorch port's entry points against the JAX package's
``__graft_entry__.py``.

``kubernetes1_tpu_torch/entry.py``: ``entry`` is Llama's forward at the JAX
entry's config, held to JAX's on JAX's weights (the loss of its logits
at 5e-2, each logit at 1e-1: the bf16 rule of ``ROADMAP.md``);
``_factor3`` is JAX's mesh factoring; ``dryrun_multichip`` runs JAX's
three checks (a sharded Llama step, a sharded BERT step, ring attention)
on n gloo ranks on the CPU, each rank asserting that it holds its specs'
share of the parameters and of AdamW's state.
"""

import re

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from kubernetes1_tpu_torch import entry as tentry
from kubernetes1_tpu_torch.workloads import bert as tbert
from kubernetes1_tpu_torch.workloads import llama as tllama
from kubernetes1_tpu_torch.workloads import sharding

LOSS_TOL = 5e-2   # tests/test_workloads.py:81
LOGIT_TOL = 1e-1  # ROADMAP.md: bf16 logits against XLA:CPU's fused bf16
RING_TOL = 1e-4   # __graft_entry__.py's bar


@pytest.mark.parametrize("n", range(1, 17))
def test_factor3_is_jax_s(n):
    assert tentry._factor3(n) == jentry._factor3(n)


def _nll(logits: np.ndarray, tokens: np.ndarray) -> float:
    """Next-token cross entropy of the logits, in f64."""
    x = logits[:, :-1].astype(np.float64)
    x = x - x.max(-1, keepdims=True)
    logp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    return float(-np.take_along_axis(logp, tokens[:, 1:, None], -1).mean())


def test_entry_forward_matches_jax_entry_on_its_weights():
    jfn, (jparams, jtokens) = jentry.entry()
    want = np.asarray(jax.jit(jfn)(jparams, jtokens))
    fn, (params, tokens) = tentry.entry(device="cpu")
    assert tokens.dtype == torch.int64 and tokens.shape == jtokens.shape
    assert np.array_equal(tokens.numpy(), np.asarray(jtokens))
    carried = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), _cfg(), "cpu",
                                     dtype=torch.float32)
    assert [(p.shape, p.dtype) for p in tllama.param_leaves(params)] == [
        (p.shape, p.dtype) for p in tllama.param_leaves(carried)]
    with torch.no_grad():
        got = fn(carried, tokens).numpy()
    assert got.shape == want.shape == (4, 128, 4096) and got.dtype == np.float32
    assert np.abs(got - want).max() <= LOGIT_TOL
    toks = np.asarray(jtokens)
    assert abs(_nll(got, toks) - _nll(want, toks)) <= LOSS_TOL


def _cfg():
    return tllama.LlamaConfig(vocab=4096, d_model=512, n_layers=4, n_heads=8, n_kv_heads=4,
                              d_ff=1024, max_seq=512, remat=False)


class _Coord:
    """Enough of a DeviceMesh for the placement arithmetic."""

    def __init__(self, shape):
        self.mesh_dim_names, self.shape = sharding.DIMS, shape

    def get_coordinate(self):
        return (0, 0, 0)


def _share_bytes(mod, cfg, mesh_shape) -> int:
    whole = [tuple(t.shape) for t in
             mod.param_leaves(mod.init_params(cfg, torch.Generator().manual_seed(0)))]
    specs = sharding.spec_leaves(mod.param_specs(cfg), cfg.n_layers, mod.param_leaves)
    return 4 * sharding.spec_numel(whole, specs, _Coord(mesh_shape))


@pytest.mark.parametrize("n,mesh", [(8, (2, 2, 2)), (4, (1, 2, 2))])
def test_dryrun_multichip_on_gloo_ranks(capsys, n, mesh):
    line = tentry.dryrun_multichip(n, device="cpu")
    assert capsys.readouterr().out.strip().splitlines()[-1] == line
    dp, fsdp, tp = mesh
    assert line.startswith(f"dryrun ok: mesh dp={dp} fsdp={fsdp} tp={tp}, ")
    m = re.search(r"llama loss=([\d.]+), bert loss=([\d.]+), ring err=([\d.e+-]+), "
                  r"param bytes/rank=llama (\d+) bert (\d+)$", line)
    assert m, line
    llama_loss, bert_loss, ring_err = (float(m.group(i)) for i in (1, 2, 3))
    assert np.isfinite(llama_loss) and np.isfinite(bert_loss)
    assert ring_err < RING_TOL
    lcfg = tllama.tiny(vocab=128, d_model=32, n_layers=2, n_heads=2 * tp, n_kv_heads=tp,
                       d_ff=64, max_seq=32)
    bcfg = tbert.tiny(vocab=128, d_model=32, n_layers=2, n_heads=2 * tp, d_ff=64, max_seq=32)
    assert int(m.group(4)) == _share_bytes(tllama, lcfg, mesh)
    assert int(m.group(5)) == _share_bytes(tbert, bcfg, mesh)
    assert int(m.group(4)) < _share_bytes(tllama, lcfg, (1, 1, 1))


def test_dryrun_multichip_refuses_what_the_card_cannot_run(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 NCCL ranks need 2 cards"):
        tentry.dryrun_multichip(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.dryrun_multichip(1)
