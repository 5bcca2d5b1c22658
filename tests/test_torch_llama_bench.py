"""Parity of the PyTorch port's Llama bench payload (``workloads/
llama_bench.py``) against the JAX package's, on the CPU.

- ``PRESETS``, ``n_matmul_params`` and ``model_flops_per_token`` equal
  JAX's for every preset.
- A 3-step trajectory of the port's train step on each of the payload's
  optimizers (``make_optimizer``: AdamW, Adafactor, SGD with momentum)
  against JAX's llama_bench step (``jax.value_and_grad`` of ``loss_fn``,
  ``tx.update`` of JAX's ``make_optimizer``, ``optax.apply_updates``), from
  the same weights (``params_from_jax``) and tokens: f32 losses within
  1e-4 and every weight leaf within 1e-4 relative L2 after the 3 updates;
  the bf16 loss within 5e-2 (tests/test_workloads.py:81).  The model has
  d 128 and d_ff 256 so that Adafactor factors its matrices (the tiny
  preset's dims are below optax's 128 and never factor), and remat on, as
  the payload runs it.
- ``run`` on the CPU keeps every JAX result key; ``main`` without a card
  writes ``{"error": ...}`` and exits 1; ``run_sweep`` records an
  out-of-memory candidate and lets any other error through.
"""

import json
import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubernetes1_tpu.workloads import llama as jllama
from kubernetes1_tpu.workloads import llama_bench as jbench
from kubernetes1_tpu_torch import optim as toptim
from kubernetes1_tpu_torch.workloads import llama as tllama
from kubernetes1_tpu_torch.workloads import llama_bench as tbench

REPO = Path(__file__).resolve().parent.parent
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# the keys of the JAX payload's result (llama_bench.py:170-193)
JAX_RESULT_KEYS = {"workload", "device_kind", "platform", "n_devices", "device_granularity",
                   "params_matmul", "batch", "seq", "steps", "optimizer", "remat", "compile_s",
                   "step_time_ms", "tokens_per_sec", "tokens_per_sec_per_device",
                   "model_flops_per_step", "exec_flops_per_step", "peak_flops_per_device",
                   "mfu", "hfu", "final_loss", "profile"}
# a model whose matrices Adafactor factors (two dims >= 128)
FACTORING = dict(vocab=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=256)
SEQ = 16


def _rel_l2(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def test_presets_and_flop_counts_equal_jax():
    assert tbench.PRESETS == jbench.PRESETS
    for name, kw in jbench.PRESETS.items():
        jcfg = jllama.LlamaConfig(max_seq=2048, **kw)
        tcfg = tllama.LlamaConfig(max_seq=2048, **kw)
        assert tbench.n_matmul_params(tcfg) == jbench.n_matmul_params(jcfg), name
        for seq in (128, 2048):
            assert tbench.model_flops_per_token(tcfg, seq) == \
                jbench.model_flops_per_token(jcfg, seq), name


def test_the_1b_tpu_preset_has_1_123_b_parameters():
    cfg = tllama.LlamaConfig(**tbench.PRESETS["1b-tpu"])
    assert cfg.head_dim == 128
    n = (tbench.n_matmul_params(cfg) + (2 * cfg.n_layers + 1) * cfg.d_model)
    assert n == 1_123_117_056  # every f32 leaf the optimizers update


def _jax_step(cfg, tx):
    """The JAX payload's step body (llama_bench.py:105-111), no mesh."""

    @jax.jit
    def step(params, opt_state, tokens):
        loss, grads = jax.value_and_grad(partial(jllama.loss_fn, cfg))(params, tokens)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    return step


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("optimizer", ["adamw", "adafactor", "sgdm"])
def test_three_step_trajectory_matches_jax_llama_bench_step(optimizer, dt):
    lr = 3e-3
    jcfg = jllama.LlamaConfig(max_seq=SEQ, remat=True, dtype=DTYPES[dt][0], **FACTORING)
    tcfg = tllama.LlamaConfig(max_seq=SEQ, remat=True, dtype=DTYPES[dt][1], **FACTORING)
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu",
                                     dtype=torch.float32)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (2, SEQ + 1))
    tx = jbench.make_optimizer(optimizer, lr)
    opt_state = tx.init(jparams)
    jstep = _jax_step(jcfg, tx)
    jlosses = []
    for _ in range(3):
        jparams, opt_state, loss = jstep(jparams, opt_state, jnp.asarray(tokens, jnp.int32))
        jlosses.append(float(loss))
    for p in tllama.param_leaves(tparams):
        p.requires_grad_(True)
    opt = tbench.make_optimizer(optimizer, tparams, lr)
    step = tllama.make_train_step(tcfg, tparams, opt)
    tlosses = [step(torch.from_numpy(tokens)).item() for _ in range(3)]
    tol = 1e-4 if dt == "f32" else 5e-2
    assert max(abs(a - b) for a, b in zip(jlosses, tlosses)) <= tol, (jlosses, tlosses)
    assert tlosses[2] < tlosses[0]
    if dt == "f32":
        want = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu",
                                      dtype=torch.float32)
        for got, w in zip(tllama.param_leaves(tparams), tllama.param_leaves(want)):
            assert _rel_l2(got.detach(), w) <= 1e-4


def test_make_optimizer_builds_the_ports_optimizers():
    cfg = tllama.tiny(d_model=128, d_ff=256)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32)
    leaves = tllama.param_leaves(params)
    adamw = tbench.make_optimizer("adamw", params, 1e-3)
    assert isinstance(adamw, toptim.AdamW) and adamw.param_groups[0]["weight_decay"] == 0.1
    sgdm = tbench.make_optimizer("sgdm", params, 1e-3)
    assert isinstance(sgdm, toptim.SGD) and sgdm.param_groups[0]["momentum"] == 0.9
    ada = tbench.make_optimizer("adafactor", params, 1e-3)
    assert isinstance(ada, toptim.Adafactor)
    # one parameter group per JAX leaf: embed, the 9 stacked layer leaves,
    # final_norm, unembed; the same tensors as param_leaves
    names = [g["name"] for g in ada.param_groups]
    assert names == ["embed"] + [f"layers.{k}" for k in tllama.LAYER_KEYS] + [
        "final_norm", "unembed"]
    assert {id(p) for g in ada.param_groups for p in g["params"]} == {id(p) for p in leaves}
    # wq is (2, 128, 128) stacked: factored, v_row over its d_in rows
    assert ada.state[params["layers"][0]["wq"]]["v_row"].shape == (128,)
    assert "v" in ada.state[params["layers"][0]["wk"]]  # (2, 128, 64): not factored
    with pytest.raises(ValueError, match="unknown optimizer"):
        tbench.make_optimizer("lion", params, 1e-3)


def test_run_on_cpu_keeps_every_jax_result_key(tmp_path):
    out = tmp_path / "r.json"
    tbench.main(["--device", "cpu", "--preset", "tiny", "--batch", "2", "--seq", "16",
                 "--steps", "2", "--no-profile", "--out", str(out)])
    res = json.loads(out.read_text())
    assert set(res) == JAX_RESULT_KEYS
    assert res["workload"] == "llama-tiny" and res["platform"] == "cpu"
    assert res["n_devices"] == 1 and res["optimizer"] == "adafactor" and res["remat"] is True
    assert res["batch"] == 2 and res["seq"] == 16 and res["steps"] == 2
    assert res["params_matmul"] == jbench.n_matmul_params(
        jllama.LlamaConfig(max_seq=16, **jbench.PRESETS["tiny"]))
    assert res["peak_flops_per_device"] == 0.0 and res["mfu"] is None and res["hfu"] is None
    assert res["exec_flops_per_step"] >= res["model_flops_per_step"] > 0
    assert np.isfinite(res["final_loss"]) and res["profile"] is None


def test_main_without_a_card_writes_an_error_and_exits_1(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "r.json"
    with pytest.raises(SystemExit) as exit_info:
        tbench.main(["--preset", "tiny", "--out", str(out)])
    assert exit_info.value.code == 1
    res = json.loads(out.read_text())
    assert set(res) == {"error"} and "no CUDA device" in res["error"]


def test_module_main_refuses_without_a_card(tmp_path):
    out = tmp_path / "r.json"
    res = subprocess.run([sys.executable, "-m", "kubernetes1_tpu_torch.workloads.llama_bench",
                          "--preset", "tiny", "--out", str(out)], cwd=REPO,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 1 and "no CUDA device" in json.loads(out.read_text())["error"]


def _fake_run(raise_for):
    calls = []

    def run(preset, batch, seq, steps, optimizer, **kw):
        calls.append((batch, steps, kw.get("profile")))
        if batch in raise_for:
            raise raise_for[batch]
        return {"tokens_per_sec": 100.0 * batch if batch != 8 else 50.0, "mfu": 0.1,
                "batch": batch, "steps": steps}

    return run, calls


def test_sweep_records_an_out_of_memory_candidate_and_runs_the_best(monkeypatch):
    run, calls = _fake_run({6: torch.cuda.OutOfMemoryError("CUDA out of memory")})
    monkeypatch.setattr(tbench, "run", run)
    res = tbench.run_sweep([4, 6, 8], "tiny", 16, 5, "adafactor", device="cpu")
    assert res["sweep"][4] == {"tokens_per_sec": 400.0, "mfu": 0.1}
    assert res["sweep"][6]["error"].startswith("OutOfMemoryError")
    assert res["sweep_winner_batch"] == 4 and res["batch"] == 4 and res["steps"] == 5
    assert calls == [(4, 3, False), (6, 3, False), (8, 3, False), (4, 5, True)]


def test_sweep_lets_any_other_error_through(monkeypatch):
    from kubernetes1_tpu_torch.kernels.build import KernelLaunchError

    for err in (KernelLaunchError("ktpu_adamw_f32: CUDA error 700"), RuntimeError("boom")):
        run, calls = _fake_run({6: err})
        monkeypatch.setattr(tbench, "run", run)
        with pytest.raises(type(err)):
            tbench.run_sweep([4, 6, 8], "tiny", 16, 5, "adafactor", device="cpu")
        assert [c[0] for c in calls] == [4, 6]


def test_sweep_with_every_candidate_out_of_memory(monkeypatch):
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory")
    run, _calls = _fake_run({4: oom, 6: oom})
    monkeypatch.setattr(tbench, "run", run)
    res = tbench.run_sweep([4, 6], "tiny", 16, 5, "sgdm", device="cpu")
    assert res["error"] == "every sweep candidate failed" and set(res["sweep"]) == {4, 6}
