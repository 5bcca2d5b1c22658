"""Llama training benchmark payload, the counterpart of the JAX package's
``workloads/llama_bench.py``:

    python -m kubernetes1_tpu_torch.workloads.llama_bench --out <file>

Trains a preset of the Llama architecture (default ``1b-tpu``: 22 layers,
d 2048, 16 heads of 128, 4 KV heads, vocab 32000) on one fixed batch of
synthetic tokens and reports tokens/sec and two utilizations on one card:
- mfu: model FLOPs (``model_flops_per_token``: 6 per matrix parameter and
  12·L·S·d of attention per token, no remat credit) per second over the
  card's peak (``gpu_peaks``);
- hfu: executed FLOPs per step over the peak, where the executed FLOPs
  are ``torch.utils.flop_counter.FlopCounterMode``'s count of the first
  warm-up step (the matrix products, the remat's recompute included) plus
  the attention kernel's work by its launches (FlopCounterMode cannot see
  the hand-written kernels: 4·hd per (query, key) pair forward, 10·hd
  backward, which recomputes Q·K^T).
The optimizer is the port's ``optim.Adafactor`` (optax's adafactor, the
default), ``AdamW`` or ``SGD`` with momentum: each one kernel launch a step.

Same flags, defaults and result keys as the JAX payload, with
``--device`` (default ``cuda``) in place of ``--platform``.  Without a
card it writes ``{"error": ...}`` and exits 1.

Data parallel under a launcher, one process per card (``torchrun
--nproc-per-node=N -m kubernetes1_tpu_torch.workloads.llama_bench``):
``--batch`` is the global batch, split over the N data ranks;
``n_devices`` is N, tokens/sec counts the global batch, the executed
FLOPs are one rank's count times N and MFU and HFU divide by N cards'
peak, as the JAX payload does.  Only rank 0 prints and writes the result.
A ``--sweep`` runs on one rank only.
"""

from __future__ import annotations

import argparse
import gc
import time

from .gpu_peaks import peak_flops_per_device

# The JAX payload's presets (its llama_bench.py:35-48), architectures of the
# Llama-3 family: "1b" TinyLlama-1.1B's geometry, "1b-tpu" the same with
# 16 heads of 128 (4 KV heads), "8b" Llama-3-8B.
PRESETS = {
    "tiny": dict(vocab=256, d_model=64, n_layers=2, n_heads=4,
                 n_kv_heads=2, d_ff=128),
    "1b": dict(vocab=32000, d_model=2048, n_layers=22, n_heads=32,
               n_kv_heads=4, d_ff=5632),
    "1b-tpu": dict(vocab=32000, d_model=2048, n_layers=22, n_heads=16,
                   n_kv_heads=4, d_ff=5632),
    "8b": dict(vocab=128256, d_model=4096, n_layers=32, n_heads=32,
               n_kv_heads=8, d_ff=14336),
}


def n_matmul_params(cfg) -> int:
    """Parameter count in the matmuls (excl. norms; incl. embed+unembed,
    which are real matmuls in this implementation)."""
    d, hd = cfg.d_model, cfg.head_dim
    per_layer = (d * cfg.n_heads * hd            # wq
                 + 2 * d * cfg.n_kv_heads * hd   # wk, wv
                 + cfg.n_heads * hd * d          # wo
                 + 3 * d * cfg.d_ff)             # gate, up, down
    return cfg.n_layers * per_layer + 2 * cfg.vocab * d


def model_flops_per_token(cfg, seq: int) -> float:
    """Analytic fwd+bwd FLOPs per trained token (no remat credit):
    6 * matmul params + attention 12 * L * S * d."""
    return 6.0 * n_matmul_params(cfg) + 12.0 * cfg.n_layers * seq * cfg.d_model


def make_optimizer(name: str, params, lr: float):
    """The JAX payload's optimizers over the Llama parameter dict: optax's
    adamw (weight decay 0.1), adafactor (its defaults) and sgd (momentum
    0.9), as the port's kernel-backed optimizers."""
    from .. import optim
    from .llama import leaf_groups, param_leaves

    if name == "adamw":
        return optim.AdamW(param_leaves(params), lr=lr, weight_decay=0.1)
    if name == "adafactor":
        return optim.Adafactor(leaf_groups(params), lr=lr)
    if name == "sgdm":
        return optim.SGD(param_leaves(params), lr=lr, momentum=0.9)
    raise ValueError(f"unknown optimizer {name!r}")


def run(preset: str, batch: int, seq: int, steps: int, optimizer: str,
        warmup: int = 2, lr: float = 3e-4, remat: bool = True,
        watchdog=None, profile: bool = True, device: str = "cuda", mesh=None) -> dict:
    """The payload's result on this rank.  ``batch`` is the global batch;
    without ``mesh``, ``sharding.launched_mesh`` decides (one device
    unless a launcher set the environment)."""
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..kernels import attention as _attention
    from .llama import LlamaConfig, init_params, make_train_step, param_leaves
    from .sharding import (broadcast_params, data_mesh, data_ranks, launched_mesh,
                           resolve_device)

    dev = resolve_device(device)
    if watchdog is not None:
        watchdog.cancel()  # device claim succeeded: stand down
    mesh = mesh if mesh is not None else launched_mesh(dev)
    n_dev = data_ranks(mesh)
    cfg = LlamaConfig(max_seq=seq, remat=remat, **PRESETS[preset])
    # f32 master weights from seed 0, as the JAX payload's init_params(key(0))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dtype=torch.float32)
    if mesh is not None:  # rank 0's weights everywhere, before the optimizer's table
        broadcast_params(param_leaves(params), mesh)
    for p in param_leaves(params):
        p.requires_grad_(True)
    opt = make_optimizer(optimizer, params, lr)
    # whole weights on every data rank: JAX's payload has no param specs
    step = make_train_step(cfg, params, opt, mesh=None if mesh is None else data_mesh(mesh))
    rng = np.random.default_rng(0)
    # +1: loss_fn trains next-token over tokens[:, :-1] -> [:, 1:]
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, seq + 1))).to(dev)

    # barrier = float(loss): a device-to-host copy of the step's result
    # waits for every kernel of the step
    t_c0 = time.perf_counter()
    exec_flops = None
    loss = None
    for i in range(max(warmup, 1)):
        if i == 0:
            fwd0, bwd0 = _attention.KERNEL.launches, _attention.KERNEL_BWD.launches
            counter = FlopCounterMode(display=False)
            with counter:
                loss = step(tokens)
            # the attention kernel's pairs over this rank's rows: causal,
            # (query, key <= query)
            pairs = batch // n_dev * cfg.n_heads * seq * (seq + 1) / 2
            attn = ((_attention.KERNEL.launches - fwd0) * 4
                    + (_attention.KERNEL_BWD.launches - bwd0) * 10) * cfg.head_dim * pairs
            # this rank's count, times the ranks: every shard is the same size
            exec_flops = (float(counter.get_total_flops()) + attn) * n_dev or None
        else:
            loss = step(tokens)
    float(loss)
    compile_s = time.perf_counter() - t_c0

    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step(tokens)
    float(loss)
    wall = time.perf_counter() - t0

    prof = None
    if profile:
        from .benchguard import profile_step

        def one_step():
            nonlocal loss
            loss = step(tokens)
            float(loss)

        prof = profile_step(one_step, n_dev)

    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    peak, granularity = peak_flops_per_device(dev)
    steps_per_sec = steps / wall
    tokens_per_step = batch * seq
    tokens_per_sec = tokens_per_step * steps_per_sec
    model_fps = model_flops_per_token(cfg, seq) * tokens_per_step
    mfu = (model_fps * steps_per_sec / (peak * n_dev)) if peak else None
    # the JAX payload's guard: a count below half the model's FLOPs is not
    # plausible, and then no hfu is reported
    if exec_flops is not None and exec_flops < 0.5 * model_fps:
        exec_flops = None
    hfu = (exec_flops * steps_per_sec / (peak * n_dev)) \
        if (peak and exec_flops) else None
    return {
        "workload": f"llama-{preset}",
        "device_kind": kind,
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "n_devices": n_dev,
        "device_granularity": granularity,
        "params_matmul": n_matmul_params(cfg),
        "batch": batch,
        "seq": seq,
        "steps": steps,
        "optimizer": optimizer,
        "remat": remat,
        "compile_s": round(compile_s, 2),
        "step_time_ms": round(1000 * wall / steps, 2),
        "tokens_per_sec": round(tokens_per_sec, 1),
        "tokens_per_sec_per_device": round(tokens_per_sec / n_dev, 1),
        "model_flops_per_step": model_fps,
        "exec_flops_per_step": exec_flops,
        "peak_flops_per_device": peak,
        "mfu": round(mfu, 4) if mfu is not None else None,
        "hfu": round(hfu, 4) if hfu is not None else None,
        "final_loss": float(loss),
        "profile": prof,
    }


def run_sweep(candidates, preset, seq, steps, optimizer, remat=True,
              watchdog=None, profile=True, probe_steps=3, device="cuda", mesh=None) -> dict:
    """Batch sweep: probe each candidate batch with a few steps, run the
    winner at full length.  A candidate that runs out of device memory is
    recorded and skipped, its tensors freed before the next one; any other
    error (a kernel's launch error among them) propagates, where the JAX
    payload's bare ``except`` would record it as a failed candidate.

    One data rank only: raises over a mesh of more, where one rank out of
    memory would go on to its next candidate while the others wait for it
    in the failed step's collectives."""
    import torch

    from .sharding import data_ranks, launched_mesh, resolve_device

    mesh = mesh if mesh is not None else launched_mesh(resolve_device(device))
    if data_ranks(mesh) > 1:
        raise ValueError(f"run_sweep: a sweep runs on one data rank, not {data_ranks(mesh)}: "
                         f"sweep on one card, then run the winner over the mesh")
    probes = {}
    best, best_tps = None, -1.0
    for i, b in enumerate(candidates):
        try:
            r = run(preset, b, seq, probe_steps, optimizer, warmup=1,
                    remat=remat, watchdog=watchdog if i == 0 else None,
                    profile=False, device=device, mesh=mesh)
            probes[b] = {"tokens_per_sec": r["tokens_per_sec"],
                         "mfu": r["mfu"]}
            if r["tokens_per_sec"] > best_tps:
                best, best_tps = b, r["tokens_per_sec"]
        except torch.cuda.OutOfMemoryError as e:
            if i == 0 and watchdog is not None:
                # run() may have raised before reaching its cancel(): a
                # still-armed timer would hard-kill a later healthy run
                watchdog.cancel()
            probes[b] = {"error": f"{type(e).__name__}: {str(e)[:160]}"}
        # the last run's tensors go before the next candidate's are made
        # (a failed run's frames, which hold them, went with its exception)
        gc.collect()
        torch.cuda.empty_cache()
    if best is None:
        return {"error": "every sweep candidate failed", "sweep": probes}
    result = run(preset, best, seq, steps, optimizer, remat=remat,
                 profile=profile, device=device, mesh=mesh)
    result["sweep"] = probes
    result["sweep_winner_batch"] = best
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="", help="write result JSON here")
    ap.add_argument("--preset", default="1b-tpu", choices=sorted(PRESETS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--sweep", default="",
                    help="comma-separated batch candidates; probe each, "
                         "run the best at full --steps")
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--optimizer", default="adafactor",
                    choices=["adamw", "adafactor", "sgdm"])
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-profile", action="store_true")
    ap.add_argument("--acquire-timeout", type=float, default=180.0,
                    help="hard exit if the device claim hangs this long")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on ('cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    from .benchguard import device_acquisition_watchdog, run_payload

    watchdog = device_acquisition_watchdog(args.out, args.acquire_timeout)

    def compute():
        if args.sweep:
            return run_sweep(
                [int(b) for b in args.sweep.split(",") if b.strip()],
                args.preset, args.seq, args.steps, args.optimizer,
                remat=not args.no_remat, watchdog=watchdog,
                profile=not args.no_profile, device=args.device)
        return run(args.preset, args.batch, args.seq, args.steps,
                   args.optimizer, remat=not args.no_remat,
                   watchdog=watchdog, profile=not args.no_profile,
                   device=args.device)

    run_payload(compute, args.out, watchdog)


if __name__ == "__main__":
    main()
