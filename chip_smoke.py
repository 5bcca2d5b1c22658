#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

1. builds the hand-written kernels from kubernetes1_tpu_torch/csrc with nvcc;
2. holds each kernel against its plain PyTorch version on the card, at the
   Llama-3-8B decode server's shapes and at a few odd small ones, and times
   the kernel, the plain version and (as a yardstick only) the one PyTorch
   call that computes the same function;
3. holds the forward built on the kernels against the forward built on the
   plain versions, at Llama-3-8B widths with 2 layers;
4. serves Llama-3-8B (all 32 layers, random weights from a seed) on 8 slots
   through DecodeServer: 12 concurrent HTTP requests, one streamed, and
   checks the tokens, the /metrics surface and that every kernel was
   launched by that run.

It exits non-zero, with no result line, when there is no CUDA device or a
phase fails.  The line before the last is the kernels' JSON; the last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from kubernetes1_tpu_torch.kernels import attention, build, rmsnorm, rope
from kubernetes1_tpu_torch.workloads import llama

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BF16_TENSOR = 989e12   # FLOP/s
PEAK_F32 = 67e12            # FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12        # HBM bytes/s

# Tolerances of kernel vs plain version on the same bf16 inputs, as
# |kernel - plain| <= atol + rtol * |plain| on every element.
# RMSNorm, RoPE: the kernel sums squares (RMSNorm) or evaluates cos/sin/pow
# (RoPE) in another order or library than the plain version, so an f32
# intermediate may round to the neighbouring bf16 value; the output rounds
# twice (RMSNorm: before and after the scale), so two bf16 steps, 2^-6.
ELEMENTWISE_TOL = (1e-6, 2.0 ** -6)
# Attention: the kernel rounds the UNNORMALISED probabilities to bf16 for
# P.V and divides by the f32 row sum at the end; the plain version (JAX's
# order) rounds the normalised ones.  Each probability then differs by up
# to one bf16 step (2^-8 relative), which moves the output by at most
# 2^-8 * max|v| (~0.02 at |v| <= 5); the output's own rounding adds one
# step, 2^-7 relative.
ATTENTION_TOL = (3e-2, 2.0 ** -7)
# Forward, kernels vs plain, relative L2 error of the logits: each of the
# three kernels in each of the 2 layers may round an element one bf16 step
# (2^-8 relative) away from its plain version; 2e-2 is five such steps.
FORWARD_REL_L2_TOL = 2e-2

SERVE_SLOTS = 8
SERVE_REQUESTS = 12
SERVE_MAX_NEW = 8


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_close(name: str, got, want, tol) -> float:
    """Max abs error over all outputs; fail beyond atol + rtol*|want|."""
    atol, rtol = tol
    worst = 0.0
    for g, w in zip(got, want):
        torch.cuda.synchronize()
        g, w = g.float(), w.float()
        if g.shape != w.shape or not torch.isfinite(g).all():
            fail(f"{name}: shape {tuple(g.shape)} vs {tuple(w.shape)} or non-finite output")
        err = (g - w).abs()
        if not bool((err <= atol + rtol * w.abs()).all()):
            fail(f"{name}: max abs err {err.max().item():.3e} beyond atol {atol} rtol {rtol}")
        worst = max(worst, err.max().item())
    return worst


def bf16(shape, gen, dev, scale=1.0, shift=0.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale + shift).to(torch.bfloat16)


def kernel_phase(dev, gen) -> list:
    """Each kernel against its plain version; times at the 8B shapes."""
    # small odd shapes: tails of the 64-row tiles, every head_dim, GQA 1..4
    for B, S, H, Hkv, hd in ((2, 37, 4, 2, 16), (1, 100, 8, 2, 64), (3, 130, 4, 1, 32),
                             (2, 8, 32, 8, 128), (1, 65, 8, 8, 128)):
        q, k, v = (bf16((B, S, h, hd), gen, dev) for h in (H, Hkv, Hkv))
        check_close(f"attention {B, S, H, Hkv, hd}", [attention.attention(q, k, v)],
                    [attention.attention_plain(q, k, v)], ATTENTION_TOL)
        check_close(f"rope {B, S, H, Hkv, hd}", rope.rope(q, k, 5e5),
                    rope.rope_plain(q, k, 5e5), ELEMENTWISE_TOL)
        x, sc = bf16((B * S, H * hd), gen, dev), bf16((H * hd,), gen, dev, 0.1, 1.0)
        check_close(f"rmsnorm {B * S, H * hd}", [rmsnorm.rmsnorm(x, sc)],
                    [rmsnorm.rmsnorm_plain(x, sc)], ELEMENTWISE_TOL)

    cfg = llama.llama_3_8b()
    B, S, H, Hkv, hd = 8, 1024, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rows, d = B * S, cfg.d_model
    q, k, v = (bf16((B, S, h, hd), gen, dev) for h in (H, Hkv, Hkv))
    x, sc = bf16((rows, d), gen, dev), bf16((d,), gen, dev, 0.1, 1.0)
    out = []

    err = check_close("attention 8B", [attention.attention(q, k, v)],
                      [attention.attention_plain(q, k, v)], ATTENTION_TOL)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    pairs = S * (S + 1) / 2  # unmasked (query, key) pairs per head
    b_ms, b_by = bound_ms(2 * (2 * q.numel() + 2 * k.numel()),
                          4 * B * H * hd * pairs, PEAK_BF16_TENSOR)
    out.append(dict(
        name="attention", route="cuda", source="kubernetes1_tpu_torch/csrc/attention.cu",
        replaces="kubernetes1_tpu/workloads/llama.py:144", max_abs_err=err,
        ms=time_ms(lambda: attention.attention(q, k, v)),
        plain_ms=time_ms(lambda: attention.attention_plain(q, k, v), iters=5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))))

    err = check_close("rmsnorm 8B", [rmsnorm.rmsnorm(x, sc)], [rmsnorm.rmsnorm_plain(x, sc)],
                      ELEMENTWISE_TOL)
    b_ms, b_by = bound_ms(2 * (2 * x.numel() + sc.numel()), 4 * x.numel(), PEAK_F32)
    out.append(dict(
        name="rmsnorm", route="cuda", source="kubernetes1_tpu_torch/csrc/rmsnorm.cu",
        replaces="kubernetes1_tpu/workloads/llama.py:128", max_abs_err=err,
        ms=time_ms(lambda: rmsnorm.rmsnorm(x, sc)),
        plain_ms=time_ms(lambda: rmsnorm.rmsnorm_plain(x, sc)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F.rms_norm(x, (d,), sc, 1e-5))))

    err = check_close("rope 8B", rope.rope(q, k, cfg.rope_theta),
                      rope.rope_plain(q, k, cfg.rope_theta), ELEMENTWISE_TOL)
    n = q.numel() + k.numel()
    b_ms, b_by = bound_ms(2 * 2 * n, 3 * n, PEAK_F32)  # 6 flops per rotated pair
    out.append(dict(
        name="rope", route="cuda", source="kubernetes1_tpu_torch/csrc/rope.cu",
        replaces="kubernetes1_tpu/workloads/llama.py:133", max_abs_err=err,
        ms=time_ms(lambda: rope.rope(q, k, cfg.rope_theta)),
        plain_ms=time_ms(lambda: rope.rope_plain(q, k, cfg.rope_theta)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    # the smallest bucket the engine steps at (8 slots x 8 tokens): the
    # time per call there is the wrapper's host cost, not the kernel's
    q8, k8, x8 = q[:, :8].contiguous(), k[:, :8].contiguous(), x[:64].contiguous()
    print("bucket-8 call floor ms: "
          f"attention={time_ms(lambda: attention.attention(q8, k8, k8)):.4f} "
          f"rmsnorm={time_ms(lambda: rmsnorm.rmsnorm(x8, sc)):.4f} "
          f"rope={time_ms(lambda: rope.rope(q8, k8, cfg.rope_theta)):.4f}", flush=True)
    for r in out:
        print(f"kernel {r['name']}: max_abs_err={r['max_abs_err']:.3e} ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
    return out


def forward_phase(dev):
    """Kernel forward vs plain forward, Llama-3-8B widths, 2 layers."""
    cfg = dataclasses.replace(llama.llama_3_8b(), n_layers=2)
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(1))
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 1000))).to(dev)
    with torch.inference_mode():
        got = llama.forward(cfg, params, tokens, llama.KERNELS)
        want = llama.forward(cfg, params, tokens, llama.PLAIN)
        torch.cuda.synchronize()
        if got.shape != (4, 1000, cfg.vocab) or got.dtype != torch.float32:
            fail(f"forward: logits {tuple(got.shape)} {got.dtype}")
        if not torch.isfinite(got).all():
            fail("forward: non-finite logits")
        rel = ((got - want).norm() / want.norm()).item()
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    print(f"forward (8B widths, 2 layers, 4x1000 tokens): rel_l2={rel:.3e} "
          f"(tol {FORWARD_REL_L2_TOL}), argmax agreement={agree:.4f}", flush=True)
    if not rel <= FORWARD_REL_L2_TOL:
        fail(f"forward: relative L2 error {rel:.3e} beyond {FORWARD_REL_L2_TOL}")


def _post(url: str, body: dict, timeout: float = 600.0) -> list:
    req = urllib.request.Request(url + "/generate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        if not body.get("stream"):
            return json.loads(resp.read())["tokens"]
        toks, done = [], False
        for line in resp:
            msg = json.loads(line)
            if msg.get("done"):
                done = True
            else:
                toks.append(msg["token"])
        return toks if done else []


def _get(url: str) -> str:
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.read().decode()


def serving_phase(card: str) -> dict:
    """Llama-3-8B behind DecodeServer on the card: the main path."""
    cfg = llama.llama_3_8b()
    t0 = time.monotonic()
    srv = llama.DecodeServer(cfg=cfg, slots=SERVE_SLOTS, seed=0)  # device: the card
    try:
        srv.warmup()
        print(f"serving: 8B weights made and warmed up in {time.monotonic() - t0:.1f} s",
              flush=True)
        srv.start()
        engine = srv.engine
        rng = np.random.default_rng(0)
        lengths = np.linspace(5, 1000, SERVE_REQUESTS).astype(int)
        prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lengths]
        results: list = [None] * SERVE_REQUESTS
        errors: list = []

        def one(i):
            try:
                results[i] = _post(srv.url, {"tokens": prompts[i], "max_new": SERVE_MAX_NEW,
                                             "stream": i == 0})
            except Exception as e:  # noqa: BLE001 - reported below, fails the run
                errors.append(f"request {i}: {e!r}")

        threads = [threading.Thread(target=one, args=(i,), daemon=True)
                   for i in range(SERVE_REQUESTS)]
        kernels = (attention.KERNEL, rmsnorm.KERNEL, rope.KERNEL)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for kern in kernels:
            kern.launches = 0
        steps0, toks0 = engine.steps, engine.tokens_out
        t0 = time.monotonic()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        wall = time.monotonic() - t0
        launches = {kern.source: kern.launches for kern in kernels}
        steps, toks = engine.steps - steps0, engine.tokens_out - toks0
        peak = torch.cuda.max_memory_allocated()
        if errors or any(th.is_alive() for th in threads):
            fail(f"serving: {errors or 'requests did not finish'}")
        for i, out in enumerate(results):
            if (not isinstance(out, list) or len(out) != SERVE_MAX_NEW
                    or not all(0 <= t < cfg.vocab for t in out)):
                fail(f"serving: request {i} (prompt {lengths[i]}) returned {out!r}")
        per_step = {"attention": cfg.n_layers, "rmsnorm": 2 * cfg.n_layers + 1,
                    "rope": cfg.n_layers}
        for name, n in launches.items():
            if n == 0 or n != per_step[name] * steps:
                fail(f"serving: {name} launched {n} times in {steps} steps, "
                     f"want {per_step[name]} per step")
        metrics = _get(srv.url + "/metrics")
        if f"ktpu_llama_slots_total {float(SERVE_SLOTS)}" not in metrics.splitlines():
            fail("serving: /metrics lacks ktpu_llama_slots_total 8")
        if json.loads(_get(srv.url + "/healthz")) != {"status": "ok"}:
            fail("serving: /healthz")
        # one engine step at the engine's smallest bucket and at this run's
        # largest, for the share of a step that the kernels take
        forward_ms = {}
        with torch.inference_mode():
            for bucket in (8, 1024):
                toks_b = torch.from_numpy(rng.integers(0, cfg.vocab, (SERVE_SLOTS, bucket)))
                toks_b = toks_b.cuda()
                forward_ms[bucket] = time_ms(lambda: llama.forward(cfg, srv.params, toks_b),
                                             3, 1)
    finally:
        srv.stop()
    res = dict(requests=SERVE_REQUESTS, steps=steps, tokens=toks, wall_s=wall,
               step_ms=wall / steps * 1e3, tokens_per_s=toks / wall,
               peak_mem_gib=peak / 2 ** 30, launches=launches)
    print(f"serving (Llama-3-8B, {SERVE_SLOTS} slots, {SERVE_REQUESTS} requests x "
          f"{SERVE_MAX_NEW} tokens, prompts 5-1000): steps={steps} tokens={toks} "
          f"wall_s={wall:.3f} step_ms={res['step_ms']:.2f} "
          f"tokens_per_s={res['tokens_per_s']:.2f} peak_mem_gib={res['peak_mem_gib']:.2f} "
          f"forward_ms(8x8)={forward_ms[8]:.2f} forward_ms(8x1024)={forward_ms[1024]:.2f} "
          f"launches={launches} on [{card}]", flush=True)
    return res


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device is visible")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions run in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.monotonic()
    libs = build.build_all()
    print(f"build: {sorted(libs)} in {time.monotonic() - t0:.1f} s", flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = kernel_phase(dev, gen)
    torch.cuda.empty_cache()
    forward_phase(dev)
    torch.cuda.empty_cache()
    serve = serving_phase(card)
    for r in rows:
        r["launches"] = serve["launches"][r["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
