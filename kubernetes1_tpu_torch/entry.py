"""Entry points of the PyTorch port: the counterpart of the JAX package's
``__graft_entry__.py``.

- ``entry(device=None)``: the flagship model's forward (Llama,
  ``workloads/llama.py``) and example arguments, at the JAX entry's
  config, for a one-card check;
- ``dryrun_multichip(n)``: n ranks, processes of this module, each on its
  own card (NCCL) or, where the caller asks for the CPU, gloo ranks there:
  a sharded Llama and a sharded BERT train step on the
  ``(dp, fsdp, tp)`` mesh of ``_factor3(n)``, and ring attention over an
  ``sp`` mesh of all n ranks against dense attention.  In place of JAX's
  count of SPMD partitioner warnings, every rank asserts that it holds
  its specs' share of the parameters and of AdamW's state.

    python -m kubernetes1_tpu_torch.entry [N] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import numpy as np
import torch
import torch.distributed as dist

RING_TOL_F32 = 1e-4               # JAX's dryrun bar, f32 on the CPU
RING_TOL_BF16 = (3.2e-2, 1e-2)    # atol, rtol: chip_smoke.py's RING_OUT_TOL, bf16 kernels
RANK_TIMEOUT_S = 600


def entry(device=None):
    """(fn, (params, tokens)): ``fn(params, tokens)`` is Llama's forward at
    the JAX entry's config (4 layers of d 512, vocab 4096), the logits
    (4, 128, 4096) f32; the f32 weights drawn from seed 0 and the tokens
    from numpy's ``default_rng(0)``, as the JAX entry draws them.  On the
    card unless ``device="cpu"``; raises when no card is visible."""
    from .workloads import llama
    from .workloads.sharding import resolve_device

    dev = resolve_device(device)
    cfg = llama.LlamaConfig(vocab=4096, d_model=512, n_layers=4, n_heads=8, n_kv_heads=4,
                            d_ff=1024, max_seq=512, remat=False)
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               dtype=torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (4, 128))).to(dev)

    def fn(params, tokens):
        return llama.forward(cfg, params, tokens)

    return fn, (params, tokens)


def _factor3(n):
    """n -> (dp, fsdp, tp) using all three axes where possible."""
    tp = 2 if n % 2 == 0 else 1
    rem = n // tp
    fsdp = 1
    for f in range(int(rem ** 0.5), 0, -1):
        if rem % f == 0:
            fsdp = max(f, rem // f)
            break
    dp = rem // fsdp
    return dp, fsdp, tp


def _held_numel(mod, cfg, params, opt, mesh) -> int:
    """This rank's parameter elements, after asserting that they and
    AdamW's state (m and v) are the specs' share of the whole model's."""
    from .workloads import sharding

    whole = [s for _, s in sharding.whole_shapes(mod.leaf_shapes(cfg), cfg.n_layers,
                                                 mod.param_leaves)]
    specs = sharding.spec_leaves(mod.param_specs(cfg), cfg.n_layers, mod.param_leaves)
    want = sharding.spec_numel(whole, specs, mesh)
    leaves = mod.param_leaves(params)
    held = sum(p.numel() for p in leaves)
    state = sum(t.numel() for p in leaves for t in opt.state[p].values())
    if held != want or state != 2 * want:
        raise AssertionError(f"{mod.__name__}: this rank holds {held} parameters and {state} "
                             f"of AdamW's state; its specs' share is {want} and {2 * want}")
    return held


def _rank_checks(n: int, dev: torch.device) -> str:
    """JAX's three dryrun checks on this rank: the result line."""
    from torch.distributed.device_mesh import DeviceMesh

    from .workloads import bert, llama, ringattention, sharding

    dp, fsdp, tp = _factor3(n)
    mesh = sharding.make_mesh(dp, fsdp, tp, device_type=dev.type)
    # JAX's shapes: heads divisible by tp, seq by the data axes; the card's
    # attention kernels take hd >= 16, so there d grows with the heads
    heads = 2 * tp
    d = 32 if dev.type == "cpu" else max(32, 16 * heads)
    batch = max(4, dp * fsdp)
    cfg = llama.tiny(vocab=128, d_model=d, n_layers=2, n_heads=heads, n_kv_heads=tp, d_ff=64,
                     max_seq=32)
    params, opt = llama.make_train_state(cfg, dev, mesh=mesh)
    step = llama.make_train_step(cfg, params, opt, mesh=mesh)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (batch, 32)))
    loss = float(step(tokens.to(dev)))
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite llama loss {loss}")
    llama_numel = _held_numel(llama, cfg, params, opt, mesh)

    bcfg = bert.tiny(vocab=128, d_model=d, n_layers=2, n_heads=heads, d_ff=64, max_seq=32)
    bparams, bopt = bert.make_train_state(bcfg, dev, mesh=mesh)
    bstep = bert.make_train_step(bcfg, bparams, bopt, mesh=mesh)
    btokens, bmask = bert.synthetic_batch(bcfg, batch, 32)
    bloss = float(bstep(btokens.to(dev), bmask.to(dev)))
    if not np.isfinite(bloss):
        raise AssertionError(f"non-finite bert loss {bloss}")
    bert_numel = _held_numel(bert, bcfg, bparams, bopt, mesh)

    # sequence parallelism: ring attention over all n ranks, 8 positions each
    sp = DeviceMesh(dev.type, torch.arange(n), mesh_dim_names=("sp",))
    hd, dt = (8, torch.float32) if dev.type == "cpu" else (16, torch.bfloat16)
    rng = np.random.default_rng(0)
    q, kv = (torch.from_numpy(rng.standard_normal((1, 8 * n, 2, hd)).astype(np.float32))
             .to(dev, dt) for _ in range(2))
    r = dist.get_rank()
    own = slice(8 * r, 8 * (r + 1))
    out = ringattention.ring_attention(q[:, own].contiguous(), kv[:, own].contiguous(),
                                       kv[:, own].contiguous(), sp, "sp")
    every = out.new_empty((n,) + tuple(out.shape[1:]))  # B = 1: the blocks in rank order
    dist.all_gather_into_tensor(every, out.contiguous())
    got = every.reshape(q.shape).float()
    ref = ringattention.reference_attention(q.float(), kv.float(), kv.float())
    err = float((got - ref).abs().max())
    if dev.type == "cpu":
        if not err < RING_TOL_F32:
            raise AssertionError(f"ring attention mismatch: {err}")
    elif not bool(((got - ref).abs() <= RING_TOL_BF16[0] + RING_TOL_BF16[1] * ref.abs()).all()):
        raise AssertionError(f"ring attention mismatch: {err} beyond {RING_TOL_BF16}")
    return (f"dryrun ok: mesh dp={dp} fsdp={fsdp} tp={tp}, llama loss={loss:.3f}, "
            f"bert loss={bloss:.3f}, ring err={err:.2e}, param bytes/rank=llama "
            f"{llama_numel * 4} bert {bert_numel * 4}")


def _rank_main(rank: int, n: int, store: str, device_type: str):
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            store=dist.FileStore(store, n), rank=rank, world_size=n)
    try:
        dev = torch.device(device_type, torch.cuda.current_device()) \
            if device_type == "cuda" else torch.device("cpu")
        line = _rank_checks(n, dev)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        print(line, flush=True)


def dryrun_multichip(n_devices: int = 8, device=None) -> str:
    """Run the sharded dryrun on ``n_devices`` ranks, processes of this
    module rendezvousing through a FileStore in a temporary directory:
    NCCL with one card a rank, or gloo on the CPU where ``device="cpu"``.
    Raises when fewer cards than ranks are visible, or when a rank fails.
    Prints rank 0's result line and returns it."""
    from .workloads.sharding import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip: {n_devices} NCCL ranks need {n_devices} cards, "
                           f"{torch.cuda.device_count()} visible; pass device='cpu' for gloo "
                           f"ranks on the CPU")
    tmp = tempfile.mkdtemp(prefix="ktpu_dryrun")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    try:
        for r in range(n_devices):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "kubernetes1_tpu_torch.entry", "--rank", str(r),
                 str(n_devices), "--store", f"{tmp}/store", "--device", dev.type],
                cwd=root, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        outs = [p.communicate(timeout=RANK_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        shutil.rmtree(tmp, ignore_errors=True)
    if any(p.returncode for p in procs):
        errs = "\n".join(f"--- rank {r} (exit {p.returncode})\n{err[-2000:]}"
                         for r, (p, (_out, err)) in enumerate(zip(procs, outs)) if p.returncode)
        raise RuntimeError(f"dryrun_multichip: ranks failed\n{errs}")
    line = outs[0][0].strip().splitlines()[-1]
    print(line, flush=True)
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=8, help="ranks (default 8)")
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank_main(args.rank, args.n, args.store, args.device)
    else:
        dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()
