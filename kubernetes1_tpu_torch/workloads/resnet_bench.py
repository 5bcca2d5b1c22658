"""ResNet-50 training benchmark payload, the counterpart of the JAX
package's ``workloads/resnet_bench.py``:

    python -m kubernetes1_tpu_torch.workloads.resnet_bench --out <file>

Reports imgs/sec (total and per device) and model-flops MFU for ResNet-50
trained with SGD on one fixed synthetic batch: FLOPs per step come from
``torch.utils.flop_counter.FlopCounterMode`` over the first warm-up step
(the counterpart of XLA's cost analysis; analytic fallback), the peak
from the device kind (``gpu_peaks``).  Same flags, defaults and result
keys as the JAX payload, with ``--device`` (default ``cuda``) in place of
``--platform``.  Without a card it writes ``{"error": ...}`` and exits 1.

Data parallel under a launcher, one process per card:

    torchrun --nproc-per-node=N -m kubernetes1_tpu_torch.workloads.resnet_bench --out <file>

``--batch`` is then the global batch, split over the N data ranks
(``sharding.auto_mesh``); ``n_devices`` is N, the FLOPs are one rank's
count times N (the shards are equal) and MFU divides by N cards' peak, as
the JAX payload does.  Only rank 0 prints and writes the result.
"""

from __future__ import annotations

import argparse
import time

from .gpu_peaks import peak_flops_per_device

# Analytic fallback: ResNet-50 forward ≈ 4.1 GFLOP/img at 224x224 (counting
# a MAC as 2 FLOPs); a training step costs ~3x forward (fwd + 2x bwd).
RESNET50_TRAIN_FLOPS_PER_IMG_224 = 3 * 4.1e9


def run(batch: int, steps: int, size: int, warmup: int = 2, watchdog=None,
        profile: bool = True, device: str = "cuda", mesh=None) -> dict:
    """The payload's result on this rank.  ``batch`` is the global batch;
    without ``mesh``, ``sharding.launched_mesh`` decides (one device
    unless a launcher set the environment)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from .resnet import ResNetConfig, make_train_state, make_train_step, synthetic_batch
    from .sharding import data_ranks, launched_mesh, resolve_device

    dev = resolve_device(device)
    if watchdog is not None:
        watchdog.cancel()  # device claim succeeded: stand down
    mesh = mesh if mesh is not None else launched_mesh(dev)
    n_dev = data_ranks(mesh)
    cfg = ResNetConfig()
    params, opt = make_train_state(cfg, dev, seed=0, mesh=mesh)
    step = make_train_step(cfg, params, opt, mesh=mesh)
    # feed in the compute dtype: the stem conv reads the raw pixels, so a
    # f32 feed doubles the first (and largest-spatial) read for nothing
    images, labels = synthetic_batch(cfg, batch, size, cfg.dtype, dev)

    # barrier = float(loss): a device-to-host copy of the result waits for
    # the step's kernels
    t_compile0 = time.perf_counter()
    flops_per_step = None
    loss = first = None
    for i in range(max(warmup, 1)):
        if i == 0:
            counter = FlopCounterMode(display=False)
            with counter:
                loss = step(images, labels)
            # this rank's count, times the ranks: every shard is the same size
            flops_per_step = float(counter.get_total_flops()) * n_dev or None
            first = float(loss)
        else:
            loss = step(images, labels)
    float(loss)
    compile_s = time.perf_counter() - t_compile0
    if not flops_per_step:
        flops_per_step = RESNET50_TRAIN_FLOPS_PER_IMG_224 * batch * (size / 224.0) ** 2

    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step(images, labels)
    float(loss)
    wall = time.perf_counter() - t0

    prof = None
    if profile:
        from .benchguard import profile_step

        def one_step():
            nonlocal loss
            loss = step(images, labels)
            float(loss)

        prof = profile_step(one_step, n_dev)

    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    peak, granularity = peak_flops_per_device(dev)
    steps_per_sec = steps / wall
    imgs_per_sec = batch * steps_per_sec
    mfu = (flops_per_step * steps_per_sec / (peak * n_dev)) if peak else None
    return {
        "workload": "resnet50",
        "device_kind": kind,
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "n_devices": n_dev,
        "device_granularity": granularity,
        "batch": batch,
        "image_size": size,
        "steps": steps,
        "compile_s": round(compile_s, 2),
        "step_time_ms": round(1000 * wall / steps, 2),
        "imgs_per_sec": round(imgs_per_sec, 1),
        "imgs_per_sec_per_device": round(imgs_per_sec / n_dev, 1),
        "flops_per_step": flops_per_step,
        "peak_flops_per_device": peak,
        "mfu": round(mfu, 4) if mfu is not None else None,
        "first_loss": first,
        "final_loss": float(loss),
        "profile": prof,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="", help="write result JSON here")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--no-profile", action="store_true")
    ap.add_argument("--acquire-timeout", type=float, default=180.0,
                    help="hard exit if the device claim hangs this long")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on ('cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    from .benchguard import device_acquisition_watchdog, run_payload

    watchdog = device_acquisition_watchdog(args.out, args.acquire_timeout)
    run_payload(lambda: run(args.batch, args.steps, args.size, watchdog=watchdog,
                            profile=not args.no_profile, device=args.device),
                args.out, watchdog)


if __name__ == "__main__":
    main()
