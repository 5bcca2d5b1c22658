"""Bench payload self-defense and per-op profiling, the counterpart of the
JAX package's ``workloads/benchguard.py``.

- device_acquisition_watchdog: a timer thread that writes a distinct
  ``"error": "device acquisition timeout"`` result and hard-exits when
  claiming the device hangs (a thread, not SIGALRM: the hang sits inside a
  C call where Python signal handlers do not run).
- collect_profile: one profiled step through ``torch.profiler``,
  summarized to the top-N kernels by self device time.  The JAX version
  also reports each op's "bound by" from xprof; torch's profiler has no
  such verdict, so ``bound`` is "unknown".
- profile_step: the same for a step that every data rank runs, where a
  profiler's failure must not keep a rank from its collectives.
- run_payload: a payload's main around its run: rank 0 alone prints and
  writes the result, then the process group ends.
"""

from __future__ import annotations

import json
import os
import sys
import threading
from typing import Optional


def device_acquisition_watchdog(out_path: str, seconds: float = 180.0):
    """Arm before touching the device; .cancel() once it is held.
    On expiry: write the distinct error result and _exit(3)."""

    def boom():
        msg = {"error": "device acquisition timeout",
               "watchdog_seconds": seconds}
        try:
            if out_path:
                with open(out_path, "w") as f:
                    json.dump(msg, f)
        except OSError:
            pass
        sys.stderr.write(json.dumps(msg) + "\n")
        sys.stderr.flush()
        os._exit(3)

    timer = threading.Timer(seconds, boom)
    timer.daemon = True
    timer.start()
    return timer


def collect_profile(run_once, top_n: int = 5) -> Optional[dict]:
    """Profile one step invocation; return {"top_ops": [...], "bound":
    "unknown", ...} or an {"error": ...} dict.  Never raises: profiling
    must not be able to fail the benchmark."""
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            run_once()
        return summarize_device_ops(prof.key_averages(), top_n)
    except Exception as e:  # noqa: BLE001
        return {"error": f"{type(e).__name__}: {e}"}


def profile_step(run_once, ranks: int, top_n: int = 5) -> Optional[dict]:
    """``collect_profile(run_once)`` for a step that each of ``ranks`` data
    ranks runs.  With one rank, exactly that.  With more, the step runs
    once whatever the profiler does (the other ranks wait for it in its
    collectives): a failure of the step itself raises, and a profiler that
    failed before the step leaves the step to run unprofiled."""
    if ranks == 1:
        return collect_profile(run_once, top_n)
    ran, failed = [], []

    def guarded():
        ran.append(True)
        try:
            run_once()
        except BaseException as e:
            failed.append(e)
            raise

    prof = collect_profile(guarded, top_n)
    if failed:
        raise failed[0]
    if not ran:
        run_once()
    return prof


def run_payload(compute, out_path: str, watchdog) -> None:
    """Run ``compute()`` and report its result dict, or the error it
    raised as ``{"error": ...}``: rank 0 prints it and writes it to
    ``out_path`` (every rank of a data-parallel run computes the same
    result; another rank's error goes to its stderr).  The rank is read
    before the process group is ended, after the run's last collective.
    Exits 1 on an error."""
    from .sharding import end_process_group, is_rank0

    try:
        result, failed = compute(), False
    except Exception as e:  # noqa: BLE001
        result, failed = {"error": f"{type(e).__name__}: {e}"}, True
    finally:
        watchdog.cancel()
    rank0 = is_rank0()
    end_process_group()
    if rank0:
        print(json.dumps(result), flush=True)
        if out_path:
            with open(out_path, "w") as f:
                json.dump(result, f)
    elif failed:
        sys.stderr.write(json.dumps(result) + "\n")
    if failed:
        sys.exit(1)


def device_time_us(event) -> float:
    """Self device time of one key_averages() entry, in microseconds
    (the attribute's name differs between torch versions)."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(event, attr, None)
        if value is not None:
            return float(value)
    return 0.0


def is_device_op(event) -> bool:
    """A kernel, copy or set that ran on the device.  Host-side ops are
    not, and neither are the device-side ranges of ``record_function``
    annotations (``Optimizer.step#AdamW.step``): their self device time is
    the same kernels counted again, as torch's own table leaves them out."""
    return ("cuda" in str(getattr(event, "device_type", "")).lower()
            and not getattr(event, "is_user_annotation", False))


def summarize_device_ops(events, top_n: int = 5) -> dict:
    """The device's own activity (``is_device_op``) among the profiler's
    averaged events, by self device time."""
    rows = []
    for ev in events:
        if not is_device_op(ev):
            continue
        us = device_time_us(ev)
        if us > 0:
            rows.append({"op": str(ev.key)[:96], "self_time_us": us, "count": int(ev.count)})
    rows.sort(key=lambda r: -r["self_time_us"])
    if not rows:
        return {"error": "no device ops in trace "
                         "(host-only platform or empty capture)"}
    total = sum(r["self_time_us"] for r in rows)
    top = [{"op": r["op"], "category": "kernel",
            "self_time_pct": round(100.0 * r["self_time_us"] / total, 1),
            "bound_by": None} for r in rows[:top_n]]
    return {
        "top_ops": top,
        "bound": "unknown",
        "bound_breakdown_pct": {"unknown": 100.0},
        "ops_counted": len(rows),
        "device_time_us": total,
    }
