"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface and loaded with
``ctypes``: no PyTorch headers, so a build takes seconds.  Libraries go
into ``kubernetes1_tpu_torch/_build/`` (git-ignored), named by a hash of
the sources and flags, so a changed source is rebuilt and an unchanged
one is built once per checkout.  ``build_all`` starts one ``nvcc`` per
source, all at once.

Nothing here runs at import time: the CPU tests import every module,
and this machine may have no ``nvcc``.  A kernel's C entry point
launches on the stream it is given, allocates nothing, and returns
``cudaGetLastError()``; ``Kernel.launch`` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}   # process-wide: one load per library


class KernelUnavailableError(RuntimeError):
    """A kernel could not be built or loaded (no nvcc, a compile error)."""


class KernelLaunchError(RuntimeError):
    """A kernel's launch returned a CUDA error."""


def _find_nvcc() -> Optional[str]:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    return None


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every named source (default: all of ``csrc/*.cu``) that
    has no library yet, one ``nvcc`` per source, all started together.
    Returns name -> library path; raises KernelUnavailableError with the
    compiler's output when any build fails."""
    names = sorted(names or (p.stem for p in CSRC_DIR.glob("*.cu")))
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    nvcc = _find_nvcc()
    if nvcc is None:
        raise KernelUnavailableError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List[tuple] = []
    try:
        for n in todo:
            tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR),
                   "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")]
            procs.append((n, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for n, tmp, proc in procs:
            out = proc.communicate()[0].decode(errors="replace")
            if proc.returncode != 0:
                failed.append(f"--- {n}.cu (nvcc exit {proc.returncode})\n{out}")
            else:
                if out.strip():
                    print(f"[nvcc {n}.cu]\n{out}", flush=True)
                os.replace(tmp, paths[n])
    finally:
        for _n, tmp, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    if failed:
        raise KernelUnavailableError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build_all([name])[name]))
        return lib


class Kernel:
    """One hand-written kernel's C entry point and its launch count.

    ``launches`` counts successful launches and nothing else, so a run
    can show that a path really went through the kernel."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._error_string = None
        self._count_lock = threading.Lock()

    def load(self):
        """The bound C entry point; builds the library on first use and
        raises KernelUnavailableError when it cannot."""
        if self._fn is None:
            lib = load_library(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            lib.ktpu_error_string.argtypes = [ctypes.c_int]
            lib.ktpu_error_string.restype = ctypes.c_char_p
            self._error_string = lib.ktpu_error_string
            self._fn = fn
        return self._fn

    def launch(self, device: torch.device, *args):
        """Launch on the current stream (appended as the last argument) of
        ``device``, which must be the current device: a kernel launches
        there.  Raise KernelLaunchError on a CUDA error."""
        fn = self.load()
        if device.index is not None and device.index != torch.cuda.current_device():
            raise ValueError(f"{self.symbol}: tensors on {device}, but the current "
                             f"device is cuda:{torch.cuda.current_device()}")
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise KernelLaunchError(
                f"{self.symbol}: CUDA error {err} "
                f"({self._error_string(err).decode()})")
        with self._count_lock:
            self.launches += 1


def check_cuda_tensors(op: str, *tensors: torch.Tensor):
    """Raise unless every tensor lies on one CUDA device, is bf16 (the
    kernels' one type), is contiguous and starts 16-byte aligned (the
    kernels load 16 bytes at a time)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{op}: tensors must share one CUDA device, "
                             f"got {t.device} and {dev}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{op}: kernel takes torch.bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: kernel takes contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError(f"{op}: kernel takes 16-byte aligned tensors")
