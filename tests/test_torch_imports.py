"""Hygiene of the PyTorch port: what it imports, and how its kernels fail.

The port (``kubernetes1_tpu_torch/``) and ``chip_smoke.py`` import
nothing of JAX and nothing of the JAX package, relative imports that
climb out of the package included.  Each kernel wrapper, handed a CUDA
tensor while its library cannot be built, raises instead of running its
plain version; the loader builds one library per source with nvcc for
sm_90a and counts only launches that succeeded.
"""

import ast
import os
import stat
import sys
import types
from pathlib import Path

import pytest
import torch

from kubernetes1_tpu_torch.kernels import attention, build, rmsnorm, rope
from kubernetes1_tpu_torch.workloads import sharding

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "kubernetes1_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "optax", "flax", "kubernetes1_tpu"}
PORT_FILES = sorted(p for p in PKG.rglob("*.py") if "_build" not in p.parts) + [
    REPO / "chip_smoke.py"]


def _imported_modules(path: Path):
    """(line, absolute module name) of every import in `path`; a relative
    import resolves against the file's package, and one that climbs past
    the top of the package resolves to '..' (always forbidden)."""
    rel = path.relative_to(REPO).with_suffix("")
    package = list(rel.parts[:-1])
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                yield node.lineno, node.module or ""
                continue
            if node.level - 1 >= len(package):
                yield node.lineno, ".."
                continue
            base = package[:len(package) - (node.level - 1)]
            yield node.lineno, ".".join(base + ([node.module] if node.module else []))
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", "")) in
              ("import_module", "__import__")):
            yield node.lineno, node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_nothing_of_the_jax_package(path):
    bad = [(line, mod) for line, mod in _imported_modules(path)
           if mod == ".." or mod.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_import_walker_catches_relative_escape(tmp_path, monkeypatch):
    """The walker itself: `from ...x import y` at depth 2 climbs out."""
    pkg = tmp_path / "kubernetes1_tpu_torch" / "workloads"
    pkg.mkdir(parents=True)
    f = pkg / "m.py"
    f.write_text("from ..kernels import rope\nfrom ...kubernetes1_tpu import api\n"
                 "import jax.numpy as jnp\nimportlib.import_module('optax')\n")
    monkeypatch.setattr(sys.modules[__name__], "REPO", tmp_path)
    mods = [m for _line, m in _imported_modules(f)]
    assert mods == ["kubernetes1_tpu_torch.kernels", "..", "jax.numpy", "optax"]


def test_importing_the_port_pulls_in_no_jax():
    import subprocess

    code = ("import sys, kubernetes1_tpu_torch.workloads.llama, "
            "kubernetes1_tpu_torch.kernels.build; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r}); print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


# ------------------------------------------------------- wrappers raise


class _FakeCudaTensor:
    """Enough of a tensor to reach a wrapper's CUDA branch."""

    def __init__(self, *shape):
        self.shape = torch.Size(shape)
        self.device = torch.device("cuda", 0)
        self.dtype = torch.bfloat16

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 4096


def _plain_must_not_run(*_a, **_k):
    raise AssertionError("the plain version ran on a CUDA tensor")


@pytest.fixture
def no_kernel_libraries(monkeypatch, tmp_path):
    """No nvcc, an empty build directory, nothing loaded."""
    monkeypatch.setattr(build, "_find_nvcc", lambda: None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_libs", {})
    for mod in (attention, rmsnorm, rope):
        monkeypatch.setattr(mod.KERNEL, "_fn", None)


@pytest.mark.parametrize("op", ["rmsnorm", "rope", "attention"])
def test_wrapper_raises_on_cuda_tensor_without_its_library(no_kernel_libraries,
                                                           monkeypatch, op):
    B, S, H, Hkv, hd = 2, 8, 4, 2, 16
    if op == "rmsnorm":
        monkeypatch.setattr(rmsnorm, "rmsnorm_plain", _plain_must_not_run)
        call = lambda: rmsnorm.rmsnorm(_FakeCudaTensor(B * S, 64), _FakeCudaTensor(64))
        kernel = rmsnorm.KERNEL
    elif op == "rope":
        monkeypatch.setattr(rope, "rope_plain", _plain_must_not_run)
        call = lambda: rope.rope(_FakeCudaTensor(B, S, H, hd),
                                 _FakeCudaTensor(B, S, Hkv, hd), 5e5)
        kernel = rope.KERNEL
    else:
        monkeypatch.setattr(attention, "attention_plain", _plain_must_not_run)
        call = lambda: attention.attention(_FakeCudaTensor(B, S, H, hd),
                                           _FakeCudaTensor(B, S, Hkv, hd),
                                           _FakeCudaTensor(B, S, Hkv, hd))
        kernel = attention.KERNEL
    before = kernel.launches
    with pytest.raises(build.KernelUnavailableError, match="nvcc not found"):
        call()
    assert kernel.launches == before


@pytest.mark.parametrize("op", ["rmsnorm", "rope", "attention"])
def test_wrapper_takes_plain_version_only_on_cpu(op):
    x = torch.randn(2, 8, 4, 16)
    if op == "rmsnorm":
        assert torch.equal(rmsnorm.rmsnorm(x, torch.ones(16)),
                           rmsnorm.rmsnorm_plain(x, torch.ones(16)))
        kernel = rmsnorm.KERNEL
    elif op == "rope":
        got, want = rope.rope(x, x[:, :, :2], 5e5), rope.rope_plain(x, x[:, :, :2], 5e5)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        kernel = rope.KERNEL
    else:
        k = x[:, :, :2].contiguous()
        assert torch.equal(attention.attention(x, k, k), attention.attention_plain(x, k, k))
        kernel = attention.KERNEL
    assert kernel.launches == 0  # a CPU call is no launch


def test_check_cuda_tensors_refuses_what_the_kernels_do_not_take():
    t = _FakeCudaTensor(4, 8)
    build.check_cuda_tensors("op", t, t)
    cpu = torch.zeros(4, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA device"):
        build.check_cuda_tensors("op", t, cpu)
    f32 = _FakeCudaTensor(4, 8)
    f32.dtype = torch.float32
    with pytest.raises(TypeError):
        build.check_cuda_tensors("op", f32)
    odd = _FakeCudaTensor(4, 8)
    odd.data_ptr = lambda: 4098
    with pytest.raises(ValueError, match="aligned"):
        build.check_cuda_tensors("op", odd)
    strided = _FakeCudaTensor(4, 8)
    strided.is_contiguous = lambda: False
    with pytest.raises(ValueError, match="contiguous"):
        build.check_cuda_tensors("op", strided)


def test_launch_counts_only_successful_launches(monkeypatch):
    kern = build.Kernel("fake", "ktpu_fake", [])
    rc = [0]
    kern._fn = lambda *args: rc[0]
    kern._error_string = lambda err: b"an illegal memory access was encountered"
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    kern.launch(torch.device("cuda", 0), 1, 2)
    assert kern.launches == 1
    rc[0] = 700
    with pytest.raises(build.KernelLaunchError, match="illegal memory access"):
        kern.launch(torch.device("cuda", 0), 1, 2)
    with pytest.raises(ValueError, match="current device"):
        kern.launch(torch.device("cuda", 1), 1, 2)
    assert kern.launches == 1


# ---------------------------------------------------------------- build


def _fake_nvcc(tmp_path: Path, fail: bool = False) -> str:
    """A stand-in nvcc that logs its arguments and writes the -o file."""
    log = tmp_path / "nvcc.log"
    script = tmp_path / "nvcc"
    body = ("echo 'error: deliberately broken'; exit 2" if fail else
            'out=""; prev=""; for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; '
            'done; printf "" > "$out"')
    script.write_text(f'#!/bin/sh\necho "$@" >> {log}\n{body}\n')
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script)


def test_build_all_runs_one_nvcc_per_source_for_sm90a(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "_find_nvcc", lambda: _fake_nvcc(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    paths = build.build_all()
    assert sorted(paths) == ["attention", "rmsnorm", "rope"]
    calls = (tmp_path / "nvcc.log").read_text().splitlines()
    assert len(calls) == 3
    for call in calls:
        assert "arch=compute_90a,code=sm_90a" in call and "-shared" in call
    assert all(p.exists() and p.parent == tmp_path / "build" for p in paths.values())
    assert build.build_all() == paths  # built once: no second nvcc
    assert len((tmp_path / "nvcc.log").read_text().splitlines()) == 3


def test_build_failure_reports_the_compiler_output(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "_find_nvcc", lambda: _fake_nvcc(tmp_path, fail=True))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(build.KernelUnavailableError, match="deliberately broken"):
        build.build_all(["rope"])
    assert not list((tmp_path / "build").glob("*"))  # no partial library left


# --------------------------------------------------------------- device


def test_resolve_device_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharding.resolve_device(dev)
    assert sharding.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert sharding.resolve_device() == torch.device("cuda")


def test_chip_smoke_refuses_to_run_without_a_card():
    import subprocess

    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
