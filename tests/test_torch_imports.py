"""Hygiene of the PyTorch port: what it imports, and how its kernels fail.

The port (``kubernetes1_tpu_torch/``), ``chip_smoke.py`` and
``rl_churn_probe.py`` import nothing of JAX and nothing of the JAX
package, relative imports that climb out of the package included, and the port's C++ sources include no
file outside ``kubernetes1_tpu_torch/native/``.  Each kernel wrapper, handed a CUDA
tensor while its library cannot be built, raises instead of running its
plain version; the loader builds one library per source with nvcc for
sm_90a and counts only launches that succeeded.
"""

import ast
import os
import re
import stat
import sys
import types
from pathlib import Path

import pytest
import torch

from kubernetes1_tpu_torch.kernels import (attention, batchnorm, build, cross_entropy, gelu,
                                           layernorm, optim, ringattention, rmsnorm, rope,
                                           swiglu)
from kubernetes1_tpu_torch.workloads import sharding

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "kubernetes1_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "optax", "flax", "kubernetes1_tpu"}
PORT_FILES = sorted(p for p in PKG.rglob("*.py") if "_build" not in p.parts) + [
    REPO / "chip_smoke.py", REPO / "rl_churn_probe.py", REPO / "phase_clock.py"]
NATIVE = PKG / "native"
NATIVE_SOURCES = sorted(p for ext in ("*.cc", "*.hpp") for p in NATIVE.glob(ext))
INCLUDE = re.compile(r'^\s*#\s*include\s*([<"])([^>"]+)[>"]', re.M)


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


def native_includes(path: Path):
    """(quoted, name) of every #include in a C++ source."""
    return [(m.group(1) == '"', m.group(2)) for m in INCLUDE.finditer(path.read_text())]


@pytest.mark.parametrize("path", NATIVE_SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_native_sources_include_nothing_outside_the_ports_native_dir(path):
    """A quoted include names a file beside the source; a system include
    names no project header (the Makefile adds no include path)."""
    for quoted, name in native_includes(path):
        if quoted:
            target = (path.parent / name).resolve()
            assert target.parent == NATIVE.resolve() and target.is_file(), (path.name, name)
        else:
            assert not re.search(r"ktpu|kubernetes1_tpu|\.\.|\.hpp$", name), (path.name, name)


def test_native_include_check_sees_an_escape(tmp_path):
    src = tmp_path / "x.cc"
    src.write_text('#include <stdio.h>\n  # include "../../kubernetes1_tpu/native/json.hpp"\n')
    assert native_includes(src) == [(False, "stdio.h"),
                                    (True, "../../kubernetes1_tpu/native/json.hpp")]
    assert NATIVE_SOURCES and {p.name for p in NATIVE_SOURCES} >= {
        "gpu_plugin.cc", "metrics_exporter.cc", "json.hpp", "nvml.hpp"}


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
            "kubernetes1_tpu_torch.workloads.resnet_bench, "
            "kubernetes1_tpu_torch.workloads.resnet, kubernetes1_tpu_torch.workloads.bert, "
            "kubernetes1_tpu_torch.workloads.ringattention, kubernetes1_tpu_torch.kernels.build, "
            "kubernetes1_tpu_torch.workloads.llama_bench, kubernetes1_tpu_torch.optim, "
            "kubernetes1_tpu_torch.kernels.optim, kubernetes1_tpu_torch.entry, "
            "kubernetes1_tpu_torch.workloads.mnist, kubernetes1_tpu_torch.workloads.specs, "
            "kubernetes1_tpu_torch.deviceplugin.gpu_plugin, kubernetes1_tpu_torch.native, "
            "kubernetes1_tpu_torch.workloads.loadgen, kubernetes1_tpu_torch.utils.retry, "
            "kubernetes1_tpu_torch.client.rest, kubernetes1_tpu_torch.client.informer, "
            "kubernetes1_tpu_torch.workloads.rl_actor, kubernetes1_tpu_torch.workloads.servefleet, "
            "kubernetes1_tpu_torch.controllers, kubernetes1_tpu_torch.controllers.__main__, "
            "kubernetes1_tpu_torch.utils.workqueue; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r}); print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("module", [
    "kubernetes1_tpu_torch.utils.pki", "kubernetes1_tpu_torch.apiserver.auth",
    "kubernetes1_tpu_torch.controllers.certificates", "kubernetes1_tpu_torch.cli.bootstrap",
    "kubernetes1_tpu_torch.utils.procutil", "kubernetes1_tpu_torch.storage.store"])
def test_the_security_modules_pull_in_no_jax(module):
    """Each module of the secured cluster (PKI, authn and authz, the CSR
    signer, init/join, the client flags, the store's WAL), imported
    alone, loads nothing of JAX or the JAX package."""
    import subprocess

    code = (f"import sys, {module}; bad = sorted(m for m in sys.modules if m.split('.')[0] "
            f"in {sorted(FORBIDDEN)!r}); print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


# ------------------------------------------------------- wrappers raise


class _FakeCudaTensor:
    """Enough of a tensor to reach a wrapper's CUDA branch."""

    requires_grad = False

    def __init__(self, *shape, dtype=torch.bfloat16):
        self.shape = torch.Size(shape)
        self.device = torch.device("cuda", 0)
        self.dtype = dtype

    def to(self, dtype):
        return _FakeCudaTensor(*self.shape, dtype=dtype)

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 4096


def _plain_must_not_run(*_a, **_k):
    raise AssertionError("the plain version ran on a CUDA tensor")


KERNEL_MODULES = (attention, rmsnorm, rope, swiglu, cross_entropy, batchnorm, layernorm, gelu,
                  ringattention, optim)


@pytest.fixture
def no_kernel_libraries(monkeypatch, tmp_path):
    """No nvcc, an empty build directory, nothing loaded."""
    monkeypatch.setattr(build, "_find_nvcc", lambda: None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_libs", {})
    for mod in KERNEL_MODULES:
        for kern in vars(mod).values():
            if isinstance(kern, build.Kernel):
                monkeypatch.setattr(kern, "_fn", None)


@pytest.mark.parametrize("op", ["rmsnorm", "rope", "attention", "swiglu", "cross_entropy",
                                "batchnorm", "attention_noncausal", "layernorm", "gelu",
                                "cross_entropy_f32", "ring_block", "ring_block_nc", "ring_merge",
                                "ring_block_bwd", "adamw", "adafactor", "sgdm",
                                "cross_entropy_part", "cross_entropy_part_f32"])
def test_wrapper_raises_on_cuda_tensor_without_its_library(no_kernel_libraries,
                                                           monkeypatch, op):
    B, S, H, Hkv, hd = 2, 8, 4, 2, 16
    f32 = torch.float32
    for name in ("block_attn_plain", "merge_op_plain", "merge_plain", "block_bwd_op_plain",
                 "block_bwd_plain"):
        monkeypatch.setattr(ringattention, name, _plain_must_not_run)
    for name in ("adamw_plain", "adafactor_plain", "sgdm_plain"):
        monkeypatch.setattr(optim, name, _plain_must_not_run)
    # a leaf table on a card, as far as the wrappers look
    table = types.SimpleNamespace(device=torch.device("cuda", 0), grads=[object()])
    count = _FakeCudaTensor(dtype=torch.int32)
    if op == "adamw":
        call = lambda: optim.adamw(table, count, 1e-3)
        kernel = optim.KERNEL_ADAMW
    elif op == "adafactor":
        call = lambda: optim.adafactor(table, count, 1e-3)
        kernel = optim.KERNEL_ADAFACTOR
    elif op == "sgdm":
        call = lambda: optim.sgdm(table, 0.1)
        kernel = optim.KERNEL_SGDM
    elif op in ("ring_block", "ring_block_nc"):  # the diagonal, and a block behind
        call = lambda: ringattention.ring_block(*_fakes((B, S, H, hd), (B, S, Hkv, hd),
                                                        (B, S, Hkv, hd)),
                                                S, 0 if op == "ring_block_nc" else S, True)
        kernel = ringattention.RING_BLOCK_NC if op == "ring_block_nc" else ringattention.RING_BLOCK
    elif op == "ring_merge":
        call = lambda: ringattention.ring_merge(
            _FakeCudaTensor(B, S, H, hd, dtype=f32), _FakeCudaTensor(B, H, S, dtype=f32),
            _FakeCudaTensor(B, S, H, hd), _FakeCudaTensor(B, H, S, dtype=f32), True)
        kernel = ringattention.RING_MERGE
    elif op == "ring_block_bwd":
        call = lambda: ringattention.ring_block_bwd(
            *_fakes((B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd), (B, S, H, hd)),
            *_fakes((B, H, S), (B, H, S), dtype=f32), True,
            *_fakes((B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd), dtype=f32))
        kernel = ringattention.RING_BLOCK_BWD
    elif op == "attention_noncausal":
        monkeypatch.setattr(attention, "attention_plain", _plain_must_not_run)
        call = lambda: attention.attention(*_fakes(*[(B, S, H, hd)] * 3), causal=False)
        kernel = attention.KERNEL_NC
    elif op == "layernorm":
        monkeypatch.setattr(layernorm, "layernorm_plain", _plain_must_not_run)
        call = lambda: layernorm.layernorm(_FakeCudaTensor(B * S, 64),
                                           *_fakes((64,), (64,), dtype=torch.float32))
        kernel = layernorm.KERNEL
    elif op == "gelu":
        monkeypatch.setattr(gelu, "gelu_plain", _plain_must_not_run)
        call = lambda: gelu.gelu(_FakeCudaTensor(B * S, 64))
        kernel = gelu.KERNEL
    elif op == "cross_entropy_f32":
        monkeypatch.setattr(cross_entropy, "cross_entropy_plain", _plain_must_not_run)
        call = lambda: cross_entropy.cross_entropy(
            _FakeCudaTensor(B * S, 1001, dtype=torch.float32),
            _FakeCudaTensor(B * S, dtype=torch.int64))
        kernel = cross_entropy.KERNEL_F32
    elif op in ("cross_entropy_part", "cross_entropy_part_f32"):  # vocab-parallel
        monkeypatch.setattr(cross_entropy, "cross_entropy_part_plain", _plain_must_not_run)
        f32_logits = op.endswith("f32")
        call = lambda: cross_entropy.cross_entropy_vocab_parallel(
            _FakeCudaTensor(B * S, 1000, dtype=f32 if f32_logits else torch.bfloat16),
            _FakeCudaTensor(B * S, dtype=torch.int64), 1000, None)
        kernel = cross_entropy.KERNEL_PART_F32 if f32_logits else cross_entropy.KERNEL_PART
    elif op == "swiglu":
        monkeypatch.setattr(swiglu, "swiglu_plain", _plain_must_not_run)
        call = lambda: swiglu.swiglu(_FakeCudaTensor(B * S, 64), _FakeCudaTensor(B * S, 64))
        kernel = swiglu.KERNEL
    elif op == "cross_entropy":
        monkeypatch.setattr(cross_entropy, "cross_entropy_plain", _plain_must_not_run)
        call = lambda: cross_entropy.cross_entropy(
            _FakeCudaTensor(B * S, 1000), _FakeCudaTensor(B * S, dtype=torch.int64))
        kernel = cross_entropy.KERNEL
    elif op == "batchnorm":
        monkeypatch.setattr(batchnorm, "batchnorm_plain", _plain_must_not_run)
        monkeypatch.setattr(batchnorm, "bn_stats_plain", _plain_must_not_run)
        call = lambda: batchnorm.batchnorm(_FakeCudaTensor(B * S, 64),
                                           *_fakes((64,), (64,), dtype=torch.float32))
        kernel = batchnorm.KERNEL_STATS
    elif op == "rmsnorm":
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


def _fakes(*shapes, dtype=torch.bfloat16):
    return [_FakeCudaTensor(*s, dtype=dtype) for s in shapes]


@pytest.mark.parametrize("op", ["rmsnorm", "rope", "attention", "swiglu", "cross_entropy",
                                "batchnorm_apply", "batchnorm", "attention_noncausal",
                                "layernorm", "gelu", "cross_entropy_f32", "ring_block_bwd_nc"])
def test_backward_kernel_raises_on_cuda_tensor_without_its_library(no_kernel_libraries, op):
    """The backward entry points, which the autograd Functions call, raise
    like the forward ones and count nothing."""
    qs, ks, f32 = (2, 8, 4, 16), (2, 8, 2, 16), torch.float32
    call = {
        "rmsnorm": lambda: rmsnorm.rmsnorm_bwd_kernel(*_fakes((16, 64), (64,), (16, 64))),
        "rope": lambda: rope.rope_kernel(*_fakes(qs, ks), 5e5, inverse=True),
        "attention": lambda: attention.attention_bwd_kernel(
            *_fakes(qs, ks, ks, qs), *_fakes((2, 4, 8), dtype=f32), *_fakes(qs)),
        "swiglu": lambda: swiglu.swiglu_bwd_kernel(*_fakes((16, 64), (16, 64), (16, 64))),
        "cross_entropy": lambda: cross_entropy.cross_entropy_bwd_kernel(
            *_fakes((16, 1000)), *_fakes((16,), dtype=torch.int64),
            *_fakes((16,), (16,), dtype=f32)),
        "batchnorm_apply": lambda: batchnorm.bn_apply_kernel(*_fakes((16, 64), (64,), (64,))),
        "batchnorm": lambda: batchnorm.bn_bwd_kernel(
            _FakeCudaTensor(16, 64), _FakeCudaTensor(16, 8, dtype=torch.uint8),
            *_fakes((16, 64), (64,)), *_fakes((64,), (4, 64), dtype=f32)),
        "attention_noncausal": lambda: attention.attention_bwd_kernel(
            *_fakes(qs, qs, qs, qs), *_fakes((2, 4, 8), dtype=f32), *_fakes(qs), causal=False),
        "layernorm": lambda: layernorm.layernorm_bwd_kernel(
            _FakeCudaTensor(16, 64), _FakeCudaTensor(64, dtype=f32), _FakeCudaTensor(16, 64)),
        "gelu": lambda: gelu.gelu_bwd_kernel(*_fakes((16, 64), (16, 64))),
        "cross_entropy_f32": lambda: cross_entropy.cross_entropy_bwd_kernel(
            *_fakes((16, 1001), dtype=f32), *_fakes((16,), dtype=torch.int64),
            *_fakes((16,), (16,), dtype=f32)),
        "ring_block_bwd_nc": lambda: ringattention.ring_block_bwd_kernel(
            *_fakes(qs, ks, ks, qs), *_fakes((2, 4, 8), (2, 4, 8), dtype=f32), False,
            *_fakes(qs, ks, ks, dtype=f32), o=_FakeCudaTensor(*qs)),
    }[op]
    kernel = {"ring_block_bwd_nc": ringattention.RING_BLOCK_BWD_NC,
              "attention": attention.KERNEL_BWD, "rmsnorm": rmsnorm.KERNEL_BWD,
              "rope": rope.KERNEL_BWD, "swiglu": swiglu.KERNEL_BWD,
              "cross_entropy": cross_entropy.KERNEL_BWD, "batchnorm": batchnorm.KERNEL_BWD,
              "batchnorm_apply": batchnorm.KERNEL_APPLY,
              "attention_noncausal": attention.KERNEL_BWD_NC, "layernorm": layernorm.KERNEL_BWD,
              "gelu": gelu.KERNEL_BWD, "cross_entropy_f32": cross_entropy.KERNEL_BWD_F32}[op]
    before = kernel.launches
    with pytest.raises(build.KernelUnavailableError, match="nvcc not found"):
        call()
    assert kernel.launches == before


@pytest.mark.parametrize("op", ["rmsnorm", "rope", "attention", "swiglu", "cross_entropy",
                                "batchnorm", "attention_noncausal", "layernorm", "gelu",
                                "cross_entropy_f32", "ring_block", "ring_merge",
                                "ring_block_bwd", "adamw", "adafactor", "sgdm"])
def test_wrapper_takes_plain_version_only_on_cpu(op):
    x = torch.randn(2, 8, 4, 16)
    k = x[:, :, :2].contiguous()
    if op in ("adamw", "adafactor", "sgdm"):
        tables = []
        for _ in range(2):
            p = x.reshape(64, 16).clone()
            states = (torch.zeros(64, 16),) * (2 if op == "adamw" else 1)
            tables.append(optim.LeafTable([optim.Leaf(p, tuple(t.clone() for t in states))],
                                          adafactor=op == "adafactor"))
            tables[-1].set_grads([x.reshape(64, 16) - 1])
        counts = [torch.zeros((), dtype=torch.int32) for _ in range(2)]
        for f, table, count in zip((getattr(optim, op), getattr(optim, f"{op}_plain")), tables,
                                   counts):
            f(table, 0.1) if op == "sgdm" else f(table, count, 0.1)
        leaf0, leaf1 = (t.leaves[0] for t in tables)
        assert torch.equal(leaf0.p, leaf1.p) and not torch.equal(leaf0.p, x.reshape(64, 16))
        assert all(torch.equal(a, b) for a, b in zip(leaf0.states, leaf1.states))
        assert torch.equal(counts[0], counts[1])
        kernel = {"adamw": optim.KERNEL_ADAMW, "adafactor": optim.KERNEL_ADAFACTOR,
                  "sgdm": optim.KERNEL_SGDM}[op]
    elif op == "ring_block":
        got, want = (f(x, k, k - 1, 8, 0, True) for f in (ringattention.ring_block,
                                                          ringattention.block_attn_plain))
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        kernel = ringattention.RING_BLOCK_NC
    elif op == "ring_merge":
        lse = torch.randn(2, 4, 8)
        got, want = (f(x, lse, x - 1, lse + 1, True) for f in (ringattention.ring_merge,
                                                                ringattention.merge_op_plain))
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        kernel = ringattention.RING_MERGE
    elif op == "ring_block_bwd":
        o, lse = ringattention.block_attn_plain(x, k, k, 0, 0, True)
        bufs = [[torch.zeros(t.shape) for t in (x, k, k)] for _ in range(2)]
        deltas = [torch.empty(2, 4, 8) for _ in range(2)]
        for f, b, d in zip((ringattention.ring_block_bwd, ringattention.block_bwd_op_plain), bufs,
                           deltas):
            f(x, k, k, x + 1, lse, d, True, *b, o=o)
        assert torch.equal(deltas[0], deltas[1])
        assert all(torch.equal(g, w) for g, w in zip(*bufs)) and bufs[0][0].abs().sum() > 0
        kernel = ringattention.RING_BLOCK_BWD
    elif op == "attention_noncausal":
        assert torch.equal(attention.attention(x, x + 1, x - 1, causal=False),
                           attention.attention_plain(x, x + 1, x - 1, causal=False))
        kernel = attention.KERNEL_NC
    elif op == "layernorm":
        sc, bi = torch.linspace(0.5, 1.5, 16), torch.linspace(-1, 1, 16)
        xb = x.bfloat16()
        assert torch.equal(layernorm.layernorm(xb, sc, bi), layernorm.layernorm_plain(xb, sc, bi))
        kernel = layernorm.KERNEL
    elif op == "gelu":
        assert torch.equal(gelu.gelu(x.bfloat16()), gelu.gelu_plain(x.bfloat16()))
        kernel = gelu.KERNEL
    elif op == "cross_entropy_f32":
        logits, t = x.reshape(16, 64), torch.arange(16)
        assert torch.equal(cross_entropy.cross_entropy(logits, t),
                           cross_entropy.cross_entropy_plain(logits, t))
        kernel = cross_entropy.KERNEL_F32
    elif op == "batchnorm":
        x2, sc = x.reshape(64, 16), torch.linspace(0.5, 1.5, 16)
        assert torch.equal(batchnorm.batchnorm(x2, sc, -sc, x2, True),
                           batchnorm.batchnorm_plain(x2, sc, -sc, x2, True))
        kernel = batchnorm.KERNEL_STATS
    elif op == "swiglu":
        assert torch.equal(swiglu.swiglu(x, x + 1), swiglu.swiglu_plain(x, x + 1))
        kernel = swiglu.KERNEL
    elif op == "cross_entropy":
        logits, t = x.reshape(16, 64), torch.arange(16)
        assert torch.equal(cross_entropy.cross_entropy(logits, t),
                           cross_entropy.cross_entropy_plain(logits, t))
        kernel = cross_entropy.KERNEL
    elif op == "rmsnorm":
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
    sources = ["attention", "batchnorm", "cross_entropy", "gelu", "layernorm", "optim",
               "ring_merge", "rmsnorm", "rope", "swiglu"]
    assert sorted(paths) == sources
    calls = (tmp_path / "nvcc.log").read_text().splitlines()
    assert len(calls) == len(sources)
    for call in calls:
        assert "arch=compute_90a,code=sm_90a" in call and "-shared" in call
    assert all(p.exists() and p.parent == tmp_path / "build" for p in paths.values())
    assert build.build_all() == paths  # built once: no second nvcc
    assert len((tmp_path / "nvcc.log").read_text().splitlines()) == len(sources)


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
