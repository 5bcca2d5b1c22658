"""ResNet-50 and its train step, in PyTorch.

The port of the JAX package's ``workloads/resnet.py``: the model
(``forward`` over a plain parameter dict), the loss and the SGD train step
(``make_train_state``, ``make_train_step``, ``train_demo``,
``bench_imgs_per_sec``), on one card or data parallel over a
``DeviceMesh`` (``mesh=``, one process per card: each rank takes its rows
of the global batch, every batch norm takes its statistics over the
global batch through the split K8 and an all-reduce, as JAX's ``_bn``
does under its batch split, and the gradients are averaged).  Batch norm
with its ReLU and residual add runs as hand-written CUDA kernels on the
card, forward and backward (``kernels/batchnorm.py``, K8), and so do the
cross-entropy over the f32 logits (``kernels/cross_entropy.py``, K5) and
the SGD-momentum update (``kubernetes1_tpu_torch.optim``, K10c); the
convolutions stay ``F.conv2d`` (cuDNN) and the pooling ``F.max_pool2d``,
as the JAX package left them to XLA.

Layout: the public functions keep JAX's NHWC images (B, H, W, 3).  Inside,
activations are logical NCHW tensors in ``torch.channels_last`` memory,
which is NHWC in memory: cuDNN runs NHWC convolutions without transposes,
and ``x.permute(0, 2, 3, 1)`` is a contiguous (N, H, W, C) view that the
batch-norm kernels take as (N·H·W, C).  Conv weights are OIHW (JAX: HWIO;
``params_from_jax`` permutes them), f32 master weights cast to
``cfg.dtype`` at each use.  JAX's ``"SAME"`` padding, which is asymmetric
at stride 2, is done explicitly.

ResNet-50 = ResNetConfig(): stages ((3, 64), (4, 128), (6, 256), (3, 512)),
1000 classes: 53 batch-norm layers.
"""

from __future__ import annotations

import dataclasses
import math
import time
from functools import partial
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import optim
from ..kernels import batchnorm as _batchnorm
from ..kernels import cross_entropy as _cross_entropy
from . import sharding
from .sharding import resolve_device

# (blocks per stage, bottleneck mid-channels) for ResNet-50
STAGES = [(3, 64), (4, 128), (6, 256), (3, 512)]
CONV_KEYS = ("conv", "conv1", "conv2", "conv3", "proj")


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    num_classes: int = 1000
    width: int = 1  # channel multiplier (tiny configs for tests)
    stages: Tuple[Tuple[int, int], ...] = tuple(STAGES)
    dtype: torch.dtype = torch.bfloat16


def tiny() -> ResNetConfig:
    return ResNetConfig(num_classes=10, width=1, stages=((1, 8), (1, 16)))


def _has_proj(si: int, bi: int, cin: int, cout: int) -> bool:
    return cin != cout or (bi == 0 and si > 0)


def num_bn_layers(cfg: ResNetConfig) -> int:
    """Batch-norm layers in the model: the stem's, three a block, and one
    per projection (53 for ResNet-50)."""
    n, cin = 1, 64 * cfg.width
    for si, (blocks, mid0) in enumerate(cfg.stages):
        cout = mid0 * cfg.width * 4
        for bi in range(blocks):
            n += 3 + _has_proj(si, bi, cin, cout)
            cin = cout
    return n


# ------------------------------------------------------------------- params

def init_params(cfg: ResNetConfig, generator: torch.Generator) -> Dict[str, Any]:
    """Random f32 weights on ``generator``'s device with the JAX package's
    distributions (He normal convs, normal / sqrt(fan_in) head, BN scale 1
    and bias 0).  The draws differ from ``jax.random``'s; carry JAX
    weights over with ``params_from_jax`` where the numbers must match."""
    dev = generator.device

    def conv(kh, kw, cin, cout):
        w = torch.randn((cout, cin, kh, kw), generator=generator, device=dev)
        return w.mul_(math.sqrt(2.0 / (kh * kw * cin)))

    def bn(c):
        return {"scale": torch.ones(c, device=dev), "bias": torch.zeros(c, device=dev)}

    stem_out = 64 * cfg.width
    params: Dict[str, Any] = {"stem": {"conv": conv(7, 7, 3, stem_out), "bn": bn(stem_out)},
                              "stages": []}
    cin = stem_out
    for si, (blocks, mid0) in enumerate(cfg.stages):
        mid = mid0 * cfg.width
        cout = mid * 4
        stage: List[Dict[str, Any]] = []
        for bi in range(blocks):
            blk = {"conv1": conv(1, 1, cin, mid), "bn1": bn(mid),
                   "conv2": conv(3, 3, mid, mid), "bn2": bn(mid),
                   "conv3": conv(1, 1, mid, cout), "bn3": bn(cout)}
            if _has_proj(si, bi, cin, cout):
                blk["proj"] = conv(1, 1, cin, cout)
                blk["proj_bn"] = bn(cout)
            stage.append(blk)
            cin = cout
        params["stages"].append(stage)
    head = torch.randn((cin, cfg.num_classes), generator=generator, device=dev)
    params["head"] = {"w": head.div_(math.sqrt(cin)),
                      "b": torch.zeros(cfg.num_classes, device=dev)}
    return params


def params_from_jax(tree: Dict[str, Any], cfg: ResNetConfig,
                    device: torch.device | str) -> Dict[str, Any]:
    """The JAX package's parameter pytree, given as numpy arrays
    (``jax.tree.map(np.asarray, params)``), as this module's f32 parameter
    dict on ``device``: conv weights go from HWIO to OIHW; the nested
    stage lists, the optional ``proj``/``proj_bn`` keys and the (d_in,
    d_out) head are kept."""
    def tensor(a, key) -> torch.Tensor:
        # a fresh copy: the port must not alias (or write into) JAX's buffers
        t = torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
        if key in CONV_KEYS:
            t = t.permute(3, 2, 0, 1).contiguous()
        return t.to(device)

    def convert(node, key=None):
        if isinstance(node, dict):
            return {k: convert(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v, key) for v in node]
        return tensor(node, key)

    params = convert(tree)
    if len(params["stages"]) != len(cfg.stages) or any(
            len(s) != blocks for s, (blocks, _mid) in zip(params["stages"], cfg.stages)):
        raise ValueError(f"stage layout {[len(s) for s in params['stages']]} != {cfg.stages}")
    return params


def param_leaves(tree: Dict[str, Any]) -> List[Any]:
    """Every leaf in a fixed order (dict keys sorted, lists in order).  It
    walks any pytree of this layout, so the JAX package's gradients
    (as numpy) come out in the same order as this module's parameters."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in param_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in param_leaves(v)]
    return [tree]


# ------------------------------------------------------------------ modules

class Ops(NamedTuple):
    """The kernel-backed ops of the model and its loss."""

    batchnorm: Callable
    cross_entropy: Callable


# The wrappers: the kernels on CUDA tensors (forward and backward), the
# plain versions on CPU ones.
KERNELS = Ops(_batchnorm.batchnorm, _cross_entropy.cross_entropy)
# The plain versions on every device: the reference a card run compares with.
PLAIN = Ops(_batchnorm.batchnorm_plain, _cross_entropy.cross_entropy_plain)


def same_padding(size: int, k: int, stride: int) -> Tuple[int, int]:
    """JAX's "SAME": (low, high) padding of one spatial dim, the extra one
    on the high side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """NCHW conv with OIHW ``w`` and JAX's "SAME" padding; input and weight
    cast to ``dtype``.  Where the padding is symmetric it goes to the conv
    itself, otherwise F.pad adds it first."""
    k = w.shape[2]
    (hl, hh), (wl, wh) = (same_padding(x.shape[d], k, stride) for d in (2, 3))
    x, w = x.to(dtype), w.to(dtype)
    if hl == hh and wl == wh:
        return F.conv2d(x, w, stride=stride, padding=(hl, wl))
    return F.conv2d(F.pad(x, (wl, wh, hl, hh)), w, stride=stride)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """reduce_window max 3x3 / 2 with JAX's "SAME" padding (-inf)."""
    (hl, hh), (wl, wh) = (same_padding(x.shape[d], 3, 2) for d in (2, 3))
    return F.max_pool2d(F.pad(x, (wl, wh, hl, hh), value=-math.inf), kernel_size=3, stride=2)


def _bn(x: torch.Tensor, bn: Dict[str, torch.Tensor], ops: Ops,
        residual: Optional[torch.Tensor] = None, relu: bool = False) -> torch.Tensor:
    """relu?(batchnorm(x) [+ residual]) of NCHW tensors, through the op on
    their (N·H·W, C) views (no copy for channels_last tensors)."""
    N, C, H, W = x.shape

    def rows(t):
        return t.permute(0, 2, 3, 1).reshape(N * H * W, C)

    y = ops.batchnorm(rows(x), bn["scale"], bn["bias"],
                      None if residual is None else rows(residual), relu)
    return y.reshape(N, H, W, C).permute(0, 3, 1, 2)


def forward(cfg: ResNetConfig, params: Dict[str, Any], images: torch.Tensor,
            ops: Ops = KERNELS) -> torch.Tensor:
    """images (B, H, W, 3) float -> logits (B, classes) float32."""
    dt = cfg.dtype
    x = images.permute(0, 3, 1, 2)  # NCHW view, channels_last in memory
    x = _bn(_conv(x, params["stem"]["conv"], 2, dt), params["stem"]["bn"], ops, relu=True)
    x = _max_pool(x)
    for si, stage in enumerate(params["stages"]):
        for bi, blk in enumerate(stage):
            stride = 2 if (bi == 0 and si > 0) else 1
            h = _bn(_conv(x, blk["conv1"], 1, dt), blk["bn1"], ops, relu=True)
            h = _bn(_conv(h, blk["conv2"], stride, dt), blk["bn2"], ops, relu=True)
            if "proj" in blk:
                x = _bn(_conv(x, blk["proj"], stride, dt), blk["proj_bn"], ops)
            # bn3, the residual add and the ReLU in one op: relu(x + bn3(h))
            x = _bn(_conv(h, blk["conv3"], 1, dt), blk["bn3"], ops, residual=x, relu=True)
    # jnp.mean of bf16 sums in f32 and returns bf16; bf16 @ f32 promotes to f32
    x = x.float().mean(dim=(2, 3)).to(dt)
    return x.float() @ params["head"]["w"] + params["head"]["b"]


def loss_fn(cfg: ResNetConfig, params: Dict[str, Any], images: torch.Tensor,
            labels: torch.Tensor, ops: Ops = KERNELS) -> torch.Tensor:
    """Mean softmax cross entropy of the f32 logits, a 0-dim f32 tensor:
    the cross-entropy op's per-row NLL (JAX's
    ``optax.softmax_cross_entropy_with_integer_labels``), then the mean."""
    return ops.cross_entropy(forward(cfg, params, images, ops), labels.long()).mean()


# --------------------------------------------------------------- train step

def make_train_state(cfg: ResNetConfig, device: Optional[torch.device | str] = None,
                     seed: int = 0, params: Optional[Dict[str, Any]] = None, mesh=None
                     ) -> Tuple[Dict[str, Any], torch.optim.Optimizer]:
    """f32 weights (random from ``seed``, or ``params``, e.g. from
    ``params_from_jax``) that require grad, and the port's SGD with
    momentum 0.9 (K10c) over all of them: optax's ``sgd(0.1,
    momentum=0.9)``.  ``device`` defaults to the card and raises without
    one.  With ``mesh``, every data rank's weights become rank 0's before
    the optimizer is built over them."""
    dev = resolve_device(device)
    if params is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    leaves = param_leaves(params)
    if mesh is not None:
        sharding.broadcast_params(leaves, mesh)
    for p in leaves:
        p.requires_grad_(True)
    return params, optim.SGD(leaves, lr=0.1, momentum=0.9)


def ops_over(ops: Ops, mesh) -> Ops:
    """``ops`` with batch norm's statistics over the mesh's data ranks:
    ``ops`` itself over one, whose statistics are its own (the split
    kernels would give the same bits, with four launches a layer in
    place of three and two collectives)."""
    if sharding.data_ranks(mesh) == 1:
        return ops
    return ops._replace(batchnorm=partial(ops.batchnorm, group=sharding.data_group(mesh)))


def make_train_step(cfg: ResNetConfig, params: Dict[str, Any], opt: torch.optim.Optimizer,
                    ops: Ops = KERNELS, mesh=None
                    ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """step(images, labels) -> the loss before the update (0-dim,
    detached): one value-and-grad of ``loss_fn`` and one SGD update, in
    place.

    With ``mesh``, ``images`` and ``labels`` are the global batch: each
    data rank takes its rows, batch norm takes its statistics over every
    rank's rows (``ops_over``), and the gradients and the loss (the mean
    over the rank's rows) are averaged over the data ranks; over one data
    rank, that is the step without a mesh."""
    leaves = param_leaves(params)
    if mesh is not None:
        ops = ops_over(ops, mesh)

    def step(images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        if mesh is not None:
            images, labels = (sharding.shard_batch(t, mesh) for t in (images, labels))
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(cfg, params, images, labels, ops)
        loss.backward()
        if mesh is not None:
            sharding.all_reduce_grads(leaves, mesh, "avg")
            loss = sharding.all_reduce_value(loss, mesh, "avg")
        opt.step()
        return loss.detach()

    return step


def synthetic_batch(cfg: ResNetConfig, batch: int, size: int, dtype: torch.dtype,
                    device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX workload's fixed batch: normal images (B, size, size, 3) and
    integer labels from numpy's default_rng(0)."""
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.normal(size=(batch, size, size, 3))).to(device, dtype)
    labels = torch.from_numpy(rng.integers(0, cfg.num_classes, batch)).to(device)
    return images, labels


def train_demo(cfg: Optional[ResNetConfig] = None, steps: int = 3, batch: int = 8,
               size: int = 32, device: Optional[torch.device | str] = None,
               mesh=None) -> float:
    """A few SGD steps on one fixed batch of f32 synthetic images (the step
    memorizes it; the stem conv casts them); returns the final loss.  On
    the card unless ``device="cpu"``; raises when no card is visible.
    ``batch`` is the global batch: without ``mesh``, a launcher's
    environment gives ``auto_mesh()`` (one process per card), else one
    device."""
    cfg = cfg or tiny()
    mesh = mesh if mesh is not None else sharding.launched_mesh(resolve_device(device))
    params, opt = make_train_state(cfg, device, mesh=mesh)
    step = make_train_step(cfg, params, opt, mesh=mesh)
    images, labels = synthetic_batch(cfg, batch, size, torch.float32,
                                     params["head"]["w"].device)
    loss = None
    for _ in range(steps):
        loss = step(images, labels)
    return float(loss)


def bench_imgs_per_sec(batch: int = 64, size: int = 224, steps: int = 10,
                       device: Optional[torch.device | str] = None, mesh=None) -> float:
    """imgs/sec of ResNet-50 training (the north-star metric) over the
    global ``batch``, on one device or over ``mesh`` (by default
    ``launched_mesh``), fenced by reading the loss back."""
    cfg = ResNetConfig()
    mesh = mesh if mesh is not None else sharding.launched_mesh(resolve_device(device))
    params, opt = make_train_state(cfg, device, mesh=mesh)
    step = make_train_step(cfg, params, opt, mesh=mesh)
    images, labels = synthetic_batch(cfg, batch, size, torch.float32,
                                     params["head"]["w"].device)
    float(step(images, labels))  # warm-up
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step(images, labels)
    float(loss)
    return batch * steps / (time.perf_counter() - t0)


if __name__ == "__main__":
    print("final loss:", train_demo())
