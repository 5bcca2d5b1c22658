"""Single-card MNIST (BASELINE config 2: a pod asking for one
``nvidia.com/gpu``, the device plugin's allocation path), the port of the
JAX package's ``workloads/mnist.py``.

The data is synthetic, as the JAX workload's: 10 Gaussian clusters in
784-d that an MLP separates in a few steps.  The two products run on
cuBLAS (``torch.matmul``), as JAX leaves them to XLA; the loss is the
cross-entropy kernel over the f32 logits (K5-f32, ``kernels/cross_entropy``)
and the update the SGD-momentum kernel (K10c, ``optim.SGD``).  On the
card unless the caller passes ``device="cpu"``, which runs the kernels'
plain versions.

    python -m kubernetes1_tpu_torch.workloads.mnist [--device cpu]
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .. import optim
from ..kernels import cross_entropy as _cross_entropy
from .sharding import resolve_device

IN, CLASSES = 784, 10
LEAVES = ("w1", "b1", "w2", "b2")


def synthetic_mnist(n: int = 4096, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """The JAX workload's data, bit for bit: class centres from a fixed
    seed (task constants); ``seed`` varies only the samples."""
    centers = np.random.default_rng(42).normal(size=(10, 784)).astype(np.float32)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n)
    x = centers[labels] + 0.5 * rng.normal(size=(n, 784)).astype(np.float32)
    return x, labels.astype(np.int32)


def init_params(hidden: int, generator: torch.Generator,
                device: Optional[torch.device | str] = None) -> Dict[str, torch.Tensor]:
    """f32 weights with JAX's scales (normal / sqrt(fan-in)) and zero
    biases, drawn from ``generator`` (on ``device``, the card by default)."""
    dev = resolve_device(device)

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    return {"w1": normal(IN, hidden) / np.sqrt(IN),
            "b1": torch.zeros(hidden, device=dev),
            "w2": normal(hidden, CLASSES) / np.sqrt(hidden),
            "b2": torch.zeros(CLASSES, device=dev)}


def params_from_jax(tree: Dict[str, Any],
                    device: Optional[torch.device | str] = None) -> Dict[str, torch.Tensor]:
    """The JAX parameter dict (arrays or numpy) as f32 tensors on ``device``."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(tree[k], np.float32)).to(dev) for k in LEAVES}


def forward(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """relu(x W1 + b1) W2 + b2: the f32 logits (rows, 10)."""
    h = torch.relu(torch.matmul(x, params["w1"]) + params["b1"])
    return torch.matmul(h, params["w2"]) + params["b2"]


def loss_fn(params: Dict[str, torch.Tensor], x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy at the integer labels (optax's
    ``softmax_cross_entropy_with_integer_labels``), through K5-f32."""
    return _cross_entropy.cross_entropy(forward(params, x), y.long()).mean()


def make_train_step(params: Dict[str, torch.Tensor], lr: float = 0.1
                    ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """step(x, y) -> the loss before the update (0-dim, detached): one
    value-and-grad of ``loss_fn`` and one update of ``optax.sgd(lr,
    momentum=0.9)`` (K10c), in place.  The weights come to require grad."""
    leaves = [params[k].requires_grad_(True) for k in LEAVES]
    opt = optim.SGD(leaves, lr=lr, momentum=0.9)

    def step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, x, y)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def train(steps: int = 50, batch: int = 256, lr: float = 0.1, seed: int = 0,
          device: Optional[torch.device | str] = None) -> Tuple[float, float]:
    """JAX's ``train``: ``steps`` SGD steps on batches drawn with numpy's
    default_rng(seed); returns (the last step's loss, accuracy on 1024
    fresh samples)."""
    dev = resolve_device(device)
    x, y = synthetic_mnist(seed=seed)
    xd, yd = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    params = init_params(256, torch.Generator(device=dev).manual_seed(seed), dev)
    step = make_train_step(params, lr)
    rng = np.random.default_rng(seed)
    loss = None
    for _ in range(steps):
        idx = torch.from_numpy(rng.integers(0, len(x), batch)).to(dev)
        loss = step(xd[idx], yd[idx])
    xe, ye = (torch.from_numpy(a).to(dev) for a in synthetic_mnist(1024, seed=seed + 1))
    with torch.no_grad():
        acc = (forward(params, xe).argmax(-1) == ye).float().mean()
    return float(loss), float(acc)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="single-card MNIST")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on ('cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    loss, acc = train(device=args.device)
    dev = resolve_device(args.device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    print(f"mnist final loss={loss:.4f} acc={acc:.3f} on {where}", flush=True)


if __name__ == "__main__":
    main()
