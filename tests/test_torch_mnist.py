"""The port's MNIST against the JAX package's, on the CPU.

The synthetic data bit for bit; forward and loss on the same weights
(``params_from_jax``); a 5-step SGD-momentum trajectory against JAX's
step (``jax.value_and_grad(loss_fn)`` and ``optax.sgd(0.1, momentum=0.9)``,
the body of JAX's ``train``) in f32; ``train`` reaching JAX's accuracy;
the module's main.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubernetes1_tpu.workloads import mnist as jmnist
from kubernetes1_tpu_torch.kernels import cross_entropy, optim as optim_kernels
from kubernetes1_tpu_torch.workloads import mnist

# f32: the loss absolutely; the logits to this share of the largest one (two
# products of 784 and 256 terms, summed in another order than XLA's)
FORWARD_TOL = 1e-6
TRAJECTORY_TOL = 1e-5   # f32, 5 SGD-momentum steps


@pytest.mark.parametrize("n,seed", [(4096, 0), (1024, 1), (37, 5)])
def test_synthetic_mnist_is_jax_bit_for_bit(n, seed):
    x, y = mnist.synthetic_mnist(n, seed)
    jx, jy = jmnist.synthetic_mnist(n, seed)
    assert x.dtype == jx.dtype == np.float32 and y.dtype == jy.dtype == np.int32
    assert np.array_equal(x, jx) and np.array_equal(y, jy)


@pytest.mark.parametrize("hidden", [256, 64])
def test_forward_and_loss_match_jax(hidden):
    jp = jmnist.init_params(jax.random.key(3), hidden)
    tp = mnist.params_from_jax(jp, "cpu")
    x, y = jmnist.synthetic_mnist(256, seed=9)
    want = np.asarray(jmnist.forward(jp, jnp.asarray(x)))
    got = mnist.forward(tp, torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= FORWARD_TOL * np.abs(want).max()
    jl = float(jmnist.loss_fn(jp, jnp.asarray(x), jnp.asarray(y)))
    tl = float(mnist.loss_fn(tp, torch.from_numpy(x), torch.from_numpy(y)))
    assert abs(tl - jl) <= FORWARD_TOL


def test_five_step_sgd_trajectory_matches_jax():
    jp = jmnist.init_params(jax.random.key(0))
    tp = mnist.params_from_jax(jp, "cpu")
    tx = optax.sgd(0.1, momentum=0.9)
    state = tx.init(jp)
    step = mnist.make_train_step(tp, lr=0.1)
    x, y = jmnist.synthetic_mnist()
    rng = np.random.default_rng(0)
    for i in range(5):
        idx = rng.integers(0, len(x), 256)
        jl, grads = jax.value_and_grad(jmnist.loss_fn)(jp, jnp.asarray(x[idx]),
                                                       jnp.asarray(y[idx]))
        updates, state = tx.update(grads, state)
        jp = optax.apply_updates(jp, updates)
        tl = step(torch.from_numpy(x[idx]), torch.from_numpy(y[idx]))
        assert abs(float(tl) - float(jl)) <= TRAJECTORY_TOL, i
        for k in mnist.LEAVES:
            err = np.abs(tp[k].detach().numpy() - np.asarray(jp[k])).max()
            assert err <= TRAJECTORY_TOL, (i, k, err)
    assert float(jl) < 0.1  # the clusters are separated within 5 steps


def test_train_reaches_jax_accuracy():
    cross_entropy.KERNEL_F32.launches = optim_kernels.KERNEL_SGDM.launches = 0
    loss, acc = mnist.train(device="cpu")
    jloss, jacc = jmnist.train()
    assert isinstance(loss, float) and isinstance(acc, float)
    assert np.isfinite(loss) and loss < np.log(10)  # below a uniform guess's loss
    assert acc >= jacc and acc >= 0.9, (acc, jacc)
    # the plain versions ran: a CPU call is no launch
    assert cross_entropy.KERNEL_F32.launches == optim_kernels.KERNEL_SGDM.launches == 0


def test_init_params_scales_and_card_default(monkeypatch):
    p = mnist.init_params(256, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "w1": (784, 256), "b1": (256,), "w2": (256, 10), "b2": (10,)}
    assert abs(p["w1"].std().item() * np.sqrt(784) - 1) < 0.02
    assert abs(p["w2"].std().item() * np.sqrt(256) - 1) < 0.05
    assert not p["b1"].any() and not p["b2"].any()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mnist.train()


def test_main_runs_on_the_cpu_and_refuses_without_a_card():
    run = [sys.executable, "-m", "kubernetes1_tpu_torch.workloads.mnist"]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}  # one core: the suite runs beside it
    res = subprocess.run(run + ["--device", "cpu"], capture_output=True, text=True, timeout=300,
                         env=env)
    assert res.returncode == 0, res.stderr
    assert "acc=1.000 on cpu" in res.stdout
    res = subprocess.run(run, capture_output=True, text=True, timeout=300,
                         env={**env, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0 and "no CUDA device" in res.stderr
