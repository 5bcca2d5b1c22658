"""Parity of the PyTorch port's optimizer updates (K10 AdamW, K10b
Adafactor, K10c SGD with momentum) against optax, on the CPU.

The same parameters and gradients, drawn with numpy from a seed, go
through optax's transformation (``optax.apply_updates`` after
``tx.update``) and through the port's optimizer (``kubernetes1_tpu_torch.
optim``), whose CPU path is the kernels' plain version, for 3 steps.
Parameters and every state tensor agree to 1e-5 relative to the largest
magnitude of the reference (f32 arithmetic in another order).

Adafactor is held to ``optax.adafactor`` on the JAX leaf: a stacked group
of per-layer tensors is compared with optax run on the stacked array, so
its block RMS (one number over all layers) and its factored dims (from
``np.argsort`` of the stacked shape, a tie included) are optax's own.
"""

import numpy as np
import optax
import jax.numpy as jnp
import pytest
import torch

from kubernetes1_tpu_torch import optim as toptim
from kubernetes1_tpu_torch.kernels import optim as kopt

TOL = 1e-5


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(float(np.max(np.abs(want))), 1e-30))


def _tensors(arrays):
    return [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrays]


def _grads(seed, arrays, step):
    return [_np(1000 * seed + 10 * step + i, *a.shape) for i, a in enumerate(arrays)]


# ------------------------------------------------------------ AdamW, SGD

SHAPES = [(37,), (16, 24), (3, 5, 7), (130, 3)]


@pytest.mark.parametrize("wd", [0.1, 0.01])
def test_adamw_matches_optax_over_three_steps(wd):
    arrays = [_np(i, *s) for i, s in enumerate(SHAPES)]
    tx = optax.adamw(1e-2, weight_decay=wd)
    jp = [jnp.asarray(a) for a in arrays]
    state = tx.init(jp)
    params = _tensors(arrays)
    opt = toptim.AdamW(params, lr=1e-2, weight_decay=wd)
    for step in range(3):
        grads = _grads(1, arrays, step)
        updates, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
    adam = state[0]
    assert int(adam.count) == int(opt.count) == 3
    for p, w, m, v in zip(params, jp, adam.mu, adam.nu):
        assert _rel(p, w) <= TOL
        assert _rel(opt.state[p]["exp_avg"], m) <= TOL
        assert _rel(opt.state[p]["exp_avg_sq"], v) <= TOL


def test_sgd_momentum_matches_optax_over_three_steps():
    arrays = [_np(i, *s) for i, s in enumerate(SHAPES)]
    tx = optax.sgd(0.1, momentum=0.9)
    jp = [jnp.asarray(a) for a in arrays]
    state = tx.init(jp)
    params = _tensors(arrays)
    opt = toptim.SGD(params, lr=0.1, momentum=0.9)
    for step in range(3):
        grads = _grads(2, arrays, step)
        updates, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
    for p, w, t in zip(params, jp, state[0].trace):
        assert _rel(p, w) <= TOL
        assert _rel(opt.state[p]["momentum_buffer"], t) <= TOL


# ------------------------------------------------------------- Adafactor

# name -> (layers or None for an unstacked leaf, per-layer shape, factored)
ADAFACTOR_LEAVES = {
    "factored": (None, (130, 200), True),          # d0 = the columns
    "factored_rows": (None, (300, 140), True),     # d0 = the rows
    "unfactored": (None, (64, 300), False),        # second dim < 128
    "vector": (None, (200,), False),
    "stacked_tie": (3, (128, 128), True),          # (3, 128, 128): argsort breaks the tie
    "stacked_vector": (4, (40,), False),           # (4, 40): a stacked norm scale
    "odd_width": (2, (129, 131), True),            # rows not a multiple of 4 floats
}


def _adafactor_run(names, lr=1e-2, steps=3, scale=1.0):
    """3 steps of optax.adafactor on the stacked leaves and of the port's
    Adafactor on their per-layer tensors; returns both."""
    stacked = {n: _np(i, *(((ADAFACTOR_LEAVES[n][0],) if ADAFACTOR_LEAVES[n][0] else ())
                          + ADAFACTOR_LEAVES[n][1]), scale=scale)
               for i, n in enumerate(names)}
    tx = optax.adafactor(lr)
    jp = {n: jnp.asarray(a) for n, a in stacked.items()}
    state = tx.init(jp)
    groups = []
    for n, a in stacked.items():
        layers = ADAFACTOR_LEAVES[n][0]
        groups.append((n, _tensors(list(a) if layers else [a])))
    opt = toptim.Adafactor(groups, lr=lr)
    for step in range(steps):
        grads = {n: _np(3000 + 10 * step + i, *a.shape) for i, (n, a) in enumerate(stacked.items())}
        updates, state = tx.update({n: jnp.asarray(g) for n, g in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for n, tensors in groups:
            g = grads[n]
            for k, p in enumerate(tensors):
                p.grad = torch.from_numpy((g[k] if len(tensors) > 1 else g).copy())
        opt.step()
    return jp, state[0], groups, opt


def _stack(ts):
    return torch.stack([t.detach() for t in ts]) if len(ts) > 1 else ts[0].detach()


@pytest.mark.parametrize("name", sorted(ADAFACTOR_LEAVES))
def test_adafactor_matches_optax_on_each_kind_of_leaf(name):
    jp, fstate, groups, opt = _adafactor_run([name])
    ((_, tensors),) = groups
    assert _rel(_stack(tensors), jp[name]) <= TOL
    factored = ADAFACTOR_LEAVES[name][2]
    assert all(("v_row" in opt.state[p]) == factored for p in tensors)
    if factored:
        assert _rel(_stack([opt.state[p]["v_row"] for p in tensors]), fstate.v_row[name]) <= TOL
        assert _rel(_stack([opt.state[p]["v_col"] for p in tensors]), fstate.v_col[name]) <= TOL
    else:
        assert _rel(_stack([opt.state[p]["v"] for p in tensors]), fstate.v[name]) <= TOL
    assert int(fstate.count) == int(opt.count) == 3


def test_adafactor_matches_optax_over_every_leaf_at_once():
    """All kinds in one optimizer: each group keeps its own clip and
    parameter scale."""
    names = sorted(ADAFACTOR_LEAVES)
    jp, _fstate, groups, _opt = _adafactor_run(names, scale=0.05)
    for n, tensors in groups:
        assert _rel(_stack(tensors), jp[n]) <= TOL, n


def test_adafactor_block_rms_is_one_number_over_the_stacked_layers():
    """Layer 0's update scales with the parameter RMS of the whole JAX
    leaf: making layer 1 larger makes layer 0's step larger, as in optax
    on the stacked array."""
    g = _np(7, 128, 128)
    steps = []
    for s in (1.0, 100.0):
        tensors = [torch.ones(128, 128, requires_grad=True),
                   torch.full((128, 128), s, requires_grad=True)]
        opt = toptim.Adafactor([("layers.w", tensors)], lr=0.1)
        for t in tensors:
            t.grad = torch.from_numpy(g.copy())
        opt.step()
        steps.append((tensors[0].detach() - 1).abs().max().item())
    # rms of the stacked (2, 128, 128) leaf: 1, then sqrt((1 + 100^2) / 2)
    assert steps[1] / steps[0] == pytest.approx(np.sqrt((1 + 100.0 ** 2) / 2), rel=1e-4)


def test_adafactor_first_step_has_decay_zero():
    """At count 0 the decay 1 - 1^-0.8 is 0: v is g^2 + eps exactly."""
    p = torch.zeros(64, 3, requires_grad=True)
    g = torch.from_numpy(_np(8, 64, 3))
    opt = toptim.Adafactor([("w", [p])], lr=0.1)
    opt.state[p]["v"].fill_(123.0)  # whatever it held, decay 0 forgets it
    p.grad = g
    opt.step()
    assert torch.equal(opt.state[p]["v"], g * g + 1e-30)


def test_adafactor_factored_dims_follow_optax():
    assert kopt.factored_dims((22, 2048, 2048)) == (1, 2)
    assert kopt.factored_dims((22, 2048, 512)) == (2, 1)
    assert kopt.factored_dims((32000, 2048)) == (1, 0)
    assert kopt.factored_dims((22, 2048)) is None
    assert kopt.factored_dims((2048,)) is None
    for shape in ((22, 2048, 2048), (3, 128, 128), (130, 200), (64, 300), (7,)):
        want = optax._src.factorized._factored_dims(shape, True, kopt.MIN_DIM_SIZE_TO_FACTOR)
        assert kopt.factored_dims(shape) == want


def test_adafactor_refuses_to_factor_over_the_layer_axis():
    tensors = [torch.zeros(128, requires_grad=True) for _ in range(130)]  # (130, 128)
    with pytest.raises(ValueError, match="layer axis"):
        toptim.Adafactor([("layers.norm", tensors)], lr=0.1)


# ------------------------------------------------------------- the table


def test_table_records_lay_out_blocks_groups_and_tile_sums():
    def leaf(shape, group, mode=kopt.FLAT):
        p = torch.zeros(shape)
        states = (torch.zeros(shape[0]), torch.zeros(shape[1])) if mode else (torch.zeros(shape),)
        return kopt.Leaf(p, states, group, mode)

    leaves = [leaf((70000,), 0), leaf((40, 2000), 1, kopt.FACTORED_COLS),
              leaf((3000, 130), 1, kopt.FACTORED_ROWS), leaf((5,), 2)]
    rec, groups, nblocks, n_fblocks, part = kopt.table_records(leaves, 3)
    # 70000 = 3 chunks; (40, 2000): 2 bands x 2 column tiles; (3000, 130):
    # 94 bands x 1; 5: one chunk
    assert list(rec["block0"]) == [0, 3, 7, 101] and nblocks == 102
    assert list(rec["fblock0"]) == [0, 0, 2, 6] and n_fblocks == 6
    assert list(rec["part"]) == [0, 0, 2 * 2000 + 2 * 40, 4080 + 94 * 130 + 3000]
    assert part == 4080 + 94 * 130 + 3000
    assert list(rec["rows"]) == [0, 40, 3000, 0] and list(rec["mode"]) == [0, 1, 2, 0]
    assert groups.tolist() == [[0, 3, 70000], [3, 101, 80000 + 390000], [101, 102, 5]]
    assert rec["p"][1] == leaves[1].p.data_ptr() and rec["s1"][0] == 0


def test_step_refuses_a_missing_or_wrong_gradient():
    p = torch.zeros(8, requires_grad=True)
    opt = toptim.AdamW([p], lr=0.1)
    with pytest.raises(ValueError, match="no gradient"):
        opt.step()
    with pytest.raises(TypeError, match="f32"):  # torch refuses it as p.grad
        opt.table.set_grads([torch.zeros(8, dtype=torch.float64)])
    with pytest.raises(ValueError, match="shape|\\(4,\\)"):
        opt.table.set_grads([torch.zeros(4)])
    p.grad = torch.zeros(16)[::2]
    with pytest.raises(ValueError, match="contiguous"):
        opt.step()
    with pytest.raises(ValueError, match="contiguous f32"):
        toptim.SGD([torch.zeros(8, dtype=torch.bfloat16)], lr=0.1)


def test_zero_grad_to_none_and_step_again():
    """zero_grad(set_to_none=True) drops the gradients; the next step's
    new gradients are read."""
    p = torch.ones(4, requires_grad=True)
    opt = toptim.SGD([p], lr=0.5, momentum=0.9)
    for _ in range(2):
        opt.zero_grad(set_to_none=True)
        assert p.grad is None
        (p * torch.arange(4.0)).sum().backward()
        opt.step()
    # t1 = g, t2 = g + 0.9 g: p = 1 - 0.5 (g + 1.9 g)
    assert torch.allclose(p.detach(), 1 - 0.5 * 2.9 * torch.arange(4.0))
