"""The guard around K10b's carried sum of p² and the optimizers' table
addresses, on the CPU.

On the card, Adafactor's last pass adds each block's sum of the new p²,
so the next update need not read p (``csrc/optim.cu``).  The leaf table
says when it must read p all the same: at the first update and after
any torch in-place write to a parameter, seen through the version
counters, which every table kernel's update moves too.  The table also keeps the addresses the kernels were given; a
parameter whose storage moved, or a state tensor that ``opt.state`` no
longer holds, makes ``step()`` raise with the leaf's name, for every
table optimizer.  The CPU path is the plain version, which reads p every
time; the last test holds it to ``optax.adafactor`` across an edit of p
between steps, at ``tests/test_torch_optim.py``'s tolerance.
"""

import copy

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubernetes1_tpu_torch import optim as toptim

TOL = 1e-5  # tests/test_torch_optim.py's: max abs error over the reference's max magnitude


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _adafactor(shapes=((130, 200), (40,))):
    groups = [(f"w{i}", [torch.from_numpy(_np(i, *s)).requires_grad_(True)])
              for i, s in enumerate(shapes)]
    return toptim.Adafactor(groups, lr=1e-2), [ts[0] for _n, ts in groups]


def _step(opt, params, seed):
    for i, p in enumerate(params):
        p.grad = torch.from_numpy(_np(seed + i, *p.shape))
    opt.step()


def test_table_must_read_params_at_its_first_update():
    opt, _params = _adafactor()
    assert opt.table.must_read_params()


def test_table_need_not_read_params_after_an_update_marks_them():
    opt, params = _adafactor()
    _step(opt, params, 10)  # the plain update writes p with copy_ ...
    assert opt.table.must_read_params()
    opt.table.mark_params()  # ... as the kernel path marks after its launch
    assert not opt.table.must_read_params()


EDITS = {
    "mul_": lambda p: p.mul_(0.5),
    "copy_": lambda p: p.copy_(torch.zeros_like(p)),
    "view": lambda p: p.view(-1)[:3].fill_(1.0),
    "row": lambda p: p[0].add_(1.0),
}


@pytest.mark.parametrize("edit", sorted(EDITS))
def test_table_must_read_params_again_after_an_in_place_write(edit):
    opt, params = _adafactor()
    opt.table.mark_params()
    with torch.no_grad():
        EDITS[edit](params[0])
    assert opt.table.must_read_params()
    opt.table.mark_params()
    assert not opt.table.must_read_params()


def test_forget_params_makes_the_next_update_read_them():
    opt, _params = _adafactor()
    opt.table.mark_params()
    opt.table.forget_params()
    assert opt.table.must_read_params()


def test_marking_moves_every_parameters_version_counter():
    """A kernel update writes through raw pointers; marking moves the
    counters as a torch in-place write would."""
    opt, params = _adafactor()
    before = [p._version for p in params]
    opt.table.mark_params()
    assert all(p._version > v for p, v in zip(params, before))


def test_a_second_table_sees_the_first_tables_kernel_write():
    """Two table optimizers over the same parameters: an update marked by
    one makes the other read p again."""
    first, params = _adafactor()
    second = toptim.Adafactor([(f"w{i}", [p]) for i, p in enumerate(params)], lr=1e-2)
    second.table.mark_params()
    assert not second.table.must_read_params()
    first.table.mark_params()  # as the kernel path marks after its launch
    assert second.table.must_read_params()


def test_autograd_sees_a_marked_update_of_a_saved_parameter():
    """A parameter saved for backward and then updated by a table kernel
    (marked) makes backward raise, as a torch in-place update would."""
    opt, params = _adafactor(((40,),))
    loss = (params[0] * params[0]).sum()
    opt.table.mark_params()
    with pytest.raises(RuntimeError, match="modified by an inplace operation"):
        loss.backward()


def _make(kind):
    params = [torch.from_numpy(_np(20 + i, *s)).requires_grad_(True)
              for i, s in enumerate(((8,), (16, 4)))]
    names = ("parameter 0", "parameter 1")
    if kind == "adamw":
        return toptim.AdamW(params, lr=0.1), params, names
    if kind == "sgd":
        return toptim.SGD(params, lr=0.1, momentum=0.9), params, names
    opt = toptim.Adafactor([("a", params[:1]), ("b", params[1:])], lr=0.1)
    return opt, params, ("a\\[0\\]", "b\\[0\\]")


@pytest.mark.parametrize("kind", ["adamw", "adafactor", "sgd"])
def test_step_raises_naming_the_leaf_after_its_storage_moved(kind):
    opt, params, names = _make(kind)
    _step(opt, params, 30)
    params[1].data = torch.zeros_like(params[1])
    with pytest.raises(ValueError, match=f"leaf 1 \\({names[1]}\\) moved"):
        _step(opt, params, 40)


@pytest.mark.parametrize("kind", ["adamw", "adafactor", "sgd"])
def test_step_raises_naming_the_leaf_after_load_state_dict_of_copies(kind):
    opt, params, names = _make(kind)
    _step(opt, params, 50)
    opt.load_state_dict(opt.state_dict())  # the same tensors: the table still holds them
    _step(opt, params, 60)
    opt.load_state_dict(copy.deepcopy(opt.state_dict()))
    with pytest.raises(ValueError, match=f"state of leaf 0 \\({names[0]}\\)"):
        _step(opt, params, 70)


def test_adafactor_matches_optax_across_an_edit_of_p_between_steps():
    """5 steps, p.mul_(0.5) between steps 2 and 3, on factored, unfactored
    and stacked leaves: the update after the edit uses the edited p's
    RMS, as optax given the same edit does."""
    stacked = {"factored": _np(1, 130, 200), "vector": _np(2, 200),
               "stacked": _np(3, 3, 128, 128), "unfactored": _np(4, 64, 300)}
    tx = optax.adafactor(1e-2)
    jp = {n: jnp.asarray(a) for n, a in stacked.items()}
    state = tx.init(jp)
    groups = [(n, [torch.from_numpy(x.copy()).requires_grad_(True)
                   for x in (a if n == "stacked" else [a])]) for n, a in stacked.items()]
    opt = toptim.Adafactor(groups, lr=1e-2)
    for step in range(5):
        if step == 2:
            jp = {n: a * 0.5 for n, a in jp.items()}
            with torch.no_grad():
                for _n, ts in groups:
                    for p in ts:
                        p.mul_(0.5)
        grads = {n: _np(100 + 10 * step + i, *a.shape) for i, (n, a) in enumerate(stacked.items())}
        updates, state = tx.update({n: jnp.asarray(g) for n, g in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for n, ts in groups:
            for k, p in enumerate(ts):
                p.grad = torch.from_numpy((grads[n][k] if len(ts) > 1 else grads[n]).copy())
        opt.step()
    for n, ts in groups:
        got = torch.stack([t.detach() for t in ts]).numpy() if len(ts) > 1 else ts[0].detach().numpy()
        want = np.asarray(jp[n])
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) <= TOL, n
    assert int(opt.count) == int(state[0].count) == 5


def test_the_plain_update_reads_p_whatever_the_table_says():
    """The CPU path has no carry: marking the parameters current and
    editing p through .data (which the counters cannot see) still gives
    optax's update of the edited p."""
    opt, params = _adafactor(((40,),))
    tx = optax.adafactor(1e-2)
    jp = {"w0": jnp.asarray(params[0].detach().numpy().copy())}
    state = tx.init(jp)
    for step in range(3):
        if step == 1:
            opt.table.mark_params()
            params[0].data.mul_(2.0)
            jp = {"w0": jp["w0"] * 2.0}
        g = _np(200 + step, 40)
        updates, state = tx.update({"w0": jnp.asarray(g)}, state, jp)
        jp = optax.apply_updates(jp, updates)
        params[0].grad = torch.from_numpy(g)
        opt.step()
    want = np.asarray(jp["w0"])
    assert np.max(np.abs(params[0].detach().numpy() - want)) / np.max(np.abs(want)) <= TOL
