"""Ring attention in the PyTorch port against the JAX package.

The port's ``kubernetes1_tpu_torch/workloads/ringattention.py`` and its K6
ops (``kernels/ringattention.py``: block, merge, block backward) on the
CPU, in f32 on the plain versions: each case holds them against the JAX
functions on the same seeded numpy inputs.  The JAX side keeps its
``(o unnormalised, m, l)`` partials; the port's lse form is compared
through ``o / l`` and ``m + log l`` where ``l > 0``.

The ring itself runs over four real gloo ranks (subprocesses that import
torch and the port, never JAX), spawned once for the whole file; the JAX
ring runs here on a 4-device ``sp`` mesh.  The lockstep functions, which
``chip_smoke.py`` runs on one card for n virtual ranks, are held to that
gloo ring bit for bit.
"""

import os
import subprocess
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from kubernetes1_tpu.workloads import ringattention as jra
from kubernetes1_tpu_torch.kernels import attention, ringattention as kra
from kubernetes1_tpu_torch.workloads import ringattention as ra

REPO = Path(__file__).resolve().parent.parent
RANKS = 4
B, S, H, HKV, HD = 2, 64, 4, 2, 16          # tests/test_workloads.py's ring shapes
JAX_RING_TOL = 1e-4                         # tests/test_workloads.py's bar, forward and grad
# bf16 ring vs the plain dense attention on the same bf16 inputs: the ring
# rounds each of its n = 4 block outputs once (2^-9 relative) and merges
# them in f32, then rounds once more; the dense version rounds each
# normalised probability (2^-9 relative) before P.V and the output once.
# So an output element differs by a few bf16 steps of the block outputs
# (|o| <= max|v| ~ 4): 2^-7 relative plus 1e-2 absolute.  Gradients,
# whose chains round P and dS in bf16 in both (at other places): relative
# L2 2e-2, the bar the backward kernels meet on the card.
BF16_TOL = (1e-2, 2.0 ** -7)
BF16_GRAD_REL_L2 = 2e-2


def _np(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _jax_lse_form(o, m, l):
    """JAX's (o unnormalised (B, S, H, hd), m, l (B, H, S)) -> (o / l, m +
    log l, l > 0) as numpy."""
    o, m, l = (np.asarray(x, np.float64) for x in (o, m, l))
    live = l > 0
    safe = np.where(live, l, 1.0)
    return o / safe.transpose(0, 2, 1)[..., None], m + np.log(safe), live


def _assert_lse_form(o, lse, jo, jlse, live, tol):
    o, lse = o.double().numpy(), lse.double().numpy()
    lv = live.transpose(0, 2, 1)
    np.testing.assert_allclose(lse[live], jlse[live], rtol=tol, atol=tol)
    np.testing.assert_allclose(o[lv], jo[lv], rtol=tol, atol=tol)
    assert np.all(lse[~live] == -np.inf) and np.all(o[~lv] == 0)  # no NaN on dead rows


def _repeat_kv(k, groups):
    return jnp.repeat(jnp.asarray(k), groups, axis=2)


# ------------------------------------------------------------ the K6 ops

BLOCKS = {  # (q_off, kv_off, causal) for blocks of 16 rows
    "diagonal": (16, 16, True),
    "behind": (32, 0, True),
    "ahead": (0, 16, True),          # every row masked: l = 0
    "unaligned": (5, 11, True),      # rows 0-5 masked, the rest a ragged triangle
    "noncausal": (0, 48, False),
}


@pytest.mark.parametrize("hd", [8, 16])
@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_block_attn_plain_matches_jax(block, hd):
    q_off, kv_off, causal = BLOCKS[block]
    q, k, v = _np(3, (2, 16, 4, hd), (2, 16, 2, hd), (2, 16, 2, hd))
    jo, jm, jl = jra._block_attn(jnp.asarray(q), _repeat_kv(k, 2), _repeat_kv(v, 2),
                                 q_off, kv_off, causal)
    o, lse = kra.block_attn_plain(_t(q), _t(k), _t(v), q_off, kv_off, causal)
    assert o.dtype == torch.float32 and lse.shape == (2, 4, 16)
    _assert_lse_form(o, lse, *_jax_lse_form(jo, jm, jl), 1e-5)


def test_merge_plain_matches_jax_including_dead_rows():
    q, k, v = _np(4, (2, 16, 4, 16), (2, 16, 2, 16), (2, 16, 2, 16))
    k2, v2 = _np(5, (2, 16, 2, 16), (2, 16, 2, 16))
    jq = jnp.asarray(q)
    parts = {name: jra._block_attn(jq, _repeat_kv(kk, 2), _repeat_kv(vv, 2), qo, ko, True)
             for name, (kk, vv, qo, ko) in {"diag": (k, v, 16, 16), "ragged": (k2, v2, 5, 11),
                                            "ahead": (k, v, 0, 16)}.items()}
    init = (jnp.zeros(q.shape), jnp.full((2, 4, 16), jra.NEG_INF), jnp.zeros((2, 4, 16)))
    parts["init"] = init

    def port(part):
        o, lse, live = _jax_lse_form(*part)
        return (_t(np.where(live.transpose(0, 2, 1)[..., None], o, 0.0)),
                _t(np.where(live, lse, -np.inf)))

    for a, n in (("init", "ahead"), ("init", "ragged"), ("ragged", "diag"), ("ahead", "ragged"),
                 ("diag", "ahead")):
        got = kra.merge_plain(*port(parts[a]), *port(parts[n]))
        _assert_lse_form(*got, *_jax_lse_form(*jra._merge(parts[a], parts[n])), 1e-6)
    o, lse = kra.merge_plain(*port(init), *port(parts["ahead"]))
    assert torch.all(lse == -np.inf) and torch.all(o == 0)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_reference_attention_matches_jax(causal):
    q, k, v = _np(6, (B, S, H, HD), (B, S, HKV, HD), (B, S, HKV, HD))
    want = np.asarray(jra.reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              causal=causal))
    got = ra.reference_attention(_t(q), _t(k), _t(v), causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_block_bwd_plain_of_the_one_block_is_the_attention_gradient():
    """At one block (n = 1) the block backward with the block's own lse
    and delta is the whole gradient: autograd of the dense plain forward."""
    q, k, v, do = (_t(a) for a in _np(7, (B, 32, H, HD), (B, 32, HKV, HD), (B, 32, HKV, HD),
                                      (B, 32, H, HD)))
    for causal in (True, False):
        o, lse = kra.block_attn_plain(q, k, v, 0, 0, causal)
        dq, dk, dv = kra.block_bwd_plain(q, k, v, do, lse, kra.delta_plain(o, do), causal)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        want = torch.autograd.grad(attention.attention_plain(*leaves, causal=causal), leaves, do)
        for g, w in zip((dq, dk, dv), want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------ over gloo ranks

_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from kubernetes1_tpu_torch.workloads import ringattention as ra

rank, n, store, inp, out = int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, n), rank=rank, world_size=n)
try:
    mesh = init_device_mesh("cpu", (n,), mesh_dim_names=("sp",))
    data = np.load(inp)
    res = {}
    for case in ("f32_causal", "f32_noncausal", "bf16_causal"):
        dt = torch.bfloat16 if case.startswith("bf16") else torch.float32
        sb = data["q"].shape[1] // n
        q, k, v, do = (torch.from_numpy(np.ascontiguousarray(
            data[name][:, rank * sb:(rank + 1) * sb])).to(dt) for name in ("q", "k", "v", "do"))
        q, k, v = (t.requires_grad_(True) for t in (q, k, v))
        o = ra.ring_attention(q, k, v, mesh, "sp", causal=case.endswith("_causal"))
        o.backward(do)
        for name, t in (("o", o), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
            res[f"{case}/{name}"] = t.detach().float().numpy()
    np.savez(out % rank, **res)
finally:
    dist.destroy_process_group()
"""
CASES = ("f32_causal", "f32_noncausal", "bf16_causal")


@pytest.fixture(scope="module")
def inputs():
    q, k, v, do = _np(11, (B, S, H, HD), (B, S, HKV, HD), (B, S, HKV, HD), (B, S, H, HD))
    return dict(q=q, k=k, v=v, do=do)


@pytest.fixture(scope="module")
def gloo_ring(inputs, tmp_path_factory):
    """Every case's output and gradients from one run of four gloo ranks,
    each rank's blocks concatenated along the sequence: case -> name ->
    array."""
    tmp = tmp_path_factory.mktemp("gloo_ring")
    np.savez(tmp / "in.npz", **inputs)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    logs = [open(tmp / f"err{r}.log", "w") for r in range(RANKS)]
    procs = []
    try:
        for r in range(RANKS):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _WORKER, str(r), str(RANKS), str(tmp / "store"),
                 str(tmp / "in.npz"), str(tmp / "out%d.npz")],
                cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=logs[r]))
        rcs = [p.wait(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    errs = "\n".join((tmp / f"err{r}.log").read_text() for r in range(RANKS))
    assert rcs == [0] * RANKS, errs
    outs = [np.load(tmp / f"out{r}.npz") for r in range(RANKS)]
    return {case: {name: np.concatenate([o[f"{case}/{name}"] for o in outs], axis=1)
                   for name in ("o", "dq", "dk", "dv")} for case in CASES}


@pytest.fixture(scope="module")
def jax_ring(inputs):
    """JAX's ring on a 4-device ``sp`` mesh, once per mask: causal ->
    (output, its VJP at the cotangent ``do`` (the gradient of
    sum(out * do), as jax.grad takes it), the dense reference)."""
    mesh = Mesh(np.array(jax.devices()[:RANKS]), ("sp",))
    q, k, v, do = (jnp.asarray(inputs[n]) for n in ("q", "k", "v", "do"))
    res = {}
    for causal in (True, False):
        def ring_and_vjp(a, b, c, d, causal=causal):
            out, vjp = jax.vjp(lambda x, y, z: jra.ring_attention(x, y, z, mesh, causal=causal),
                               a, b, c)
            return out, vjp(d)

        out, grads = jax.jit(ring_and_vjp)(q, k, v, do)
        ref = jra.reference_attention(q, k, v, causal=causal)
        res[causal] = (np.asarray(out), [np.asarray(g) for g in grads], np.asarray(ref))
    return res


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_ring_over_gloo_matches_jax_ring_and_reference(gloo_ring, jax_ring, causal):
    got = gloo_ring["f32_causal" if causal else "f32_noncausal"]
    out, _grads, ref = jax_ring[causal]
    assert got["o"].shape == (B, S, H, HD)
    np.testing.assert_allclose(got["o"], out, rtol=0, atol=JAX_RING_TOL)
    np.testing.assert_allclose(got["o"], ref, rtol=0, atol=JAX_RING_TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_ring_over_gloo_gradients_match_jax_grad(gloo_ring, jax_ring, causal):
    got = gloo_ring["f32_causal" if causal else "f32_noncausal"]
    _out, grads, _ref = jax_ring[causal]
    for name, want in zip(("dq", "dk", "dv"), grads):
        assert got[name].shape == want.shape, name
        np.testing.assert_allclose(got[name], want, rtol=0, atol=JAX_RING_TOL, err_msg=name)


def test_ring_over_gloo_bf16_matches_the_plain_dense_attention(gloo_ring, inputs):
    got = gloo_ring["bf16_causal"]
    leaves = [_t(inputs[n], torch.bfloat16).requires_grad_(True) for n in ("q", "k", "v")]
    want = attention.attention_plain(*leaves, causal=True)
    grads = torch.autograd.grad(want, leaves, _t(inputs["do"], torch.bfloat16))
    atol, rtol = BF16_TOL
    w = want.detach().float().numpy()
    assert np.all(np.abs(got["o"] - w) <= atol + rtol * np.abs(w))
    for name, g in zip(("dq", "dk", "dv"), grads):
        g = g.float().numpy()
        assert np.linalg.norm(got[name] - g) <= BF16_GRAD_REL_L2 * np.linalg.norm(g), name


def _blocks(inputs, n, dtype=torch.float32):
    sb = S // n
    return [[_t(inputs[name][:, r * sb:(r + 1) * sb], dtype) for r in range(n)]
            for name in ("q", "k", "v", "do")]


def _lockstep(inputs, n, causal, dtype=torch.float32, ops=ra.KERNELS):
    qs, ks, vs, dos = _blocks(inputs, n, dtype)
    os_, lses = ra.lockstep_forward(qs, ks, vs, causal, ops)
    grads = ra.lockstep_backward(qs, ks, vs, os_, lses, dos, causal, ops)
    return {name: torch.cat(ts, 1).float().numpy()
            for name, ts in zip(("o", "dq", "dk", "dv"), (os_, *grads))}


@pytest.mark.parametrize("case", CASES)
def test_lockstep_equals_the_gloo_ring_bit_for_bit(gloo_ring, inputs, case):
    """The steps chip_smoke.py drives for n virtual ranks on one card are
    the ring's own: same inputs, n = 4, equal bits."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as each gloo rank: one thread, one summation order
    try:
        got = _lockstep(inputs, RANKS, case.endswith("_causal"),
                        torch.bfloat16 if case.startswith("bf16") else torch.float32)
    finally:
        torch.set_num_threads(threads)
    for name in ("o", "dq", "dk", "dv"):
        np.testing.assert_array_equal(got[name], gloo_ring[case][name], err_msg=name)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_lockstep_matches_dense_attention_and_its_gradient(inputs, n, causal):
    got = _lockstep(inputs, n, causal)
    leaves = [_t(inputs[name]).requires_grad_(True) for name in ("q", "k", "v")]
    want = ra.reference_attention(*leaves, causal=causal)
    grads = torch.autograd.grad(want, leaves, _t(inputs["do"]))
    np.testing.assert_allclose(got["o"], want.detach().numpy(), rtol=0, atol=JAX_RING_TOL)
    for name, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(got[name], g.numpy(), rtol=0, atol=JAX_RING_TOL, err_msg=name)


def _counting(ops, counts):
    """``ops`` with each call tallied under the counter the card's launch
    would go to."""
    def tally(key):
        counts[key] = counts.get(key, 0) + 1

    def block(q, k, v, q_off, kv_off, causal):
        tally("block" if causal and q_off == kv_off else "block_nc")
        return ops.block(q, k, v, q_off, kv_off, causal)

    def merge(*args):
        tally("merge")
        return ops.merge(*args)

    def block_bwd(q, k, v, dout, lse, delta, causal, *rest):
        tally("block_bwd" if causal else "block_bwd_nc")
        return ops.block_bwd(q, k, v, dout, lse, delta, causal, *rest)

    return ra.Ops(block, merge, block_bwd)


@pytest.mark.parametrize("n,causal,want", [
    (8, True, dict(block=8, block_nc=28, merge=28, block_bwd=8, block_bwd_nc=28)),
    (4, False, dict(block_nc=16, merge=12, block_bwd_nc=16)),
    (1, True, dict(block=1, block_bwd=1)),
], ids=["causal8", "noncausal4", "causal1"])
def test_a_ring_makes_the_launches_chip_smoke_asserts(inputs, n, causal, want):
    """A causal ring of n ranks folds n diagonal and n(n-1)/2 behind blocks
    (the n(n-1)/2 ahead are skipped) with one merge fewer than blocks per
    rank; a non-causal one folds all n^2 blocks."""
    counts = {}
    _lockstep(inputs, n, causal, ops=_counting(ra.PLAIN, counts))
    assert counts == want


def test_ring_block_kernel_maps_the_ring_offsets_to_the_two_kernels(monkeypatch):
    """On the card the diagonal goes to K1's launch, a block behind (or any
    non-causal block) to K7a's, each through the ring's own counter; a
    block ahead or a ragged pair is refused."""
    seen = []
    monkeypatch.setattr(attention, "attention_kernel",
                        lambda q, k, v, with_lse, causal, kernel: seen.append((causal, kernel)))
    q = torch.zeros(1, 16, 4, 16)
    k = torch.zeros(1, 16, 2, 16)
    kra.ring_block_kernel(q, k, k, 32, 32, True)
    kra.ring_block_kernel(q, k, k, 32, 16, True)
    kra.ring_block_kernel(q, k, k, 0, 32, False)
    assert seen == [(True, kra.RING_BLOCK), (False, kra.RING_BLOCK_NC),
                    (False, kra.RING_BLOCK_NC)]
    for q_off, kv_off in ((16, 32), (16, 8)):
        with pytest.raises(ValueError, match="diagonal block or one wholly behind"):
            kra.ring_block_kernel(q, k, k, q_off, kv_off, True)
    with pytest.raises(ValueError, match="one length"):
        kra.ring_block_kernel(q, k[:, :8], k[:, :8], 0, 0, True)


# ------------------------------------------------ transfers in stream order


class _Transfers:
    """The state the thread-ranks of ``_TimedRing`` share: a mailbox, a
    barrier, and when each transfer happens."""

    def __init__(self, n, when):
        self.n, self.when = n, when
        self.barrier = threading.Barrier(n, timeout=60)
        self.mail = {}


class _TimedRing:
    """A stand-in for ``ra._Ring`` over threads of one process, each a
    rank, whose transfer happens at a chosen moment inside [post, wait].
    On the card a transfer posted on the stream runs after every kernel
    enqueued before the post and alongside those enqueued after it, until
    the wait.  ``when == "post"`` moves the data at the post; ``"wait"``
    poisons the receive buffer with NaN at the post and moves the data as
    the send buffer stands at the wait.  A ring that writes a buffer it
    is sending, or touches one it is receiving, between post and wait
    gives different results under the two."""

    def __init__(self, group):
        self.t, self.r = group
        self.n, self.seq = self.t.n, 0

    def exchange(self, send, recv, tag):
        t, key = self.t, (tag, self.seq)
        self.seq += 1

        def transfer():
            t.mail[((self.r + 1) % self.n, key)] = send.clone()
            t.barrier.wait()
            recv.copy_(t.mail.pop((self.r, key)))
            t.barrier.wait()

        if t.when == "post":
            transfer()
            return [SimpleNamespace(wait=lambda: None)]
        recv.fill_(255)  # NaN in f32 and bf16
        return [SimpleNamespace(wait=transfer)]


def _threaded_ring(inputs, causal, when):
    """The ring over RANKS thread-ranks, each calling ``ring_attention``
    and its backward: name -> the blocks concatenated."""
    t = _Transfers(RANKS, when)
    qs, ks, vs, dos = _blocks(inputs, RANKS)
    res, errors = [None] * RANKS, []

    def rank(r):
        try:
            mesh = SimpleNamespace(get_group=lambda axis: (t, r))
            leaves = [x[r].clone().requires_grad_(True) for x in (qs, ks, vs)]
            o = ra.ring_attention(*leaves, mesh, "sp", causal=causal)
            res[r] = [o.detach(), *torch.autograd.grad(o, leaves, dos[r])]
        except Exception as e:  # re-raised below, after the join
            errors.append(e)
            t.barrier.abort()

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(RANKS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return {name: torch.cat([x[i] for x in res], 1).numpy()
            for i, name in enumerate(("o", "dq", "dk", "dv"))}


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_ring_results_do_not_depend_on_when_a_transfer_runs(inputs, monkeypatch, causal):
    """``ring_attention``'s forward and backward, with every transfer at
    its post and then at its wait, equal the lockstep ring bit for bit: no
    step writes a buffer in flight or reads one before its wait, and each
    send is posted after its buffer's producer.  This is the order NCCL
    needs on the card, where the transfers between cards are unmeasured."""
    monkeypatch.setattr(ra, "_Ring", _TimedRing)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = _lockstep(inputs, RANKS, causal)
        got = {when: _threaded_ring(inputs, causal, when) for when in ("post", "wait")}
    finally:
        torch.set_num_threads(threads)
    for when, res in got.items():
        for name in ("o", "dq", "dk", "dv"):
            np.testing.assert_array_equal(res[name], want[name], err_msg=f"{when} {name}")
