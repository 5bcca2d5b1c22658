"""Llama-3-style decoder-only transformer, its train step and its decode
server, in PyTorch.

The port of the JAX package's ``workloads/llama.py`` on one card: the
model (``forward`` over a plain parameter dict), the training half
(``loss_fn``, ``make_train_state``, ``make_train_step``, ``train_demo``,
remat) and the continuous-batching decode server (``BatchEngine``,
``DecodeServer``) with the same HTTP contract and the same
``ktpu_llama_*`` metrics.  Attention, RMSNorm, RoPE, SwiGLU and the
cross-entropy run as hand-written CUDA kernels on the card, forward and
backward (``kubernetes1_tpu_torch.kernels``), and so does the AdamW
update (``kubernetes1_tpu_torch.optim``); the matrix products stay
``torch.matmul`` and the sampling ``torch.argmax``, as the JAX package
left them to XLA.

Weights keep JAX's ``(d_in, d_out)`` layout and the forward computes
``h @ W``, so weights carried over from the JAX pytree
(``params_from_jax``) need no transpose.  Layers are a list of per-layer
dicts (JAX stacks them on a leading axis for ``lax.scan``).  The train
step runs over a ``DeviceMesh`` (``mesh=``, one process per card) with
JAX's placement (``param_specs``): each rank holds its block of every
leaf, the data ranks (dp x fsdp) take their rows of the global batch, a
layer gathers its fsdp blocks where it runs (inside remat's checkpoint,
so the backward gathers them again), and over tp the layer works on its
heads and its columns of d_ff (Megatron's split: q, k, v, gate and up
split by column behind the tp "copy", wo and down by row before the tp
"reduce"), the embedding looks up its vocab block and the loss is K5's
vocab-parallel form.  ``serving_deployment`` comes with a later slice.

Llama-3-8B = LlamaConfig(d_model=4096, n_layers=32, n_heads=32,
n_kv_heads=8, d_ff=14336, vocab=128256, rope_theta=500000).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import queue
import threading
import time
from functools import partial
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..kernels import attention as _attention
from ..kernels import cross_entropy as _cross_entropy
from ..kernels import rmsnorm as _rmsnorm
from ..kernels import rope as _rope
from ..kernels import swiglu as _swiglu
from .. import optim
from ..obs.appmetrics import AppMetrics
from . import sharding
from .sharding import resolve_device


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    max_seq: int = 8192
    rope_theta: float = 500000.0
    dtype: torch.dtype = torch.bfloat16  # compute dtype; weights may be f32
    remat: bool = True
    # "save_attn" keeps the attention's output and what its backward needs
    # across the remat boundary, so attention never recomputes in backward;
    # "full" recomputes the whole layer
    remat_policy: str = "save_attn"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def llama_3_8b() -> LlamaConfig:
    return LlamaConfig(vocab=128256, d_model=4096, n_layers=32, n_heads=32,
                       n_kv_heads=8, d_ff=14336)


def tiny(vocab: int = 256, d_model: int = 64, n_layers: int = 2, n_heads: int = 4,
         n_kv_heads: int = 2, d_ff: int = 128, max_seq: int = 128) -> LlamaConfig:
    return LlamaConfig(vocab=vocab, d_model=d_model, n_layers=n_layers,
                       n_heads=n_heads, n_kv_heads=n_kv_heads, d_ff=d_ff,
                       max_seq=max_seq, remat=False)


# ------------------------------------------------------------------- params
#
# Weights are stored in a dtype of the caller's choice: f32 master weights
# for training (as the JAX package keeps them), cfg.dtype for serving.  The
# forward casts each weight to cfg.dtype at its use, as the JAX forward
# does, which is a no-op on weights stored in cfg.dtype: serving stores
# bf16 once (16 GB for Llama-3-8B instead of 32 GB of f32) and the numbers
# are the same, since the cast rounds to nearest even either way.

LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down")
# JAX's PartitionSpecs (kubernetes1_tpu/workloads/llama.py:71-94) without
# the stacked layer axis: Megatron's tp on heads and d_ff, fsdp on the other
# weight dim; the vocab over tp and fsdp.
LAYER_SPECS = {
    "attn_norm": (None,),
    "wq": ("fsdp", "tp"), "wk": ("fsdp", "tp"), "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    "mlp_norm": (None,),
    "w_gate": ("fsdp", "tp"), "w_up": ("fsdp", "tp"),
    "w_down": ("tp", "fsdp"),
}
EMBED_SPEC = (("tp", "fsdp"), None)   # (vocab, d)
FINAL_NORM_SPEC = (None,)
UNEMBED_SPEC = ("fsdp", "tp")         # (d, vocab)


def param_specs(cfg: LlamaConfig) -> Dict[str, Any]:
    """Each leaf's placement over a ``("dp", "fsdp", "tp")`` mesh, JAX's
    ``param_specs`` leaf for leaf (``sharding.Spec``); "layers" is the one
    spec dict of every layer."""
    return {"embed": EMBED_SPEC, "layers": dict(LAYER_SPECS), "final_norm": FINAL_NORM_SPEC,
            "unembed": UNEMBED_SPEC}


def leaf_shapes(cfg: LlamaConfig):
    """Every leaf of ``init_params`` in its draw order: (path, whole shape,
    fan_in), the path ("embed",) or ("layers", i, key); fan_in None for a
    norm's scale (ones)."""
    d, hd = cfg.d_model, cfg.head_dim
    q, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    layer = {"attn_norm": ((d,), None), "wq": ((d, q), d), "wk": ((d, kv), d),
             "wv": ((d, kv), d), "wo": ((q, d), q), "mlp_norm": ((d,), None),
             "w_gate": ((d, cfg.d_ff), d), "w_up": ((d, cfg.d_ff), d),
             "w_down": ((cfg.d_ff, d), cfg.d_ff)}
    yield ("embed",), (cfg.vocab, d), d
    for i in range(cfg.n_layers):
        for key in LAYER_KEYS:
            yield ("layers", i, key), *layer[key]
    yield ("final_norm",), (d,), None
    yield ("unembed",), (d, cfg.vocab), d


def init_leaves(cfg: LlamaConfig, generator: torch.Generator,
                dtype: Optional[torch.dtype] = None):
    """``init_params``'s leaves one at a time, in its draw order: (path,
    tensor)."""
    dev = generator.device
    dtype = dtype or cfg.dtype
    for path, shape, fan_in in leaf_shapes(cfg):
        if fan_in is None:
            yield path, torch.ones(shape, device=dev, dtype=dtype)
        else:
            x = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
            yield path, x.div_(math.sqrt(fan_in)).to(dtype)


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Random weights in ``dtype`` (default cfg.dtype) on ``generator``'s
    device, with the JAX package's distributions: normal / sqrt(fan_in)
    for matrices, ones for norms.  (The draws differ from
    ``jax.random``'s; carry JAX weights over with ``params_from_jax``
    where the numbers must match.)"""
    return sharding.tree_from_leaves(init_leaves(cfg, generator, dtype), cfg.n_layers)


def params_from_jax(tree: Dict[str, Any], cfg: LlamaConfig, device: torch.device | str,
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The JAX package's parameter pytree, given as numpy arrays
    (``jax.tree.map(np.asarray, params)``), as this module's parameter
    dict on ``device`` in ``dtype`` (default cfg.dtype; f32 for training):
    the stacked leading layer axis is split into one dict per layer, and
    every weight keeps its (d_in, d_out) layout."""
    dtype = dtype or cfg.dtype

    def tensor(a) -> torch.Tensor:
        # a fresh copy: the port must not alias (or write into) JAX's buffers
        arr = np.array(a, dtype=np.float32, order="C")
        return torch.from_numpy(arr).to(device=device, dtype=dtype)

    layers = tree["layers"]
    if set(layers) != set(LAYER_KEYS):
        raise ValueError(f"layer keys {sorted(layers)} != {sorted(LAYER_KEYS)}")
    n = {np.shape(a)[0] for a in layers.values()}
    if n != {cfg.n_layers}:
        raise ValueError(f"stacked layer axis {n} != n_layers {cfg.n_layers}")
    return {
        "embed": tensor(tree["embed"]),
        "layers": [{key: tensor(layers[key][i]) for key in LAYER_KEYS}
                   for i in range(cfg.n_layers)],
        "final_norm": tensor(tree["final_norm"]),
        "unembed": tensor(tree["unembed"]),
    }


def param_leaves(params: Dict[str, Any]) -> List[torch.Tensor]:
    """Every weight, in a fixed order: embed, each layer's LAYER_KEYS,
    final_norm, unembed."""
    return ([params["embed"]] + [lp[key] for lp in params["layers"] for key in LAYER_KEYS]
            + [params["final_norm"], params["unembed"]])


def leaf_groups(params: Dict[str, Any]) -> List[Tuple[str, List[torch.Tensor]]]:
    """The JAX pytree's leaves, each as (name, its tensors): embed, then
    each of LAYER_KEYS as ``layers.<key>`` with one tensor per layer (the
    leaf JAX stacks on a leading axis), final_norm, unembed.  The same
    tensors as ``param_leaves``, grouped as Adafactor needs them."""
    return ([("embed", [params["embed"]])]
            + [(f"layers.{key}", [lp[key] for lp in params["layers"]]) for key in LAYER_KEYS]
            + [("final_norm", [params["final_norm"]]), ("unembed", [params["unembed"]])])


# ------------------------------------------------------------------ modules

class Ops(NamedTuple):
    """The kernel-backed ops of the model and its loss."""

    rmsnorm: Callable
    rope: Callable
    attention: Callable
    swiglu: Callable
    cross_entropy: Callable
    # over a vocab block: (logits, targets, v0, tp group) -> per-row loss
    cross_entropy_vp: Callable = _cross_entropy.cross_entropy_vocab_parallel


# The wrappers: the kernels on CUDA tensors (forward and backward), the
# plain versions on CPU ones.
KERNELS = Ops(_rmsnorm.rmsnorm, _rope.rope, _attention.attention, _swiglu.swiglu,
              _cross_entropy.cross_entropy)
# The plain versions on every device: the reference a card run compares with.
PLAIN = Ops(_rmsnorm.rmsnorm_plain, _rope.rope_plain, _attention.attention_plain,
            _swiglu.swiglu_plain, _cross_entropy.cross_entropy_plain,
            _cross_entropy.cross_entropy_vocab_parallel_plain)
# No mesh: every leaf whole, no collective.
WHOLE = sharding.Layout()


def _attn_inputs(cfg: LlamaConfig, x: torch.Tensor, lp: Dict[str, torch.Tensor],
                 ops: Ops, lay: sharding.Layout = WHOLE
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The layer up to the attention call: rotated q, k and v of this
    rank's heads (n_heads / tp and n_kv_heads / tp)."""
    B, S, _d = x.shape
    hd, dt = cfg.head_dim, cfg.dtype
    h = lay.copy(ops.rmsnorm(x, lp["attn_norm"]))

    def proj(key):
        return (h @ lay.full(lp[key].to(dt), LAYER_SPECS[key])).reshape(B, S, -1, hd)

    q, k, v = proj("wq"), proj("wk"), proj("wv")
    q, k = ops.rope(q, k, cfg.rope_theta)
    return q, k, v


def _attn_out_and_mlp(cfg: LlamaConfig, x: torch.Tensor, attn: torch.Tensor,
                      lp: Dict[str, torch.Tensor], ops: Ops,
                      lay: sharding.Layout = WHOLE) -> torch.Tensor:
    """The layer after the attention call: output projection, residual,
    RMSNorm, SwiGLU MLP, residual; over tp, each projection's partial sum
    over this rank's heads or columns of d_ff, added across the ranks."""
    B, S, _d = x.shape
    dt = cfg.dtype

    def w(key):
        return lay.full(lp[key].to(dt), LAYER_SPECS[key])

    x = x + lay.reduce(attn.reshape(B, S, -1) @ w("wo"))
    h = lay.copy(ops.rmsnorm(x, lp["mlp_norm"]))
    mlp = ops.swiglu(h @ w("w_gate"), h @ w("w_up"))
    return x + lay.reduce(mlp @ w("w_down"))


def layer_fn(cfg: LlamaConfig, x: torch.Tensor, lp: Dict[str, torch.Tensor],
             ops: Ops = KERNELS, lay: sharding.Layout = WHOLE) -> torch.Tensor:
    q, k, v = _attn_inputs(cfg, x, lp, ops, lay)
    return _attn_out_and_mlp(cfg, x, ops.attention(q, k, v), lp, ops, lay)


def _remat_layer(cfg: LlamaConfig, x: torch.Tensor, lp: Dict[str, torch.Tensor],
                 ops: Ops, lay: sharding.Layout = WHOLE) -> torch.Tensor:
    """``layer_fn`` under activation checkpointing (JAX: jax.checkpoint on
    the layer body).  "save_attn": the parts before and after the
    attention call are checkpointed and recomputed in backward, while the
    attention keeps its output and its backward's inputs, so it runs once
    per layer and step.  "full": the whole layer recomputes.  The fsdp
    gathers run inside the checkpointed parts: the backward gathers again,
    and one layer's whole weights are alive at a time."""
    if cfg.remat_policy == "save_attn":
        q, k, v = checkpoint(_attn_inputs, cfg, x, lp, ops, lay, use_reentrant=False)
        return checkpoint(_attn_out_and_mlp, cfg, x, ops.attention(q, k, v), lp, ops, lay,
                          use_reentrant=False)
    if cfg.remat_policy == "full":
        return checkpoint(layer_fn, cfg, x, lp, ops, lay, use_reentrant=False)
    raise ValueError(f"remat_policy {cfg.remat_policy!r}: 'save_attn' or 'full'")


def final_hidden(cfg: LlamaConfig, params: Dict[str, Any], tokens: torch.Tensor,
                 ops: Ops = KERNELS, lay: sharding.Layout = WHOLE) -> torch.Tensor:
    """tokens (B, S) integer -> the final-normed hidden state (B, S, d) in
    cfg.dtype; positions are arange(S) on every row."""
    # gather the rows, then cast: the values of casting the whole table first
    x = lay.lookup(params["embed"], tokens, EMBED_SPEC, cfg.dtype)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in params["layers"]:
        x = _remat_layer(cfg, x, lp, ops, lay) if remat else layer_fn(cfg, x, lp, ops, lay)
    return ops.rmsnorm(x, params["final_norm"])


def forward(cfg: LlamaConfig, params: Dict[str, Any], tokens: torch.Tensor,
            ops: Ops = KERNELS) -> torch.Tensor:
    """tokens (B, S) integer -> logits (B, S, vocab) float32."""
    x = final_hidden(cfg, params, tokens, ops)
    return (x @ params["unembed"].to(cfg.dtype)).float()


def loss_fn(cfg: LlamaConfig, params: Dict[str, Any], tokens: torch.Tensor,
            ops: Ops = KERNELS, lay: sharding.Layout = WHOLE) -> torch.Tensor:
    """Next-token cross entropy over tokens (B, S), a 0-dim f32 tensor.
    The logits stay in cfg.dtype: the cross-entropy op reads them there
    and never holds an f32 (B, S, vocab) copy.  Over tp, this rank's
    logits are its vocab block's, and the loss is K5's vocab-parallel
    form over the tp ranks."""
    x = lay.copy(final_hidden(cfg, params, tokens[:, :-1], ops, lay))
    logits = x @ lay.full(params["unembed"].to(cfg.dtype), UNEMBED_SPEC)
    # a fresh tensor: the kernels take 16-byte aligned inputs, and one row's
    # slice of the batch (a data rank's) need not start at one
    targets = tokens[:, 1:].reshape(-1).to(torch.int64).clone()
    if lay.tp == 1:
        return ops.cross_entropy(logits.reshape(-1, cfg.vocab), targets).mean()
    block = logits.shape[-1]
    return ops.cross_entropy_vp(logits.reshape(-1, block), targets, lay.vocab_start(block),
                                lay.tp_group).mean()


# --------------------------------------------------------------- train step

def make_train_state(cfg: LlamaConfig, device: Optional[torch.device | str] = None,
                     lr: float = 3e-4, seed: int = 0,
                     params: Optional[Dict[str, Any]] = None, mesh=None
                     ) -> Tuple[Dict[str, Any], torch.optim.Optimizer]:
    """f32 master weights (random from ``seed``, or ``params``, e.g. from
    ``params_from_jax``) that require grad, and the port's AdamW (K10) over
    all of them: optax's ``adamw(lr, weight_decay=0.1)`` with its
    defaults, decay on every leaf.  ``device`` defaults to the card and
    raises without one.

    With ``mesh``, each rank keeps its block of every leaf by
    ``param_specs`` (``sharding.shard_params``), and the optimizer's state
    is of those blocks.  From the seed, every rank draws the whole leaves
    one at a time and keeps its block of each, so at most one whole leaf
    is alive; given ``params`` must be the same on every rank, and the
    dict's entries are replaced by the blocks (it is the returned dict)."""
    dev = resolve_device(device)
    specs = param_specs(cfg)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = sharding.tree_from_leaves(
            ((path, sharding.shard_tensor(t, sharding.spec_of(specs, path), mesh))
             for path, t in init_leaves(cfg, gen, dtype=torch.float32)), cfg.n_layers)
    elif mesh is not None:
        params.update(sharding.shard_params(params, specs, mesh))
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    return params, optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.1)


def make_train_step(cfg: LlamaConfig, params: Dict[str, Any], opt: torch.optim.Optimizer,
                    ops: Ops = KERNELS, mesh=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """step(tokens) -> the loss before the update (0-dim, detached): one
    value-and-grad of ``loss_fn`` and one optimizer update, in place.

    With ``mesh``, ``params`` are this rank's blocks (``make_train_state``
    with the mesh) and ``tokens`` is the global batch: each data rank
    takes its rows (``sharding.shard_batch``), the gradients are averaged
    over the data ranks before the update (``sharding.reduce_grads``) and
    the loss returned is the global one (the mean of the ranks' means:
    every rank has as many tokens).  Raises ValueError where a leaf is not
    this rank's block.  A mesh of dims ("dp",) alone
    (``sharding.data_mesh``) takes whole, replicated weights."""
    leaves = param_leaves(params)
    specs = sharding.spec_leaves(param_specs(cfg), cfg.n_layers, param_leaves)
    if mesh is not None:
        sharding.check_blocks(leaves, sharding.whole_shapes(leaf_shapes(cfg), cfg.n_layers,
                                                            param_leaves),
                              specs, mesh, "llama.make_train_step")
    lay = WHOLE if mesh is None else sharding.Layout(mesh, "avg")

    def step(tokens: torch.Tensor) -> torch.Tensor:
        if mesh is not None:
            tokens = sharding.shard_batch(tokens, mesh)
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(cfg, params, tokens, ops, lay)
        loss.backward()
        if mesh is not None:
            sharding.reduce_grads(leaves, specs, mesh, "avg")
            loss = sharding.all_reduce_value(loss, mesh, "avg")
        opt.step()
        return loss.detach()

    return step


def train_demo(cfg: Optional[LlamaConfig] = None, steps: int = 3, batch: int = 8,
               seq: int = 64, lr: float = 3e-4,
               device: Optional[torch.device | str] = None, mesh=None) -> float:
    """Run a few steps on one fixed batch of synthetic tokens (the step
    memorizes it); returns the final loss.  On the card unless
    ``device="cpu"``; raises when no card is visible.  ``batch`` is the
    global batch: without ``mesh``, a launcher's environment gives
    ``auto_mesh()`` (one process per card), else one device."""
    cfg = cfg or tiny()
    mesh = mesh if mesh is not None else sharding.launched_mesh(resolve_device(device))
    params, opt = make_train_state(cfg, device, lr=lr, mesh=mesh)
    step = make_train_step(cfg, params, opt, mesh=mesh)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, seq))).to(
        params["embed"].device)
    loss = None
    for _ in range(steps):
        loss = step(tokens)
    return float(loss)


# ------------------------------------------------------------ decode serving

def greedy_decode(cfg: LlamaConfig, params: Dict[str, Any], step_fn,
                  tokens, max_new: int = 8) -> list:
    """Greedy continuation of a prompt, one full forward per new token
    (no KV cache, as in the JAX package); returns the new token ids."""
    toks = [int(x) % cfg.vocab for x in tokens] or [1]
    device = params["embed"].device
    out = []
    with torch.inference_mode():
        for _ in range(max_new):
            window = torch.tensor([toks[-cfg.max_seq:]], dtype=torch.long, device=device)
            logits = step_fn(params, window)
            nxt = int(torch.argmax(logits[0, -1]))
            toks.append(nxt)
            out.append(nxt)
    return out


# Sequence-length buckets for the batched forward: every step pads to the
# next power of two (at least 8, at most max_seq), so the batch shape
# space is |buckets|, as in the JAX engine (where it bounds retraces).
def _seq_bucket(n: int, max_seq: int) -> int:
    b = 8
    while b < n and b < max_seq:
        b *= 2
    return min(b, max_seq)


class SlotLease:
    """One admitted request's handle: a per-request token stream.  The
    engine pushes each decoded token as its step completes; ``None``
    terminates the stream (max_new reached or engine shutdown)."""

    def __init__(self, tokens, max_new: int):
        self.prompt = list(tokens)
        self.max_new = max_new
        self.out: "queue.Queue[Optional[int]]" = queue.Queue()
        self.produced = 0
        self.slot: Optional[int] = None  # assigned at admission
        self.t_submit = 0.0
        self.t_last = 0.0

    def stream(self):
        """Yield tokens as the engine produces them (blocks between
        steps; ends at max_new)."""
        while True:
            tok = self.out.get()
            if tok is None:
                return
            yield tok

    def result(self, timeout: float = 60.0) -> list:
        """Drain the stream to a list (the non-streaming callers)."""
        deadline = time.monotonic() + timeout
        toks = []
        for tok in self.stream():
            toks.append(tok)
            if time.monotonic() > deadline:
                break
        return toks


class BatchEngine:
    """Continuous batching: ONE decode loop folds every in-flight request
    into a single forward per step, admitting new requests at step
    boundaries.  Capacity is the fixed slot pool, so saturation shows as
    ``ktpu_llama_slots_used`` against ``ktpu_llama_slots_total`` before
    it shows as latency.

    Rows are RIGHT-padded (real tokens first), positions are arange and
    attention is causal, so row i's logits at index len_i - 1 do not
    depend on the padding: batched greedy decode gives the tokens of
    sequential greedy decode.  Empty slots run as all-zero rows and read
    index 0, as in the JAX engine."""

    def __init__(self, cfg: LlamaConfig, params, step_fn,
                 slots: int = 8, metrics: Optional[AppMetrics] = None):
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self._step = step_fn
        self.slots = slots
        self._pending: List[SlotLease] = []
        self._active: Dict[int, SlotLease] = {}
        self._cond = threading.Condition()
        self._stopping = False
        self.steps = 0
        self.tokens_out = 0
        self.metrics = metrics
        if metrics is not None:
            self.slots_total = metrics.gauge(
                "ktpu_llama_slots_total", "decode batch slot pool size")
            self.slots_used = metrics.gauge(
                "ktpu_llama_slots_used", "decode batch slots leased")
            self.occupancy = metrics.histogram(
                "ktpu_llama_batch_occupancy",
                "active requests per decode step")
            self.token_latency = metrics.histogram(
                "ktpu_llama_token_latency_seconds",
                "per-token latency (inter-token gap; first = from admit)")
            self.slots_total.set(float(slots))
            self.slots_used.set(0.0)
        # one engine thread per server, not per connection/request: the
        # whole point is that N requests share this single decode loop
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="llama-batch-engine")
        self._thread.start()

    # ---------------------------------------------------------- intake

    def submit(self, tokens, max_new: int = 8) -> SlotLease:
        lease = SlotLease([int(x) % self.cfg.vocab for x in tokens] or [1],
                          max_new)
        lease.t_submit = lease.t_last = time.monotonic()
        with self._cond:
            if self._stopping:  # stopped, or the engine failed: end at once
                lease.out.put(None)
                return lease
            self._pending.append(lease)
            self._cond.notify()
        return lease

    def stop(self):
        with self._cond:
            self._stopping = True
            self._cond.notify()
        self._thread.join(timeout=5.0)

    # ------------------------------------------------------------ loop

    def _admit_locked(self):
        """Step-boundary admission: lease free slots to waiting
        requests, FIFO."""
        free = [s for s in range(self.slots) if s not in self._active]
        while free and self._pending:
            lease = self._pending.pop(0)
            lease.slot = free.pop(0)
            self._active[lease.slot] = lease

    def _end_all_locked(self):
        """Terminate every admitted and waiting request's stream."""
        for lease in list(self._active.values()) + self._pending:
            lease.out.put(None)
        self._active.clear()
        self._pending.clear()

    def _run(self):
        # inference mode is thread-local: enter it on the engine thread
        try:
            with torch.inference_mode():
                while self._step_once():
                    pass
        except BaseException:
            # a failed step (a kernel error, say) must not leave callers
            # blocked on streams nothing will ever feed
            with self._cond:
                self._stopping = True
                self._end_all_locked()
            raise

    def _step_once(self) -> bool:
        """One decode step over every active row; False once stopping."""
        with self._cond:
            self._admit_locked()
            while not self._active and not self._stopping:
                self._cond.wait(timeout=0.5)
                self._admit_locked()
            if self._stopping:
                self._end_all_locked()
                return False
            batch = dict(self._active)
        if self.metrics is not None:
            self.slots_used.set(float(len(batch)))
            self.occupancy.observe(float(len(batch)))
        # one forward per step over every active row, right-padded
        rows = {slot: lease.prompt[-self.cfg.max_seq:] for slot, lease in batch.items()}
        bucket = _seq_bucket(max([1] + [len(r) for r in rows.values()]), self.cfg.max_seq)
        arr = np.zeros((self.slots, bucket), np.int64)
        last = np.zeros((self.slots,), np.int64)
        for slot, toks in rows.items():
            arr[slot, :len(toks)] = toks
            last[slot] = len(toks) - 1
        logits = self._step(self.params, torch.from_numpy(arr).to(self.device))
        picks = torch.argmax(
            logits[torch.arange(self.slots, device=self.device),
                   torch.from_numpy(last).to(self.device)], dim=-1).tolist()
        now = time.monotonic()
        self.steps += 1
        done = []
        for slot, lease in batch.items():
            nxt = int(picks[slot])
            lease.prompt.append(nxt)
            lease.produced += 1
            self.tokens_out += 1
            if self.metrics is not None:
                self.token_latency.observe(now - lease.t_last)
                self.metrics.mark("ktpu_llama_tokens_per_s")
            lease.t_last = now
            lease.out.put(nxt)
            if lease.produced >= lease.max_new:
                lease.out.put(None)
                done.append(slot)
        if done:
            with self._cond:
                for slot in done:
                    self._active.pop(slot, None)
                self._cond.notify()
        return True


class DecodeServer:
    """The llama serving half: an HTTP decode endpoint plus the pod
    /metrics surface the kubelet's scrape agent lifts into
    PodCustomMetrics: QPS, in-flight requests, request-latency
    histograms and (with batching) the slot-pool saturation gauges.

        POST /generate  {"tokens": [...], "max_new": N} -> {"tokens": [...]}
                        {"stream": true} streams ndjson token lines
                        ({"token": t} per decode step) over chunked
                        transfer encoding instead
        GET  /metrics   prometheus text (appmetrics registry)
        GET  /healthz

    ``batching=True`` (default; env KTPU_LLAMA_BATCHING=0 disables)
    routes requests through the continuous-batching engine.
    ``batching=False`` keeps the sequential one-request-per-forward
    baseline.  ``device`` defaults to the card and raises when there is
    none; ``params`` (e.g. from ``params_from_jax``) replaces the random
    weights drawn from ``seed``.
    """

    def __init__(self, cfg: Optional[LlamaConfig] = None, port: int = 0,
                 seed: int = 0, batching: Optional[bool] = None,
                 slots: int = 8, device: Optional[torch.device | str] = None,
                 params: Optional[Dict[str, Any]] = None):
        self.cfg = cfg or tiny()
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(self.cfg, gen)
        self.params = params
        self._step = partial(forward, self.cfg)
        self.metrics = AppMetrics()
        self.requests_total = self.metrics.counter(
            "ktpu_llama_requests_total", "decode requests served")
        self.errors_total = self.metrics.counter(
            "ktpu_llama_request_errors_total", "malformed decode requests")
        self.inflight = self.metrics.gauge(
            "ktpu_llama_inflight", "decode requests currently in flight")
        self.latency = self.metrics.histogram(
            "ktpu_llama_request_latency_seconds", "decode request latency")
        if batching is None:
            batching = os.environ.get("KTPU_LLAMA_BATCHING", "1") != "0"
        self.batching = batching
        self.engine: Optional[BatchEngine] = None
        if batching:
            self.engine = BatchEngine(self.cfg, self.params, self._step,
                                      slots=slots, metrics=self.metrics)
        self._port = port
        self._srv: Optional[ThreadingHTTPServer] = None

    def generate(self, tokens, max_new: int = 8) -> list:
        t0 = time.monotonic()
        self.inflight.inc()
        try:
            if self.engine is not None:
                return self.engine.submit(tokens, max_new).result()
            return greedy_decode(self.cfg, self.params, self._step,
                                 tokens, max_new=max_new)
        finally:
            self.inflight.inc(-1)
            self.requests_total.inc()
            self.metrics.mark("ktpu_llama_qps")
            self.latency.observe(time.monotonic() - t0)

    def generate_stream(self, tokens, max_new: int = 8) -> SlotLease:
        """Streaming entry: returns the lease whose .stream() yields
        tokens at step cadence (batching only — the sequential arm has
        no step boundary to stream at)."""
        if self.engine is None:
            raise RuntimeError("streaming requires batching=True")
        return self.engine.submit(tokens, max_new)

    def warmup(self, tokens=(1, 2, 3), max_new: int = 4):
        """Serve one request outside the SLI histograms, so first-use
        costs (kernel build and load, allocator growth) never sit in the
        cumulative latency histogram."""
        if self.engine is not None:
            self.engine.submit(list(tokens), max_new).result()
            return
        greedy_decode(self.cfg, self.params, self._step, list(tokens),
                      max_new=max_new)

    # ------------------------------------------------------------- server

    def start(self) -> "DecodeServer":
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, body: bytes, ctype="application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/metrics"):
                    self._send(200, server.metrics.render().encode(),
                               ctype="text/plain; version=0.0.4")
                elif self.path.startswith("/healthz"):
                    self._send(200, b'{"status":"ok"}')
                else:
                    self._send(404, b'{"error":"unknown path"}')

            def do_POST(self):
                if not self.path.startswith("/generate"):
                    self._send(404, b'{"error":"unknown path"}')
                    return
                n = int(self.headers.get("Content-Length") or 0)
                try:
                    req = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(req, dict):
                        raise TypeError("body must be a JSON object")
                    toks = [int(x) for x in (req.get("tokens") or [])]
                    max_new = min(64, int(req.get("max_new") or 8))
                    stream = bool(req.get("stream"))
                except (ValueError, TypeError):
                    server.errors_total.inc()
                    self._send(400, b'{"error":"bad request"}')
                    return
                if stream and server.engine is not None:
                    self._stream(toks, max_new)
                    return
                out = server.generate(toks, max_new=max_new)
                self._send(200, json.dumps({"tokens": out}).encode())

            def _stream(self, toks, max_new: int):
                """Per-token streaming: one ndjson line per decode step
                over chunked transfer encoding."""
                t0 = time.monotonic()
                server.inflight.inc()
                try:
                    lease = server.generate_stream(toks, max_new=max_new)
                    self.send_response(200)
                    self.send_header("Content-Type", "application/x-ndjson")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()

                    def chunk(payload: bytes):
                        self.wfile.write(b"%x\r\n%s\r\n" % (len(payload), payload))

                    for tok in lease.stream():
                        chunk(b'{"token":%d}\n' % tok)
                    chunk(b'{"done":true}\n')
                    self.wfile.write(b"0\r\n\r\n")
                finally:
                    server.inflight.inc(-1)
                    server.requests_total.inc()
                    server.metrics.mark("ktpu_llama_qps")
                    server.latency.observe(time.monotonic() - t0)

        self._srv = ThreadingHTTPServer(("127.0.0.1", self._port), Handler)
        self._srv.daemon_threads = True
        threading.Thread(target=self._srv.serve_forever, daemon=True,
                         name="llama-decode").start()
        return self

    @property
    def port(self) -> int:
        return self._srv.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._srv.server_address[:2]
        return f"http://{host}:{port}"

    def stop(self):
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
        if self.engine is not None:
            self.engine.stop()
        self.metrics.stop()


def serving_deployment(name: str = "llama-serve", ns: str = "default",
                       replicas: int = 1, scrape_port: int = 0,
                       scrape_host: str = "", cpu: str = "100m") -> dict:
    """A Deployment of decode-server pods in the wire form (a dict, as
    ``workloads.specs`` builds them), the counterpart of the JAX package's
    ``serving_deployment``: its template carries the obs.ktpu.io scrape
    annotations, so each replica's kubelet lifts its /metrics into
    PodCustomMetrics (in-process clusters pass the loopback host:port of a
    live server; a real deployment omits ``scrape_host``).  Each pod runs
    ``python -m kubernetes1_tpu_torch.workloads.llama --serve`` and asks
    for one ``nvidia.com/gpu`` in the pod-level form: the port's
    ``DecodeServer`` raises without a card.  One server a card, a replica
    each: scale with ``replicas``."""
    from ..obs.appmetrics import scrape_annotations
    from .specs import gpu_request

    meta = {"labels": {"app": name}}
    if scrape_port:
        meta["annotations"] = scrape_annotations(scrape_port, host=scrape_host)
    pod_spec = {"containers": [{
        "name": "decode", "image": "ktpu/llama-decode",
        "command": ["python", "-m", "kubernetes1_tpu_torch.workloads.llama", "--serve"],
        "resources": {"requests": {"cpu": cpu}}}]}
    gpu_request(pod_spec, 1)
    return {"metadata": {"name": name, "namespace": ns},
            "spec": {"replicas": replicas, "selector": {"matchLabels": {"app": name}},
                     "template": {"metadata": meta, "spec": pod_spec}}}


def _serve_main():
    srv = DecodeServer().start()
    print(f"decode server on {srv.url}", flush=True)
    try:
        while True:
            time.sleep(5)
    except KeyboardInterrupt:
        srv.stop()


CONFIGS = {"tiny": tiny, "llama_3_8b": llama_3_8b}


if __name__ == "__main__":
    import sys

    if "--serve" in sys.argv[1:]:
        _serve_main()
    else:  # [--config tiny|llama_3_8b] [--steps N] [--batch B] [--seq S] [--device cpu]
        sharding.demo_main(train_demo, CONFIGS, "loss")
