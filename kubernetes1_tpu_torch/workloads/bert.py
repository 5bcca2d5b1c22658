"""BERT-large-class encoder and its masked-LM train step, in PyTorch.

The port of the JAX package's ``workloads/bert.py`` on one card (BASELINE
config 4 trains it as a Job whose command is ``train_demo()``): the
post-LN bidirectional encoder with learned position embeddings, the MLM
transform head and the decode tied to the token embedding, trained by
AdamW with weight decay 0.01 on f32 master weights in bf16 compute.  The
non-causal attention, LayerNorm, tanh-GELU and the cross-entropy over the
f32 logits run as hand-written CUDA kernels on the card, forward and
backward (``kubernetes1_tpu_torch.kernels``), and so does the AdamW
update (``kubernetes1_tpu_torch.optim``); the matrix products stay
``torch.matmul``, as the JAX package left them to XLA.

Weights keep JAX's ``(d_in, d_out)`` layout and the forward computes
``x @ W``, so weights carried over from the JAX pytree
(``params_from_jax``) need no transpose.  Layers are a list of per-layer
dicts (JAX stacks them on a leading axis for ``lax.scan``).  Under
``cfg.remat`` each layer is one ``torch.utils.checkpoint``, as JAX's
``jax.checkpoint`` with no policy recomputes the whole layer body: the
attention forward runs twice per layer and step.  The train step is data
parallel over a ``DeviceMesh`` (``mesh=``, one process per card: each rank
takes its rows of the global batch, the loss divides by the global batch's
masked count and the gradients are summed); the parameter-sharded step
comes with a later slice.

BERT-large = BertConfig(d_model=1024, n_layers=24, n_heads=16, d_ff=4096,
vocab=30522, max_seq=512).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import optim
from ..kernels import attention as _attention
from ..kernels import cross_entropy as _cross_entropy
from ..kernels import gelu as _gelu
from ..kernels import layernorm as _layernorm
from . import sharding
from .sharding import resolve_device

MASK_TOKEN = 0  # reserved id used by the synthetic MLM batch maker


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab: int = 30522
    d_model: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    d_ff: int = 4096
    max_seq: int = 512
    dtype: torch.dtype = torch.bfloat16  # compute dtype; weights are f32
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def bert_large() -> BertConfig:
    return BertConfig()


def tiny(vocab: int = 256, d_model: int = 64, n_layers: int = 2, n_heads: int = 4,
         d_ff: int = 128, max_seq: int = 64) -> BertConfig:
    return BertConfig(vocab=vocab, d_model=d_model, n_layers=n_layers,
                      n_heads=n_heads, d_ff=d_ff, max_seq=max_seq, remat=False)


# ------------------------------------------------------------------- params

LAYER_KEYS = ("ln1_scale", "ln1_bias", "wq", "wk", "wv", "wo", "ln2_scale", "ln2_bias",
              "w_in", "w_out")
TOP_KEYS = ("embed", "pos_embed", "final_ln_scale", "final_ln_bias", "mlm_dense", "mlm_bias")


def init_params(cfg: BertConfig, generator: torch.Generator) -> Dict[str, Any]:
    """Random f32 weights (the train state's master weights) on
    ``generator``'s device, with the JAX package's distributions:
    normal / sqrt(fan_in) for matrices and embeddings, ones for LayerNorm
    scales, zeros for biases.  (The draws differ from ``jax.random``'s;
    carry JAX weights over with ``params_from_jax`` where the numbers must
    match.)"""
    dev = generator.device
    d = cfg.d_model

    def w(shape, fan_in):
        x = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        return x.div_(math.sqrt(fan_in))

    def full(n, value):
        return torch.full((n,), value, device=dev, dtype=torch.float32)

    return {
        "embed": w((cfg.vocab, d), d),
        "pos_embed": w((cfg.max_seq, d), d),
        "layers": [{
            "ln1_scale": full(d, 1.0), "ln1_bias": full(d, 0.0),
            "wq": w((d, d), d), "wk": w((d, d), d), "wv": w((d, d), d), "wo": w((d, d), d),
            "ln2_scale": full(d, 1.0), "ln2_bias": full(d, 0.0),
            "w_in": w((d, cfg.d_ff), d), "w_out": w((cfg.d_ff, d), cfg.d_ff),
        } for _ in range(cfg.n_layers)],
        "final_ln_scale": full(d, 1.0),
        "final_ln_bias": full(d, 0.0),
        "mlm_dense": w((d, d), d),
        "mlm_bias": full(cfg.vocab, 0.0),
    }


def params_from_jax(tree: Dict[str, Any], cfg: BertConfig,
                    device: torch.device | str) -> Dict[str, Any]:
    """The JAX package's parameter pytree, given as numpy arrays
    (``jax.tree.map(np.asarray, params)``), as this module's parameter
    dict of f32 tensors on ``device``: the stacked leading layer axis is
    split into one dict per layer, and every weight keeps its (d_in,
    d_out) layout."""

    def tensor(a) -> torch.Tensor:
        # a fresh copy: the port must not alias (or write into) JAX's buffers
        arr = np.array(a, dtype=np.float32, order="C")
        return torch.from_numpy(arr).to(device=device)

    layers = tree["layers"]
    if set(layers) != set(LAYER_KEYS):
        raise ValueError(f"layer keys {sorted(layers)} != {sorted(LAYER_KEYS)}")
    n = {np.shape(a)[0] for a in layers.values()}
    if n != {cfg.n_layers}:
        raise ValueError(f"stacked layer axis {n} != n_layers {cfg.n_layers}")
    out = {key: tensor(tree[key]) for key in TOP_KEYS}
    out["layers"] = [{key: tensor(layers[key][i]) for key in LAYER_KEYS}
                     for i in range(cfg.n_layers)]
    return out


def param_leaves(params: Dict[str, Any]) -> List[torch.Tensor]:
    """Every weight, in a fixed order: embed, pos_embed, each layer's
    LAYER_KEYS, final_ln_scale, final_ln_bias, mlm_dense, mlm_bias."""
    return ([params["embed"], params["pos_embed"]]
            + [lp[key] for lp in params["layers"] for key in LAYER_KEYS]
            + [params[key] for key in TOP_KEYS[2:]])


# ------------------------------------------------------------------ modules

class Ops(NamedTuple):
    """The kernel-backed ops of the model and its loss."""

    layernorm: Callable
    attention: Callable  # non-causal: (q, k, v) -> o
    gelu: Callable
    cross_entropy: Callable


# The wrappers: the kernels on CUDA tensors (forward and backward), the
# plain versions on CPU ones.
KERNELS = Ops(_layernorm.layernorm, partial(_attention.attention, causal=False), _gelu.gelu,
              _cross_entropy.cross_entropy)
# The plain versions on every device: the reference a card run compares with.
PLAIN = Ops(_layernorm.layernorm_plain, partial(_attention.attention_plain, causal=False),
            _gelu.gelu_plain, _cross_entropy.cross_entropy_plain)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              ops: Ops = KERNELS) -> torch.Tensor:
    """f32 LayerNorm, eps 1e-6, f32 scale and bias, rounded to x's dtype."""
    return ops.layernorm(x, scale, bias)


def layer_fn(cfg: BertConfig, x: torch.Tensor, lp: Dict[str, torch.Tensor],
             ops: Ops = KERNELS) -> torch.Tensor:
    """Post-LN transformer encoder block (BERT ordering)."""
    B, S, _d = x.shape
    h, hd, dt = cfg.n_heads, cfg.head_dim, cfg.dtype
    q = (x @ lp["wq"].to(dt)).reshape(B, S, h, hd)
    k = (x @ lp["wk"].to(dt)).reshape(B, S, h, hd)
    v = (x @ lp["wv"].to(dt)).reshape(B, S, h, hd)
    attn = ops.attention(q, k, v)  # bidirectional: no causal mask
    attn = attn.reshape(B, S, h * hd) @ lp["wo"].to(dt)
    x = layernorm(x + attn, lp["ln1_scale"], lp["ln1_bias"], ops)
    ff = ops.gelu(x @ lp["w_in"].to(dt)) @ lp["w_out"].to(dt)
    return layernorm(x + ff, lp["ln2_scale"], lp["ln2_bias"], ops)


def forward(cfg: BertConfig, params: Dict[str, Any], tokens: torch.Tensor,
            ops: Ops = KERNELS) -> torch.Tensor:
    """tokens (B, S) integer -> MLM logits (B, S, vocab) float32."""
    _B, S = tokens.shape
    dt = cfg.dtype
    # gather the rows, then cast: the values of casting the whole table first
    x = params["embed"][tokens].to(dt)
    x = x + params["pos_embed"][:S].to(dt)[None, :, :]
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in params["layers"]:
        if remat:  # jax.checkpoint on the layer body: all of it recomputes
            x = checkpoint(layer_fn, cfg, x, lp, ops, use_reentrant=False)
        else:
            x = layer_fn(cfg, x, lp, ops)
    x = layernorm(x, params["final_ln_scale"], params["final_ln_bias"], ops)
    x = ops.gelu(x @ params["mlm_dense"].to(dt))
    # tied decode: the token embedding as the output projection; the f32
    # bias promotes the bf16 product to f32, as in JAX
    return (x @ params["embed"].to(dt).T + params["mlm_bias"]).float()


def mlm_loss_fn(cfg: BertConfig, params: Dict[str, Any], tokens: torch.Tensor,
                mask: torch.Tensor, ops: Ops = KERNELS, mesh=None) -> torch.Tensor:
    """Masked-LM: predict original tokens at masked positions only; a
    0-dim f32 tensor.  ``mask`` (B, S) is 1 where the input was replaced
    by MASK_TOKEN.  The per-row NLL is the cross-entropy op's over the f32
    logits; the mask weighting Σ(nll·mask) / max(Σmask, 1) stays a torch
    op, so its backward hands the op mask / denom per row.

    With ``mesh``, ``tokens`` and ``mask`` are this rank's rows and the
    denominator is the global batch's masked count (JAX's ``mask.sum()``
    over the whole batch): the ranks' losses then sum to the global loss,
    and so do their gradients."""
    masked_in = torch.where(mask == 1, MASK_TOKEN, tokens)
    logits = forward(cfg, params, masked_in, ops)
    nll = ops.cross_entropy(logits.reshape(-1, cfg.vocab), tokens.reshape(-1).to(torch.int64))
    m = mask.reshape(-1).to(torch.float32)
    count = m.sum() if mesh is None else sharding.all_reduce_value(m.sum(), mesh, "sum")
    return (nll * m).sum() / count.clamp_min(1.0)


# --------------------------------------------------------------- train step

def make_train_state(cfg: BertConfig, device: Optional[torch.device | str] = None,
                     lr: float = 1e-4, seed: int = 0,
                     params: Optional[Dict[str, Any]] = None, mesh=None
                     ) -> Tuple[Dict[str, Any], torch.optim.Optimizer]:
    """f32 master weights (random from ``seed``, or ``params``, e.g. from
    ``params_from_jax``) that require grad, and the port's AdamW (K10) over
    all of them: optax's ``adamw(lr, weight_decay=0.01)`` with its defaults, decay on
    every leaf.  ``device`` defaults to the card and raises without one.
    With ``mesh``, every data rank's weights become rank 0's before the
    optimizer is built over them."""
    dev = resolve_device(device)
    if params is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    leaves = param_leaves(params)
    if mesh is not None:
        sharding.broadcast_params(leaves, mesh)
    for p in leaves:
        p.requires_grad_(True)
    return params, optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)


def make_train_step(cfg: BertConfig, params: Dict[str, Any], opt: torch.optim.Optimizer,
                    ops: Ops = KERNELS, mesh=None
                    ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """step(tokens, mask) -> the loss before the update (0-dim, detached):
    one value-and-grad of ``mlm_loss_fn`` and one optimizer update, in
    place.

    With ``mesh``, ``tokens`` and ``mask`` are the global batch: each data
    rank takes its rows, divides by the global masked count (the ranks'
    counts differ), and the gradients and the loss are summed over the
    data ranks before the update."""
    leaves = param_leaves(params)

    def step(tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if mesh is not None:
            tokens, mask = (sharding.shard_batch(t, mesh) for t in (tokens, mask))
        opt.zero_grad(set_to_none=True)
        loss = mlm_loss_fn(cfg, params, tokens, mask, ops, mesh)
        loss.backward()
        if mesh is not None:
            sharding.all_reduce_grads(leaves, mesh, "sum")
            loss = sharding.all_reduce_value(loss, mesh, "sum")
        opt.step()
        return loss.detach()

    return step


def synthetic_batch(cfg: BertConfig, batch: int, seq: int, seed: int = 0,
                    mask_rate: float = 0.15) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tokens, mask), each (batch, seq) on the CPU: tokens int64 in [1,
    vocab) (0 is reserved for MASK_TOKEN), mask int32, 1 at about
    ``mask_rate`` of the positions and at every row's first.  The same
    numpy draws as the JAX package's, so the values are its own."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab, (batch, seq))
    mask = (rng.random((batch, seq)) < mask_rate).astype(np.int32)
    mask[:, 0] = 1  # at least one masked position per row
    return torch.from_numpy(tokens.astype(np.int64)), torch.from_numpy(mask)


def train_demo(cfg: Optional[BertConfig] = None, steps: int = 3, batch: int = 8,
               seq: int = 32, lr: float = 1e-3,
               device: Optional[torch.device | str] = None, mesh=None) -> float:
    """A few MLM steps on one synthetic batch (the step memorizes it);
    returns the final loss.  On the card unless ``device="cpu"``; raises
    when no card is visible.  ``batch`` is the global batch: without
    ``mesh``, a launcher's environment gives ``auto_mesh()`` (one process
    per card), else one device."""
    cfg = cfg or tiny()
    mesh = mesh if mesh is not None else sharding.launched_mesh(resolve_device(device))
    params, opt = make_train_state(cfg, device, lr=lr, mesh=mesh)
    step = make_train_step(cfg, params, opt, mesh=mesh)
    dev = params["embed"].device
    tokens, mask = (t.to(dev) for t in synthetic_batch(cfg, batch, seq))
    loss = None
    for _ in range(steps):
        loss = step(tokens, mask)
    return float(loss)
