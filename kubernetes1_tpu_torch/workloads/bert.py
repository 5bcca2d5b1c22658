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
attention forward runs twice per layer and step.  The train step runs
over a ``DeviceMesh`` (``mesh=``, one process per card) with JAX's
placement (``param_specs``): each rank holds its block of every leaf, the
data ranks take their rows of the global batch (the loss divides by the
global batch's masked count and the gradients are summed), a layer
gathers its fsdp blocks inside remat's checkpoint, and over tp the layer
works on its heads and its columns of d_ff; the head's transform is split
by column and gathered over tp after its GELU (the tied decode needs the
whole d), and the decode reads this rank's vocab block of ``embed`` into
K5's vocab-parallel form, with ``mlm_bias``'s slice of that block.

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
# JAX's PartitionSpecs (kubernetes1_tpu/workloads/bert.py:60-79) without the
# stacked layer axis.
LAYER_SPECS = {
    "ln1_scale": (None,), "ln1_bias": (None,),
    "wq": ("fsdp", "tp"), "wk": ("fsdp", "tp"), "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    "ln2_scale": (None,), "ln2_bias": (None,),
    "w_in": ("fsdp", "tp"),      # (d, f)
    "w_out": ("tp", "fsdp"),     # (f, d)
}
TOP_SPECS = {
    "embed": ("tp", "fsdp"),        # (vocab, d)
    "pos_embed": (None, "fsdp"),    # (max_seq, d)
    "final_ln_scale": (None,), "final_ln_bias": (None,),
    "mlm_dense": ("fsdp", "tp"),    # (d, d) transform head
    "mlm_bias": (None,),            # (vocab,) decode bias
}


def param_specs(cfg: BertConfig) -> Dict[str, Any]:
    """Each leaf's placement over a ``("dp", "fsdp", "tp")`` mesh, JAX's
    ``param_specs`` leaf for leaf (``sharding.Spec``); "layers" is the one
    spec dict of every layer."""
    return {**TOP_SPECS, "layers": dict(LAYER_SPECS)}


def leaf_shapes(cfg: BertConfig):
    """Every leaf of ``init_params`` in its draw order: (path, whole shape,
    fan_in), the path ("embed",) or ("layers", i, key); fan_in None for a
    LayerNorm scale (ones) or a bias (zeros)."""
    d = cfg.d_model
    layer = {"ln1_scale": ((d,), None), "ln1_bias": ((d,), None), "wq": ((d, d), d),
             "wk": ((d, d), d), "wv": ((d, d), d), "wo": ((d, d), d),
             "ln2_scale": ((d,), None), "ln2_bias": ((d,), None),
             "w_in": ((d, cfg.d_ff), d), "w_out": ((cfg.d_ff, d), cfg.d_ff)}
    yield ("embed",), (cfg.vocab, d), d
    yield ("pos_embed",), (cfg.max_seq, d), d
    for i in range(cfg.n_layers):
        for key in LAYER_KEYS:
            yield ("layers", i, key), *layer[key]
    yield ("final_ln_scale",), (d,), None
    yield ("final_ln_bias",), (d,), None
    yield ("mlm_dense",), (d, d), d
    yield ("mlm_bias",), (cfg.vocab,), None


def init_leaves(cfg: BertConfig, generator: torch.Generator):
    """``init_params``'s leaves one at a time, in its draw order: (path,
    tensor)."""
    dev = generator.device
    for path, shape, fan_in in leaf_shapes(cfg):
        if fan_in is None:
            value = 1.0 if path[-1].endswith("scale") else 0.0
            yield path, torch.full(shape, value, device=dev, dtype=torch.float32)
        else:
            x = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
            yield path, x.div_(math.sqrt(fan_in))


def init_params(cfg: BertConfig, generator: torch.Generator) -> Dict[str, Any]:
    """Random f32 weights (the train state's master weights) on
    ``generator``'s device, with the JAX package's distributions:
    normal / sqrt(fan_in) for matrices and embeddings, ones for LayerNorm
    scales, zeros for biases.  (The draws differ from ``jax.random``'s;
    carry JAX weights over with ``params_from_jax`` where the numbers must
    match.)"""
    return sharding.tree_from_leaves(init_leaves(cfg, generator), cfg.n_layers)


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
    # over a vocab block: (logits, targets, v0, tp group) -> per-row loss
    cross_entropy_vp: Callable = _cross_entropy.cross_entropy_vocab_parallel


# The wrappers: the kernels on CUDA tensors (forward and backward), the
# plain versions on CPU ones.
KERNELS = Ops(_layernorm.layernorm, partial(_attention.attention, causal=False), _gelu.gelu,
              _cross_entropy.cross_entropy)
# The plain versions on every device: the reference a card run compares with.
PLAIN = Ops(_layernorm.layernorm_plain, partial(_attention.attention_plain, causal=False),
            _gelu.gelu_plain, _cross_entropy.cross_entropy_plain,
            _cross_entropy.cross_entropy_vocab_parallel_plain)
# No mesh: every leaf whole, no collective.
WHOLE = sharding.Layout()


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              ops: Ops = KERNELS) -> torch.Tensor:
    """f32 LayerNorm, eps 1e-6, f32 scale and bias, rounded to x's dtype."""
    return ops.layernorm(x, scale, bias)


def layer_fn(cfg: BertConfig, x: torch.Tensor, lp: Dict[str, torch.Tensor],
             ops: Ops = KERNELS, lay: sharding.Layout = WHOLE) -> torch.Tensor:
    """Post-LN transformer encoder block (BERT ordering); over tp, this
    rank's heads and columns of d_ff, the projections' partial sums added
    across the ranks."""
    B, S, _d = x.shape
    hd, dt = cfg.head_dim, cfg.dtype

    def w(key):
        return lay.full(lp[key].to(dt), LAYER_SPECS[key])

    xc = lay.copy(x)
    q = (xc @ w("wq")).reshape(B, S, -1, hd)
    k = (xc @ w("wk")).reshape(B, S, -1, hd)
    v = (xc @ w("wv")).reshape(B, S, -1, hd)
    attn = ops.attention(q, k, v)  # bidirectional: no causal mask
    attn = lay.reduce(attn.reshape(B, S, -1) @ w("wo"))
    x = layernorm(x + attn, lp["ln1_scale"], lp["ln1_bias"], ops)
    ff = lay.reduce(ops.gelu(lay.copy(x) @ w("w_in")) @ w("w_out"))
    return layernorm(x + ff, lp["ln2_scale"], lp["ln2_bias"], ops)


def forward(cfg: BertConfig, params: Dict[str, Any], tokens: torch.Tensor,
            ops: Ops = KERNELS, lay: sharding.Layout = WHOLE) -> torch.Tensor:
    """tokens (B, S) integer -> MLM logits (B, S, vocab) float32; over tp,
    the logits of this rank's vocab block (B, S, vocab / tp)."""
    _B, S = tokens.shape
    dt = cfg.dtype
    # this rank's vocab block, its d gathered over fsdp for the tied decode
    embed = lay.full(params["embed"].to(dt), TOP_SPECS["embed"])
    # the rows from the f32 block where its d is whole here (their gradient
    # adds in f32, as without a mesh), else from the gathered copy; gather the
    # rows, then cast: the values of casting the whole table first
    table = params["embed"] if lay.fsdp == 1 else embed
    x = lay.lookup(table, tokens, ("tp", None), dt)
    x = x + lay.full(params["pos_embed"][:S].to(dt), TOP_SPECS["pos_embed"])[None, :, :]
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in params["layers"]:
        if remat:  # jax.checkpoint on the layer body: all of it recomputes
            x = checkpoint(layer_fn, cfg, x, lp, ops, lay, use_reentrant=False)
        else:
            x = layer_fn(cfg, x, lp, ops, lay)
    x = layernorm(x, params["final_ln_scale"], params["final_ln_bias"], ops)
    x = ops.gelu(lay.copy(x) @ lay.full(params["mlm_dense"].to(dt), TOP_SPECS["mlm_dense"]))
    x = lay.copy(lay.gather_last(x))  # the tied decode needs the whole d
    bias = params["mlm_bias"]
    if lay.tp > 1:  # this rank's vocab block of the replicated bias
        bias = lay.copy(bias).narrow(0, lay.vocab_start(embed.shape[0]), embed.shape[0])
    # tied decode: the token embedding as the output projection; the f32
    # bias promotes the bf16 product to f32, as in JAX
    return (x @ embed.T + bias).float()


def mlm_loss_fn(cfg: BertConfig, params: Dict[str, Any], tokens: torch.Tensor,
                mask: torch.Tensor, ops: Ops = KERNELS, mesh=None,
                lay: sharding.Layout = WHOLE) -> torch.Tensor:
    """Masked-LM: predict original tokens at masked positions only; a
    0-dim f32 tensor.  ``mask`` (B, S) is 1 where the input was replaced
    by MASK_TOKEN.  The per-row NLL is the cross-entropy op's over the f32
    logits; the mask weighting Σ(nll·mask) / max(Σmask, 1) stays a torch
    op, so its backward hands the op mask / denom per row.

    With ``mesh``, ``tokens`` and ``mask`` are this rank's rows and the
    denominator is the global batch's masked count (JAX's ``mask.sum()``
    over the whole batch): the ranks' losses then sum to the global loss,
    and so do their gradients.  Over tp (``lay``), the per-row NLL is
    K5's vocab-parallel form over this rank's block of the logits."""
    masked_in = torch.where(mask == 1, MASK_TOKEN, tokens)
    logits = forward(cfg, params, masked_in, ops, lay)
    # a fresh tensor: the kernels take 16-byte aligned inputs, and a data
    # rank's rows of the batch need not start at one
    targets = tokens.reshape(-1).to(torch.int64).clone()
    if lay.tp == 1:
        nll = ops.cross_entropy(logits.reshape(-1, cfg.vocab), targets)
    else:
        block = logits.shape[-1]
        nll = ops.cross_entropy_vp(logits.reshape(-1, block), targets, lay.vocab_start(block),
                                   lay.tp_group)
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

    With ``mesh``, each rank keeps its block of every leaf by
    ``param_specs`` (``sharding.shard_params``), and the optimizer's state
    is of those blocks.  From the seed, every rank draws the whole leaves
    one at a time and keeps its block of each; given ``params`` must be
    the same on every rank, and the dict's entries are replaced by the
    blocks (it is the returned dict)."""
    dev = resolve_device(device)
    specs = param_specs(cfg)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = sharding.tree_from_leaves(
            ((path, sharding.shard_tensor(t, sharding.spec_of(specs, path), mesh))
             for path, t in init_leaves(cfg, gen)), cfg.n_layers)
    elif mesh is not None:
        params.update(sharding.shard_params(params, specs, mesh))
    leaves = param_leaves(params)
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
    counts differ), and the gradients (``sharding.reduce_grads``: an
    fsdp-sharded leaf's summed over fsdp by its gather) and the loss are
    summed over the data ranks before the update.  ``params`` are this
    rank's blocks (``make_train_state`` with the mesh): raises ValueError
    where a leaf is not."""
    leaves = param_leaves(params)
    specs = sharding.spec_leaves(param_specs(cfg), cfg.n_layers, param_leaves)
    if mesh is not None:
        sharding.check_blocks(leaves, sharding.whole_shapes(leaf_shapes(cfg), cfg.n_layers,
                                                            param_leaves),
                              specs, mesh, "bert.make_train_step")
    lay = WHOLE if mesh is None else sharding.Layout(mesh, "sum")

    def step(tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if mesh is not None:
            tokens, mask = (sharding.shard_batch(t, mesh) for t in (tokens, mask))
        opt.zero_grad(set_to_none=True)
        loss = mlm_loss_fn(cfg, params, tokens, mask, ops, mesh, lay)
        loss.backward()
        if mesh is not None:
            sharding.reduce_grads(leaves, specs, mesh, "sum")
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


CONFIGS = {"tiny": tiny, "bert_large": bert_large}


def main(argv=None):
    """``python -m kubernetes1_tpu_torch.workloads.bert [--config tiny|bert_large]
    [--steps N] [--batch B] [--seq S] [--device cpu]``: ``train_demo``,
    rank 0 printing ``mlm-loss <x>`` (``sharding.demo_main``)."""
    sharding.demo_main(train_demo, CONFIGS, "mlm-loss", argv)


if __name__ == "__main__":
    main()
