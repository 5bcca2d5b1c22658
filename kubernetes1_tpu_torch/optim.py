"""The optimizers of the port's train steps, each one multi-tensor kernel
launch a step on the card: ``AdamW`` (K10), ``Adafactor`` (K10b) and
``SGD`` with momentum (K10c), the counterparts of ``optax.adamw``,
``optax.adafactor`` and ``optax.sgd(lr, momentum)``.

Each is a ``torch.optim.Optimizer``.  It allocates its state and builds
its leaf table (``kernels.optim.LeafTable``) once, at construction;
``step()`` hands the table this step's gradients (they live at new
addresses after ``zero_grad(set_to_none=True)``) and runs the update:
the kernel on the card, the plain version (optax's formula) on the CPU.
AdamW's and Adafactor's step count is a 0-dim int32 tensor on the
parameters' device (``count``, optax's), advanced by the update itself.

The table holds the state tensors it was built with.  ``step()`` raises,
naming the leaf, when ``self.state`` no longer holds them (a
``load_state_dict`` of copies puts new tensors there) or a parameter's
storage moved (``p.data = ...``): build a new optimizer after either.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import torch

from .kernels import optim as _optim


class _TableOptimizer(torch.optim.Optimizer):
    """The shared part: every parameter f32, contiguous and on one device,
    one set of hyperparameters (the first group's), a leaf table over the
    parameters and their state, and a step that refreshes the table's
    gradients and runs ``_update``."""

    table: _optim.LeafTable

    def _leaves(self) -> List[torch.Tensor]:
        return [p for group in self.param_groups for p in group["params"]]

    def _check_params(self) -> Tuple[List[torch.Tensor], torch.device]:
        leaves = self._leaves()
        dev = leaves[0].device
        for i, p in enumerate(leaves):
            if p.dtype != torch.float32 or not p.is_contiguous() or p.device != dev:
                raise ValueError(f"{type(self).__name__}: parameter {i} must be a contiguous f32 "
                                 f"tensor on {dev}, got {p.dtype} on {p.device}")
        return leaves, dev

    def _update(self, hyper: dict):
        raise NotImplementedError

    def _check_state(self):
        for i, (p, leaf) in enumerate(zip(self._leaves(), self.table.leaves)):
            held = tuple(self.state.get(p, {}).values())
            if len(held) != len(leaf.states) or any(a is not b
                                                    for a, b in zip(held, leaf.states)):
                raise ValueError(f"{type(self).__name__}: the state of {self.table.label(i)} "
                                 f"is no longer the tensors its table was built with "
                                 f"(load_state_dict?); build a new optimizer")

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self._check_state()
        self.table.set_grads([p.grad for p in self._leaves()])
        self._update(self.param_groups[0])
        return loss


class AdamW(_TableOptimizer):
    """optax.adamw(lr, b1, b2, eps, weight_decay): decoupled weight decay on
    every leaf, bias correction by the step count.  State per parameter:
    ``exp_avg`` (m) and ``exp_avg_sq`` (v)."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-4):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))
        if len(self.param_groups) != 1:
            raise ValueError("AdamW: one parameter group")
        leaves, dev = self._check_params()
        for p in leaves:
            self.state[p] = {"exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.table = _optim.LeafTable([
            _optim.Leaf(p, (self.state[p]["exp_avg"], self.state[p]["exp_avg_sq"]),
                        name=f"parameter {i}")
            for i, p in enumerate(leaves)])

    def _update(self, hyper: dict):
        _optim.adamw(self.table, self.count, hyper["lr"], *hyper["betas"], hyper["eps"],
                     hyper["weight_decay"])


class SGD(_TableOptimizer):
    """optax.sgd(lr, momentum): the trace t = g + momentum t starts at 0,
    p = p - lr t.  State per parameter: ``momentum_buffer``."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float, momentum: float = 0.9):
        super().__init__(params, dict(lr=lr, momentum=momentum))
        if len(self.param_groups) != 1:
            raise ValueError("SGD: one parameter group")
        leaves, _dev = self._check_params()
        for p in leaves:
            self.state[p] = {"momentum_buffer": torch.zeros_like(p)}
        self.table = _optim.LeafTable([_optim.Leaf(p, (self.state[p]["momentum_buffer"],),
                                                   name=f"parameter {i}")
                                       for i, p in enumerate(leaves)])

    def _update(self, hyper: dict):
        _optim.sgdm(self.table, hyper["lr"], hyper["momentum"])


class Adafactor(_TableOptimizer):
    """optax.adafactor(lr) with optax's defaults (``kernels.optim``'s
    constants: factored second moments from two dims of 128, decay
    1 - t^-0.8, the update clipped to block RMS 1 and scaled by
    max(rms(p), 1e-3); no momentum, no weight decay).

    ``groups`` are the JAX pytree's leaves as (name, tensors): one tensor,
    or the L per-layer tensors of a leaf that JAX stacks on a leading
    axis (``workloads.llama.leaf_groups``).  optax computes the factored
    dims, the clipping RMS and the parameter RMS on the stacked array, so
    each group is one parameter group here: one clip and one scale for all
    its layers, the factored dims from ``np.argsort`` of the stacked shape
    (L, *shape).  (A stack of one layer factors as the layer alone does.)
    State per parameter: ``v`` or, factored, ``v_row`` and ``v_col`` (that
    layer's slice of the stacked state)."""

    def __init__(self, groups: Sequence[Tuple[str, Sequence[torch.Tensor]]], lr: float):
        super().__init__([{"params": list(tensors), "name": name} for name, tensors in groups],
                         dict(lr=lr))
        _leaves, dev = self._check_params()
        table = []
        for gi, group in enumerate(self.param_groups):
            tensors = group["params"]
            shape = tuple(tensors[0].shape)
            if any(tuple(t.shape) != shape for t in tensors):
                raise ValueError(f"Adafactor: group {group['name']!r} mixes shapes")
            stacked = len(tensors) > 1
            dims = _optim.factored_dims((len(tensors),) + shape if stacked else shape)
            if dims is not None:
                d1, d0 = (d - 1 for d in dims) if stacked else dims
                if min(d1, d0) < 0 or len(shape) != 2:
                    raise ValueError(f"Adafactor: group {group['name']!r} {shape} x "
                                     f"{len(tensors)} would factor over its layer axis, or is "
                                     f"not a stack of matrices")
            for k, p in enumerate(tensors):
                name = f"{group['name']}[{k}]"
                if dims is None:
                    self.state[p] = {"v": torch.zeros_like(p)}
                    table.append(_optim.Leaf(p, (self.state[p]["v"],), gi, name=name))
                    continue
                # v_row drops d0 (averages over it), v_col drops d1
                self.state[p] = {"v_row": p.new_zeros(shape[d1]),
                                 "v_col": p.new_zeros(shape[d0])}
                mode = _optim.FACTORED_COLS if d0 == 1 else _optim.FACTORED_ROWS
                table.append(_optim.Leaf(p, (self.state[p]["v_row"], self.state[p]["v_col"]),
                                         gi, mode, name))
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.table = _optim.LeafTable(table, adafactor=True)

    def _update(self, hyper: dict):
        _optim.adafactor(self.table, self.count, hyper["lr"])
