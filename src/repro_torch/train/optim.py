"""Minimal functional optimizers, with the reference's arithmetic.

The counterpart of :mod:`repro.train.optim`.  The API mirrors optax, as the
reference's does: ``init(params) -> state``, ``update(grads, state, params)
-> (updates, state)``, then :func:`apply_updates`.  Parameters, gradients
and state are pytrees (nested dicts, lists and tuples) of torch tensors on
any device; every function here computes with tensors on that device.

:func:`adamw` is not ``torch.optim.AdamW``: it keeps the reference's
numbers.  ``b2 = 0.95`` and ``eps = 1e-8`` by default; the moments are
float32 whatever the parameters' dtype (float64 parameters too); the
gradient is cast to float32; the bias corrections are ``1 - b ** step`` in
float32; and the update ``-lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)`` is
computed in float32 and cast to the parameter's dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

__all__ = ["OptState", "Optimizer", "adamw", "sgd", "clip_by_global_norm",
           "apply_updates", "global_norm", "tree_map", "tree_leaves"]

LR = Union[float, Callable[[torch.Tensor], torch.Tensor]]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the same-shaped ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: Any  # first moment (adamw) or momentum buffer (sgd)
    nu: Any  # second moment (adamw) or None


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], OptState]
    update: Callable[..., tuple]


def _lr_fn(lr: LR) -> Callable[[torch.Tensor], torch.Tensor]:
    if callable(lr):
        return lr
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def _first_device(tree: Any) -> torch.device:
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def global_norm(tree: Any) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                          for l in leaves))


def clip_by_global_norm(tree: Any, max_norm: float) -> tuple:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), tree), norm


def adamw(lr: LR, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0,
          mu_dtype: Optional[torch.dtype] = None) -> Optimizer:
    """AdamW with decoupled weight decay and float32 moments by default."""
    lr_fn = _lr_fn(lr)

    def init(params):
        mu = tree_map(lambda p: torch.zeros_like(
            p, dtype=mu_dtype or torch.float32), params)
        nu = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                      params)
        return OptState(torch.zeros((), dtype=torch.int32,
                                    device=_first_device(params)), mu, nu)

    def update(grads, state: OptState, params):
        step = state.step + 1
        lr_t = lr_fn(step)
        s32 = step.to(torch.float32)
        b1c = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                           device=s32.device), s32)
        b2c = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                           device=s32.device), s32)

        mu = tree_map(lambda g, m: b1 * m + (1 - b1) * g.to(torch.float32),
                      grads, state.mu)
        nu = tree_map(lambda g, v: b2 * v + (1 - b2) * torch.square(
            g.to(torch.float32)), grads, state.nu)

        def upd(m, v, p):
            mhat = m / b1c
            vhat = v / b2c
            u = -lr_t * (mhat / (torch.sqrt(vhat) + eps)
                         + weight_decay * p.to(torch.float32))
            return u.to(p.dtype)

        return tree_map(upd, mu, nu, params), OptState(step, mu, nu)

    return Optimizer(init, update)


def _scaled(lr_t: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``-lr_t * g`` at the promoted dtype of the two (JAX's rule for a
    float32 array times ``g``; torch would keep a bfloat16 ``g``'s dtype)."""
    dt = torch.promote_types(lr_t.dtype, g.dtype)
    return -lr_t.to(dt) * g.to(dt)


def sgd(lr: LR, momentum: float = 0.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        mu = (tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params) if momentum else None)
        return OptState(torch.zeros((), dtype=torch.int32,
                                    device=_first_device(params)), mu, None)

    def update(grads, state: OptState, params):
        step = state.step + 1
        lr_t = lr_fn(step)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g.to(torch.float32),
                          state.mu, grads)
            updates = tree_map(lambda m, p: _scaled(lr_t, m).to(p.dtype),
                               mu, params)
        else:
            mu = None
            updates = tree_map(lambda g, p: _scaled(lr_t, g).to(p.dtype),
                               grads, params)
        return updates, OptState(step, mu, None)

    return Optimizer(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)
