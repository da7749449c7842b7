"""The minibatch loop every classifier trainer of the port shares.

The reference writes this loop into each trainer (``repro/models/*.py``):
per epoch one ``np.random.RandomState(seed).permutation(n)`` drawn from a
single generator, batches of ``batch_size`` rows taken in order, the last
partial batch dropped (``range(0, n - batch_size + 1, batch_size)``), and
one AdamW step per batch on the gradient of the batch loss.  With the same
seed both packages see identical batches, so a model that starts from the
same parameters follows the same trajectory up to summation order.

Here the whole index schedule is drawn on the host first and moved to the
device once; the data and parameters live on the device, and each step
runs there without a host synchronization.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence

import numpy as np
import torch

from repro_torch.compile.api import resolve_device
from repro_torch.compile.lowerings.common import require_full_float32

from .optim import Optimizer, apply_updates, tree_leaves, tree_map

__all__ = ["epoch_batches", "fit", "train_device"]


def train_device(device: Any = None) -> torch.device:
    """The device a trainer runs on: CUDA by default, the host when asked.
    Refuses a process whose float32 matmuls run below full float32."""
    dev = resolve_device(device)
    require_full_float32(dev)
    return dev


def epoch_batches(n: int, batch_size: int, epochs: int,
                  seed: int) -> np.ndarray:
    """(steps, batch_size) int64 row indices, the reference's batches."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(epochs):
        perm = rng.permutation(n)
        out.extend(perm[i:i + batch_size]
                   for i in range(0, n - batch_size + 1, batch_size))
    if not out:
        return np.zeros((0, batch_size), np.int64)
    return np.stack(out).astype(np.int64)


def fit(params: Dict[str, Any], loss_fn: Callable, data: Sequence[torch.Tensor],
        opt: Optimizer, batches: np.ndarray) -> Dict[str, Any]:
    """Run one optimizer step per row of ``batches`` on ``loss_fn(params,
    *(d[idx] for d in data))`` and return the final parameters.  The
    parameters and ``data`` are tensors on one device."""
    device = tree_leaves(params)[0].device
    steps = torch.from_numpy(batches).to(device)
    state = opt.init(params)
    for idx in steps:
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = tree_leaves(live)
        loss = loss_fn(live, *(d[idx] for d in data))
        grads = iter(torch.autograd.grad(loss, leaves))
        with torch.no_grad():
            grad_tree = tree_map(lambda _: next(grads), live)
            updates, state = opt.update(grad_tree, state, params)
            params = apply_updates(params, updates)
    return params
