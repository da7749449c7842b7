"""Multinomial logistic regression (Logistic / LogisticRegression analogue).

The counterpart of :mod:`repro.models.logistic`: the
:class:`LogisticModel` container (inference goes through
:func:`repro_torch.compile.compile`) and :func:`train_logistic`, the
reference's trainer: zero-initialised float32 weights, softmax
cross-entropy, AdamW with the L2 weight as decoupled weight decay, on the
reference's batches (:mod:`repro_torch.train.fit`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.train.fit import epoch_batches, fit, train_device
from repro_torch.train.optim import adamw

__all__ = ["LogisticModel", "train_logistic"]


@dataclasses.dataclass
class LogisticModel:
    coef: np.ndarray  # (F, C)
    intercept: np.ndarray  # (C,)

    compile_kind = "logistic"  # lowering registry key (repro_torch.compile)


def xent(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy of integer labels ``y``."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, 1, y[:, None]))


def train_logistic(x: np.ndarray, y: np.ndarray, n_classes: int,
                   epochs: int = 80, batch_size: int = 512, lr: float = 5e-3,
                   l2: float = 1e-4, seed: int = 0,
                   device: Any = None) -> LogisticModel:
    """Train on ``device`` (the current CUDA device by default, ``"cpu"``
    on the host); the model's arrays come back on the host."""
    dev = train_device(device)
    xt = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    yt = torch.as_tensor(np.asarray(y, np.int64), device=dev)
    params = {"w": torch.zeros((xt.shape[1], n_classes), dtype=torch.float32,
                               device=dev),
              "b": torch.zeros((n_classes,), dtype=torch.float32, device=dev)}

    def loss_fn(p, xb, yb):
        return xent(xb @ p["w"] + p["b"], yb)

    params = fit(params, loss_fn, (xt, yt), adamw(lr, weight_decay=l2),
                 epoch_batches(xt.shape[0], batch_size, epochs, seed))
    return LogisticModel(params["w"].cpu().numpy(), params["b"].cpu().numpy())
