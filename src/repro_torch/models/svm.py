"""SVM classifier container: linear and kernelized (poly / RBF).

The counterpart of :class:`repro.models.svm.SVMModel`, with the reference's
serving semantics (libsvm-style artifacts, what EmbML converts):

* linear:  ``argmax_c  x @ coef[:, c] + b[c]``
* kernel:  ``argmax_c  sum_m alpha[m, c] * K(x, sv_m) + b[c]`` with
  ``K`` ∈ {poly(gamma, coef0, degree), rbf(gamma)} over stored support
  vectors.

It holds parameters only: inference goes through
:func:`repro_torch.compile.compile`.  The trainers are the reference's:
one-vs-rest squared-hinge minimization with AdamW on the reference's
batches (:mod:`repro_torch.train.fit`), from zero parameters.  The kernel
machine learns dual coefficients over a class-stratified prototype set
(:func:`_pick_prototypes`, numpy, copied) and trains in float64 (the
paper's §V-A point: serving a double-precision model in single precision
or fixed point costs poly-SVC accuracy), with the optimizer's float32
moments.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.train.fit import epoch_batches, fit, train_device
from repro_torch.train.optim import adamw

__all__ = ["SVMModel", "train_linear_svm", "train_kernel_svm"]


@dataclasses.dataclass
class SVMModel:
    kernel: str  # 'linear' | 'poly' | 'rbf'
    coef: Optional[np.ndarray] = None  # linear: (F, C)
    intercept: Optional[np.ndarray] = None  # (C,)
    support_vectors: Optional[np.ndarray] = None  # kernel: (M, F)
    dual_coef: Optional[np.ndarray] = None  # kernel: (M, C)
    gamma: float = 1.0
    coef0: float = 0.0
    degree: int = 2
    dtype: str = "float64"  # training precision of the artifact

    @property
    def compile_kind(self) -> str:  # lowering registry key (repro_torch.compile)
        return f"svm-{self.kernel}"


def _pick_prototypes(x: np.ndarray, y: np.ndarray, n_classes: int, m: int,
                     seed: int) -> np.ndarray:
    """Class-stratified prototype ('support vector') selection."""
    rng = np.random.RandomState(seed)
    per = max(1, m // n_classes)
    chosen = []
    for c in range(n_classes):
        idx = np.where(y == c)[0]
        take = min(per, idx.size)
        chosen.append(rng.choice(idx, take, replace=False))
    return x[np.concatenate(chosen)]


def _ovr_targets(y: np.ndarray, n_classes: int) -> np.ndarray:
    t = -np.ones((y.shape[0], n_classes), np.float32)
    t[np.arange(y.shape[0]), y] = 1.0
    return t


def _sq_hinge(scores: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.clamp(1.0 - t * scores, min=0.0) ** 2)


def train_linear_svm(x: np.ndarray, y: np.ndarray, n_classes: int,
                     epochs: int = 60, batch_size: int = 512, lr: float = 3e-3,
                     l2: float = 1e-4, seed: int = 0,
                     device: Any = None) -> SVMModel:
    """Train on ``device`` (the current CUDA device by default, ``"cpu"``
    on the host); float32, as the reference's."""
    dev = train_device(device)
    xt = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    tt = torch.as_tensor(_ovr_targets(np.asarray(y), n_classes), device=dev)
    params = {"w": torch.zeros((xt.shape[1], n_classes), dtype=torch.float32,
                               device=dev),
              "b": torch.zeros((n_classes,), dtype=torch.float32, device=dev)}

    def loss_fn(p, xb, tb):
        return _sq_hinge(xb @ p["w"] + p["b"], tb)

    params = fit(params, loss_fn, (xt, tt), adamw(lr, weight_decay=l2),
                 epoch_batches(xt.shape[0], batch_size, epochs, seed))
    return SVMModel("linear", coef=params["w"].cpu().numpy(),
                    intercept=params["b"].cpu().numpy(), dtype="float32")


def train_kernel_svm(x: np.ndarray, y: np.ndarray, n_classes: int,
                     kernel: str = "rbf", gamma: Optional[float] = None,
                     coef0: float = 1.0, degree: int = 2, n_prototypes: int = 400,
                     epochs: int = 60, batch_size: int = 512, lr: float = 3e-3,
                     l2: float = 1e-4, seed: int = 0,
                     device: Any = None) -> SVMModel:
    """Train on ``device`` (the current CUDA device by default, ``"cpu"``
    on the host), in float64."""
    dev = train_device(device)
    x64 = np.asarray(x, np.float64)
    y = np.asarray(y, np.int32)
    if gamma is None:
        gamma = 1.0 / (x.shape[1] * max(x64.var(), 1e-12))  # sklearn 'scale'
    sv = _pick_prototypes(x64, y, n_classes, n_prototypes, seed)
    svt = torch.as_tensor(sv, device=dev)
    sv_sq = torch.sum(svt * svt, -1)[None, :]
    xt = torch.as_tensor(x64, device=dev)
    tt = torch.as_tensor(_ovr_targets(y, n_classes), device=dev).to(
        torch.float64)

    def kmap(xb):
        if kernel == "poly":
            return (gamma * (xb @ svt.T) + coef0) ** degree
        d2 = torch.sum(xb * xb, -1, keepdim=True) - 2 * xb @ svt.T + sv_sq
        return torch.exp(-gamma * d2)

    params = {"a": torch.zeros((sv.shape[0], n_classes), dtype=torch.float64,
                               device=dev),
              "b": torch.zeros((n_classes,), dtype=torch.float64, device=dev)}

    def loss_fn(p, xb, tb):
        return _sq_hinge(kmap(xb) @ p["a"] + p["b"], tb)

    params = fit(params, loss_fn, (xt, tt), adamw(lr, weight_decay=l2),
                 epoch_batches(x64.shape[0], batch_size, epochs, seed))
    return SVMModel(kernel, support_vectors=sv,
                    dual_coef=params["a"].cpu().numpy(),
                    intercept=params["b"].cpu().numpy(),
                    gamma=float(gamma), coef0=coef0, degree=degree,
                    dtype="float64")
