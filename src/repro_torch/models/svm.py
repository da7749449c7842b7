"""SVM classifier container: linear and kernelized (poly / RBF).

The counterpart of :class:`repro.models.svm.SVMModel`, with the reference's
serving semantics (libsvm-style artifacts, what EmbML converts):

* linear:  ``argmax_c  x @ coef[:, c] + b[c]``
* kernel:  ``argmax_c  sum_m alpha[m, c] * K(x, sv_m) + b[c]`` with
  ``K`` ∈ {poly(gamma, coef0, degree), rbf(gamma)} over stored support
  vectors.

It holds parameters only: inference goes through
:func:`repro_torch.compile.compile`.  The Adam trainers arrive with the
trainers' slice; :func:`_pick_prototypes` (numpy) is the reference's
class-stratified support-set selection, copied.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["SVMModel"]


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
