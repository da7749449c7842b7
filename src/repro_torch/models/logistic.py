"""Multinomial logistic regression container (Logistic /
LogisticRegression analogue), the counterpart of
:class:`repro.models.logistic.LogisticModel`.  It holds parameters only:
inference goes through :func:`repro_torch.compile.compile`.  The trainer
arrives with the trainers' slice."""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["LogisticModel"]


@dataclasses.dataclass
class LogisticModel:
    coef: np.ndarray  # (F, C)
    intercept: np.ndarray  # (C,)

    compile_kind = "logistic"  # lowering registry key (repro_torch.compile)
