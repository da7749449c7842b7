"""Seeded synthetic Gaussian-blobs dataset for demos and benchmarks.

A copy of :mod:`repro.models.blobs`: one definition of the
"sensor-traffic stand-in" data shape the serving CLI demo shares — class
means drawn at 4 sigma separation, unit-variance samples, reproducible per
seed, the same rows as the reference's for the same arguments.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["synthetic_blobs"]


def synthetic_blobs(n: int, n_features: int = 16, n_classes: int = 4,
                    seed: int = 0) -> Tuple[np.ndarray, np.ndarray, int]:
    """``(x, y, n_classes)``: n separable rows of float32 blobs data."""
    rng = np.random.RandomState(seed)
    means = rng.randn(n_classes, n_features) * 4.0
    y = rng.randint(0, n_classes, n).astype(np.int32)
    x = (means[y] + rng.randn(n, n_features)).astype(np.float32)
    return x, y, n_classes
