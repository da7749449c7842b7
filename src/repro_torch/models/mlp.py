"""MLP classifier container (MultilayerPerceptron / MLPClassifier analogue).

The counterpart of :class:`repro.models.mlp.MLPModel`: sigmoid hidden
units, linear output layer, float32 parameters.  It holds parameters
only: inference goes through :func:`repro_torch.compile.compile`.  The
trainer arrives with the trainers' slice; :func:`init_mlp` makes a seeded untrained model with
the reference trainer's Glorot initialisation scale.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["MLPModel", "init_mlp"]


@dataclasses.dataclass
class MLPModel:
    weights: List[np.ndarray]  # per layer (in, out)
    biases: List[np.ndarray]  # per layer (out,)
    hidden_activation: str = "sigmoid"

    compile_kind = "mlp"  # lowering registry key (repro_torch.compile)

    @property
    def layer_sizes(self) -> Tuple[int, ...]:
        return tuple([self.weights[0].shape[0]] + [w.shape[1] for w in self.weights])


def init_mlp(sizes: Sequence[int], seed: int = 0) -> MLPModel:
    """Untrained MLP of layer ``sizes`` [in, hidden..., out]: weights normal
    with the Glorot scale sqrt(2 / (fan_in + fan_out)), zero biases, drawn
    from ``numpy.random.RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    weights, biases = [], []
    for fan_in, fan_out in zip(sizes, sizes[1:]):
        scale = np.sqrt(2.0 / (fan_in + fan_out))
        weights.append((rng.randn(fan_in, fan_out) * scale).astype(np.float32))
        biases.append(np.zeros((fan_out,), np.float32))
    return MLPModel(weights=weights, biases=biases)
