"""MLP classifier (MultilayerPerceptron / MLPClassifier analogue).

The counterpart of :mod:`repro.models.mlp`: sigmoid hidden units, linear
output layer, float32 parameters in the :class:`MLPModel` container
(inference goes through :func:`repro_torch.compile.compile`), and the
reference's trainer, :func:`train_mlp`: softmax cross-entropy with AdamW
(weight decay 1e-5) on the reference's batches
(:mod:`repro_torch.train.fit`).

The reference runs with 64-bit JAX, and its initial weights are a float32
normal draw times a float64 Glorot scale, so they are float64 while the
biases stay float32; the forward pass and the loss then run in float64, and
the weights are cast to float32 only on return.  The port keeps those
dtypes.  Its initial weights are drawn from ``numpy.random.RandomState``
(``jax.random`` is not numpy), as :func:`init_mlp` draws them;
:func:`mlp_init_params` and :func:`fit_mlp` split the trainer so that the
loop can start from any initial parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.train.fit import epoch_batches, fit, train_device
from repro_torch.train.optim import adamw

from .logistic import xent

__all__ = ["MLPModel", "init_mlp", "mlp_init_params", "fit_mlp", "train_mlp"]


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


def mlp_init_params(sizes: Sequence[int],
                    seed: int = 0) -> List[Dict[str, np.ndarray]]:
    """The trainer's initial parameters, ``[{"w", "b"}, ...]``: weights a
    float32 normal draw from ``numpy.random.RandomState(seed)`` times the
    float64 Glorot scale (float64, as the reference's), float32 zero
    biases."""
    rng = np.random.RandomState(seed)
    params = []
    for fan_in, fan_out in zip(sizes, sizes[1:]):
        scale = np.sqrt(2.0 / (fan_in + fan_out))
        w = rng.randn(fan_in, fan_out).astype(np.float32) * scale
        params.append({"w": w, "b": np.zeros((fan_out,), np.float32)})
    return params


def _forward(p: List[Dict[str, torch.Tensor]], h: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(p):
        w = layer["w"]
        dt = torch.promote_types(h.dtype, w.dtype)  # JAX's promotion
        h = h.to(dt) @ w.to(dt) + layer["b"]
        if i < len(p) - 1:
            h = torch.sigmoid(h)
    return h


def fit_mlp(params: List[Dict[str, Any]], x: np.ndarray, y: np.ndarray,
            epochs: int = 60, batch_size: int = 256, lr: float = 3e-3,
            seed: int = 0, device: Any = None) -> MLPModel:
    """The trainer's loop from ``params`` (numpy, as
    :func:`mlp_init_params` makes them; their dtypes are kept) on
    ``device`` (the current CUDA device by default, ``"cpu"`` on the
    host)."""
    dev = train_device(device)
    xt = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    yt = torch.as_tensor(np.asarray(y, np.int64), device=dev)
    p = [{k: torch.as_tensor(np.array(v), device=dev)
          for k, v in layer.items()} for layer in params]
    p = fit(p, lambda q, xb, yb: xent(_forward(q, xb), yb), (xt, yt),
            adamw(lr, weight_decay=1e-5),
            epoch_batches(xt.shape[0], batch_size, epochs, seed))
    return MLPModel(
        weights=[l["w"].cpu().numpy().astype(np.float32) for l in p],
        biases=[l["b"].cpu().numpy().astype(np.float32) for l in p])


def train_mlp(x: np.ndarray, y: np.ndarray, n_classes: int,
              hidden: Sequence[int] = (100,), epochs: int = 60,
              batch_size: int = 256, lr: float = 3e-3, seed: int = 0,
              device: Any = None) -> MLPModel:
    sizes = [np.asarray(x).shape[1], *hidden, n_classes]
    return fit_mlp(mlp_init_params(sizes, seed), x, y, epochs=epochs,
                   batch_size=batch_size, lr=lr, seed=seed, device=device)
