"""Carry a model across from the reference package.

:func:`model_from_params` takes the parameter dict that the reference
lowering extracts (``repro.compile.get_lowering(kind).extract_params(model)``,
numpy arrays only) and returns the port's model container, so both packages
compile the same program from the same parameters.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from repro_torch.models import LogisticModel, MLPModel

__all__ = ["model_from_params"]


def model_from_params(kind: str, params: Dict[str, Any]):
    """The port's model of ``kind`` (``mlp`` or ``logistic``) from extracted
    numpy parameters."""
    if kind == "mlp":
        return MLPModel(weights=[np.asarray(w) for w in params["weights"]],
                        biases=[np.asarray(b) for b in params["biases"]])
    if kind == "logistic":
        return LogisticModel(coef=np.asarray(params["coef"]),
                             intercept=np.asarray(params["intercept"]))
    raise KeyError(f"no port of the '{kind}' model yet (have: mlp, logistic)")
