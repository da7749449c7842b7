"""Carry a model across from the reference package.

:func:`model_from_params` takes the parameter dict that the reference
lowering extracts (``repro.compile.get_lowering(kind).extract_params(model)``,
numpy arrays and scalars only) and returns the port's model container, so
both packages compile the same program from the same parameters.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from repro_torch.core.trees import TreeArrays
from repro_torch.models import (DecisionTreeModel, LogisticModel, MLPModel,
                                SVMModel)

__all__ = ["model_from_params", "KINDS"]

KINDS = ("mlp", "logistic", "tree", "svm-linear", "svm-poly", "svm-rbf")


def model_from_params(kind: str, params: Dict[str, Any]):
    """The port's model of ``kind`` (one of :data:`KINDS`) from extracted
    numpy parameters."""
    if kind == "mlp":
        return MLPModel(weights=[np.asarray(w) for w in params["weights"]],
                        biases=[np.asarray(b) for b in params["biases"]])
    if kind == "logistic":
        return LogisticModel(coef=np.asarray(params["coef"]),
                             intercept=np.asarray(params["intercept"]))
    if kind == "tree":
        return DecisionTreeModel(TreeArrays(
            feature=np.asarray(params["feature"], np.int32),
            threshold=np.asarray(params["threshold"], np.float32),
            left=np.asarray(params["left"], np.int32),
            right=np.asarray(params["right"], np.int32),
            leaf_class=np.asarray(params["leaf_class"], np.int32),
            max_depth=int(params["max_depth"]),
            n_classes=int(params["n_classes"]),
            n_features=int(params["n_features"])))
    if kind == "svm-linear":
        return SVMModel("linear", coef=np.asarray(params["coef"]),
                        intercept=np.asarray(params["intercept"]),
                        dtype="float32")
    if kind in ("svm-poly", "svm-rbf"):
        if params["kernel"] != kind[len("svm-"):]:
            raise ValueError(f"params of a '{params['kernel']}' kernel "
                             f"given as '{kind}'")
        return SVMModel(params["kernel"],
                        support_vectors=np.asarray(params["support_vectors"]),
                        dual_coef=np.asarray(params["dual_coef"]),
                        intercept=np.asarray(params["intercept"]),
                        gamma=float(params["gamma"]),
                        coef0=float(params["coef0"]),
                        degree=int(params["degree"]))
    raise KeyError(f"no port of the '{kind}' model (have: {', '.join(KINDS)})")
