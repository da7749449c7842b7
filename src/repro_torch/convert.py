"""Carry a model across from the reference package.

:func:`model_from_params` takes the parameter dict that the reference
lowering extracts (``repro.compile.get_lowering(kind).extract_params(model)``,
numpy arrays and scalars only) and returns the port's model container, so
both packages compile the same program from the same parameters.
:func:`lm_params_from_numpy` does the same for an LM's parameter tree.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.trees import TreeArrays
from repro_torch.models import (DecisionTreeModel, LogisticModel, MLPModel,
                                SVMModel)

__all__ = ["model_from_params", "lm_params_from_numpy", "KINDS"]

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


def _tensor_from_numpy(a: Any) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # a JAX array's host view: torch wants its own
        a = a.copy()
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 (the reference's arrays carry ml_dtypes'),
        # and torch.from_numpy refuses it: move the bits, not the values.
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def lm_params_from_numpy(tree: Dict[str, Any], device: Any,
                         dtype: Optional[torch.dtype] = None,
                         _path: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """The port's LM parameter tree from the reference's, leaf for leaf:
    nested dicts of numpy arrays (``np.asarray`` of each JAX leaf) become
    the same dicts of tensors on ``device``, bit for bit (bfloat16
    included), floating leaves cast to ``dtype`` when one is given — but
    the leaves the reference keeps in float32 whatever the model's dtype
    (:func:`repro_torch.lm.model.float32_leaf`: a MoE router's, Mamba2's
    ``A_log``/``dt_bias``/``D``, RWKV-6's anchors, decay base, bonus and
    norms), which keep theirs."""
    if isinstance(tree, dict):
        return {k: lm_params_from_numpy(v, device, dtype, _path + (k,))
                for k, v in tree.items()}
    from repro_torch.lm.model import float32_leaf

    t = _tensor_from_numpy(tree).to(device)
    if dtype is None or not t.is_floating_point() or float32_leaf(_path):
        return t
    return t.to(dtype)
