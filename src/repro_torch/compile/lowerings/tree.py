"""Lowering for decision trees (paper C4: three inference layouts).

The counterpart of :mod:`repro.compile.lowerings.tree`.  Backend routing:

* ``ref`` — the layout chosen by ``Target.tree_layout`` (iterative
  gather-chase, codegen'd nested-where, or dense oblivious form), in plain
  PyTorch ops on the artifact's device.
* ``cuda`` — the ``tree_ensemble`` kernel through ``kernels.ops.tree_predict``
  (its plain version on a CPU device), for float and fixed-point targets
  alike.  The kernel selects the same leaf as every layout (they are
  prediction-equivalent); the memory model still reports the requested
  layout's footprint.

Fixed-point targets quantize thresholds at compile time and inputs at call
time; on ``cuda`` the kernel takes the quantized container and casts each
feature it reads to float32, as the reference's ``pallas`` body does, and
compares it with the float32-cast thresholds (exact for |q| < 2^24).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core import trees as trees_mod
from repro_torch.core.trees import TreeArrays
from repro_torch.quant import Calibration, amax

from ..registry import Lowered, Lowering, register_lowering
from ..target import Target
from .common import as_input, qx_with_stats, resolve_formats, zero_stats

_LAYOUT_FNS = {
    "iterative": trees_mod.predict_iterative,
    "ifelse": trees_mod.predict_ifelse,
    "oblivious": trees_mod.predict_oblivious,
}


@register_lowering("tree")
class TreeLowering(Lowering):
    def extract_params(self, model: Any) -> Dict[str, Any]:
        t: TreeArrays = model.tree
        return {
            "feature": np.asarray(t.feature, np.int32),
            "threshold": np.asarray(t.threshold, np.float32),
            "left": np.asarray(t.left, np.int32),
            "right": np.asarray(t.right, np.int32),
            "leaf_class": np.asarray(t.leaf_class, np.int32),
            "max_depth": int(t.max_depth),
            "n_classes": int(t.n_classes),
            "n_features": int(t.n_features),
        }

    def calibrate(self, params: Dict[str, Any], x: Any,
                  target: Target) -> Calibration:
        # Tree inference is one integer comparison per node: q(x) <= q(thr)
        # is only order-preserving when both sides share a scale, so the two
        # paths are one group (the planner takes the min fractional bits).
        return Calibration(
            ranges={"input": amax(x),
                    "threshold": amax(params["threshold"])},
            groups=(("input", "threshold"),),
        )

    def quantize(self, params: Dict[str, Any], target: Target,
                 plan: Optional[Any] = None) -> Dict[str, Any]:
        tree = TreeArrays(
            feature=np.asarray(params["feature"], np.int32),
            threshold=np.asarray(params["threshold"], np.float32),
            left=np.asarray(params["left"], np.int32),
            right=np.asarray(params["right"], np.int32),
            leaf_class=np.asarray(params["leaf_class"], np.int32),
            max_depth=int(params["max_depth"]),
            n_classes=int(params["n_classes"]),
            n_features=int(params["n_features"]),
        )
        F = resolve_formats(target, plan)
        if F is not None:
            tree = tree.quantized(F("threshold"))
        return {"tree": tree}

    def lower(self, qparams: Dict[str, Any], target: Target,
              plan: Optional[Any], device: torch.device) -> Lowered:
        tree: TreeArrays = qparams["tree"]
        F = resolve_formats(target, plan)
        fmt = None if F is None else F("input")  # == threshold fmt (grouped)

        if target.backend == "cuda":
            from repro_torch.kernels import ops

            if fmt is None:
                def predict(x):
                    return (ops.tree_predict(tree, as_input(x, device)),
                            zero_stats(device))
            else:
                def predict(x):
                    qx, stats = qx_with_stats(as_input(x, device), fmt)
                    return ops.tree_predict(tree, qx), stats
        else:
            predict_raw = _LAYOUT_FNS[target.tree_layout]
            if fmt is None:
                def predict(x):
                    return (predict_raw(tree, as_input(x, device)),
                            zero_stats(device))
            else:
                def predict(x):
                    qx, stats = qx_with_stats(as_input(x, device), fmt)
                    return predict_raw(tree, qx), stats

        flash = trees_mod.tree_memory_bytes(tree, target.tree_layout, fmt)
        sram = 8  # node index + feature value registers
        extras: Dict[str, Any] = {}
        if fmt is not None:
            # The C emitter walks the same node arrays; thresholds are
            # already quantized into the shared input/threshold format.
            extras["emit_spec"] = {
                "family": "tree",
                "in_fmt": fmt,
                "feature": np.asarray(tree.feature, np.int32),
                "threshold": np.asarray(tree.threshold),
                "left": np.asarray(tree.left, np.int32),
                "right": np.asarray(tree.right, np.int32),
                "leaf_class": np.asarray(tree.leaf_class, np.int32),
                "max_depth": int(tree.max_depth),
            }
        return Lowered(predict, flash, sram, extras=extras)
