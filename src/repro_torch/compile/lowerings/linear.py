"""Lowering for linear decision functions: logistic regression and linear
SVMs, ``argmax(x @ W + b)``.  The counterpart of
:mod:`repro.compile.lowerings.linear`; ``svm-linear`` delegates here from
:mod:`.svm`.

Fixed-point targets run the decision function as one fused layer op
(activation ``none``): ``cuda`` through the ``fxp_layer`` kernel (its plain
version on a CPU device), ``ref`` through the wide-accumulating oracle.
Quantized tensor paths: ``input``, ``coef``, ``out`` and ``intercept``
(grouped with ``out``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.fixedpoint import to_numpy
from repro_torch.quant import Calibration, amax

from ..registry import Lowered, Lowering, register_lowering
from ..target import Target
from .common import (argmax_first, as_input, elem_bytes, nbytes, q,
                     qx_with_stats, require_full_float32, resolve_formats,
                     zero_stats)


def calibrate_linear(coef: np.ndarray, intercept: np.ndarray,
                     x: np.ndarray) -> Calibration:
    """Float replay of ``argmax(x @ coef + intercept)`` collecting ranges."""
    acc = x @ coef
    logits = acc + intercept
    return Calibration(
        ranges={"input": amax(x), "coef": amax(coef),
                "intercept": amax(intercept), "out": amax(logits, intercept)},
        groups=(("intercept", "out"),),
        matmuls=(("input", "coef", "out"),),
        acc_ranges={"out": amax(acc)},
    )


def lower_linear(coef: np.ndarray, intercept: np.ndarray, target: Target,
                 plan: Optional[Any], device: torch.device) -> Lowered:
    """Build the Lowered program for ``argmax(x @ coef + intercept)``."""
    F = resolve_formats(target, plan)
    extras: Dict[str, Any] = {}
    if F is None:
        w = torch.from_numpy(np.asarray(coef, np.float32)).to(device)
        b = torch.from_numpy(np.asarray(intercept, np.float32)).to(device)

        def predict(x):
            require_full_float32(device)
            logits = as_input(x, device) @ w + b
            return torch.argmax(logits, -1).to(torch.int32), zero_stats(device)

        flash = nbytes(np.asarray(coef, np.float32),
                       np.asarray(intercept, np.float32))
        sram = int(np.asarray(coef).shape[1]) * elem_bytes(None)
        return Lowered(predict, flash, sram, extras=extras)

    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as ref_ops

    in_fmt, coef_fmt, out_fmt = F("input"), F("coef"), F("out")
    qw = q(coef, coef_fmt, device)
    qb = q(intercept, F("intercept"), device)  # grouped with 'out'
    shift = in_fmt.frac_bits + coef_fmt.frac_bits - out_fmt.frac_bits

    if target.backend == "cuda":
        def predict(x):
            qx, stats = qx_with_stats(as_input(x, device), in_fmt)
            logits = ops.fxp_layer(qx, qw, qb, out_fmt, activation="none",
                                   shift=shift)
            return argmax_first(logits), stats
    else:
        def predict(x):
            qx, s1 = qx_with_stats(as_input(x, device), in_fmt)
            logits, s2 = ref_ops.fxp_layer_ref_with_stats(
                qx, qw, qb, out_fmt, activation="none", shift=shift)
            return argmax_first(logits), s1.merge(s2)

    flash = nbytes(qw, qb)
    sram = int(np.asarray(coef).shape[1]) * elem_bytes(in_fmt)
    extras["emit_spec"] = {
        "family": "linear",
        "in_fmt": in_fmt,
        "out_fmt": out_fmt,
        "w": to_numpy(qw),
        "b": to_numpy(qb),
        "shift": shift,
    }
    return Lowered(predict, flash, sram, extras=extras)


@register_lowering("logistic")
class LogisticLowering(Lowering):
    def extract_params(self, model: Any) -> Dict[str, Any]:
        return {"coef": np.asarray(model.coef),
                "intercept": np.asarray(model.intercept)}

    def calibrate(self, params: Dict[str, Any], x: Any,
                  target: Target) -> Calibration:
        return calibrate_linear(np.asarray(params["coef"], np.float32),
                                np.asarray(params["intercept"], np.float32),
                                np.asarray(x, np.float32))

    def lower(self, qparams: Dict[str, Any], target: Target,
              plan: Optional[Any], device: torch.device) -> Lowered:
        return lower_linear(qparams["coef"], qparams["intercept"], target,
                            plan, device)
