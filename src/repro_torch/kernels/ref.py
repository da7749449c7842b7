"""Plain-PyTorch oracles of the fused fixed-point layers (the correctness
contract), counterparts of :mod:`repro.kernels.ref`.

They accumulate in int64, like the reference oracles, where the kernels and
their plain versions accumulate in int32; the two agree whenever a dot
product stays below 2^31, which the planner guarantees for calibrated
targets.  The remaining oracles arrive with their kernels.
"""

from __future__ import annotations

import torch

from repro_torch.core import fixedpoint as fxp
from repro_torch.core.activations import get_qsigmoid

__all__ = ["fxp_qmatmul_ref", "fxp_layer_ref", "fxp_layer_ref_with_stats",
           "fxp_mlp_model_ref"]


def fxp_qmatmul_ref(a: torch.Tensor, b: torch.Tensor, fmt: fxp.FxpFormat,
                    shift: int | None = None) -> torch.Tensor:
    """Integer-exact round-shift-saturate matmul with an int64 accumulator;
    ``shift`` overrides the requantization amount (``ma + mb - m_out``)."""
    acc = fxp.imatmul(a, b, torch.int64)
    return fxp.requantize(acc, fmt.frac_bits if shift is None else shift, fmt)


def fxp_layer_ref(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor,
                  fmt: fxp.FxpFormat, activation: str = "none",
                  shift: int | None = None) -> torch.Tensor:
    """Fused-layer oracle: ``act(qadd(fxp_qmatmul_ref(a, b), bias))``."""
    h = fxp_qmatmul_ref(a, b, fmt, shift)
    h = fxp.qadd(h, bias[None, :], fmt)
    if activation != "none":
        h = get_qsigmoid(activation)(h, fmt)
    return h


def fxp_layer_ref_with_stats(a: torch.Tensor, b: torch.Tensor,
                             bias: torch.Tensor, fmt: fxp.FxpFormat,
                             activation: str = "none",
                             shift: int | None = None):
    """Fused layer accumulating in ``fmt.wide_dtype`` (the ``ref`` backend's
    semantics), with the matmul stage's overflow/underflow stats."""
    h, stats = fxp.qmatmul_with_stats(a, b, fmt, shift)
    h = fxp.qadd(h, bias[None, :], fmt)
    if activation != "none":
        h = get_qsigmoid(activation)(h, fmt)
    return h, stats


def fxp_mlp_model_ref(x: torch.Tensor, weights, biases,
                      schedule) -> torch.Tensor:
    """Whole-model MLP oracle: :func:`fxp_layer_ref` per
    ``(shift, out_format, activation)`` entry of the schedule."""
    h = x
    for (shift, fmt, activation), w, b in zip(schedule, weights, biases):
        h = fxp_layer_ref(h, w, b, fmt, activation, shift)
    return h
