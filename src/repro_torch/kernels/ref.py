"""Plain-PyTorch oracles of the fused fixed-point layers (the correctness
contract), counterparts of :mod:`repro.kernels.ref`.

They accumulate in int64, like the reference oracles, where the kernels and
their plain versions accumulate in int32; the two agree whenever a dot
product stays below 2^31, which the planner guarantees for calibrated
targets.  The fleet, pwl and attention oracles arrive with their kernels.
"""

from __future__ import annotations

import torch

from repro_torch.core import fixedpoint as fxp
from repro_torch.core.activations import get_qsigmoid
from repro_torch.core.trees import TreeArrays, predict_oblivious

__all__ = ["fxp_qmatmul_ref", "fxp_layer_ref", "fxp_layer_ref_with_stats",
           "fxp_mlp_model_ref", "fxp_svm_model_ref", "svm_kernel_values",
           "tree_ensemble_ref"]


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


def svm_kernel_values(dot: torch.Tensor, qx: torch.Tensor, sv: torch.Tensor,
                      kind: str, fmt: fxp.FxpFormat, qgamma: int,
                      qcoef0: int, degree: int) -> torch.Tensor:
    """The kernel SVM's elementwise Qn.m algebra on the requantized
    ``dot = x . sv^T`` (B, S), in ``fmt``:

    * poly: ``qpow_int(qadd(qmul(dot, g), c0), degree)``;
    * rbf: ``qexp(-qmul(|x|^2 - 2 dot + |sv|^2, g))`` with the squared
      norms of :func:`repro_torch.core.fixedpoint.qsq_norm`.
    """
    g = torch.tensor(qgamma, dtype=fmt.dtype, device=dot.device)
    if kind == "poly":
        c0 = torch.tensor(qcoef0, dtype=fmt.dtype, device=dot.device)
        return fxp.qpow_int(fxp.qadd(fxp.qmul(dot, g, fmt), c0, fmt),
                            degree, fmt)
    if kind == "rbf":
        d2 = fxp.qadd(fxp.qsub(fxp.qsq_norm(qx, fmt)[:, None],
                               fxp.qadd(dot, dot, fmt), fmt),
                      fxp.qsq_norm(sv, fmt)[None, :], fmt)
        return fxp.qexp(fxp.qneg(fxp.qmul(d2, g, fmt), fmt), fmt)
    raise KeyError(f"kind must be 'poly' or 'rbf', got {kind!r}")


def fxp_svm_model_ref(qx: torch.Tensor, sv: torch.Tensor, dual: torch.Tensor,
                      icept: torch.Tensor, kind: str, fmt: fxp.FxpFormat,
                      out_fmt: fxp.FxpFormat, qgamma: int, qcoef0: int,
                      degree: int, dec_shift: int) -> torch.Tensor:
    """Whole-model kernel-SVM oracle: :func:`fxp_qmatmul_ref` for x . sv^T,
    the elementwise kernel algebra, and the fused-layer oracle for the
    decision stage.  ``sv`` is the un-transposed (S, F) matrix;
    ``qgamma``/``qcoef0`` are the quantized integer constants."""
    dot = fxp_qmatmul_ref(qx, sv.T, fmt)
    k = svm_kernel_values(dot, qx, sv, kind, fmt, qgamma, qcoef0, degree)
    return fxp_layer_ref(k, dual, icept, out_fmt, "none", dec_shift)


def tree_ensemble_ref(tree: TreeArrays, x: torch.Tensor) -> torch.Tensor:
    """Oblivious-form tree oracle (finite inputs)."""
    return predict_oblivious(tree, x)
