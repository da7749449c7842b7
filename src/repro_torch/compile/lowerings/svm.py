"""Lowering for SVM classifiers: linear / polynomial / RBF kernels.

The counterpart of :mod:`repro.compile.lowerings.svm`.  ``svm-linear``
delegates to the shared linear program (same artifact math as logistic
regression, through the ``fxp_layer`` kernel).  Kernel machines compute the
libsvm decision function ``argmax_c sum_m alpha[m,c] K(x, sv_m) + b[c]``;
the float path serves the f64-trained artifact in float32 (TF32 stays off,
PyTorch's default for matmuls), the fixed-point path runs the whole kernel
in Qn.m integer ops.

Backend routing for fixed-point kernel SVMs:

* ``cuda`` — ONE ``fxp_svm_model`` launch for the whole decision function
  when the kernel-value tile fits one block's shared memory
  (:func:`repro_torch.kernels.fxp_model.svm_fits_smem`,
  ``kernel_strategy="megakernel"``); otherwise the chained route
  (``"per-layer"``): ``fxp_qmatmul`` for x . sv^T, the poly/rbf algebra in
  plain PyTorch ops on the device, and ``fxp_layer`` for the decision stage.
  On a CPU device both routes run the kernels' plain versions.
* ``ref`` — the wide-accumulating oracle spelling with overflow stats.

Quantized tensor paths: the whole feature/kernel domain — ``input``,
``support_vectors``, and every elementwise intermediate up to the kernel
value ``kernel`` — shares ONE scale group; the decision stage crosses
formats: ``dual_coef`` gets its own, and ``out`` (grouped with
``intercept``) receives the ``m_k + m_dual - m_out`` epilogue shift.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core import fixedpoint as fxp
from repro_torch.core.fixedpoint import to_numpy
from repro_torch.quant import Calibration, amax

from ..registry import Lowered, Lowering, register_lowering
from ..target import Target
from .common import (argmax_first, as_input, elem_bytes, nbytes, q,
                     qx_with_stats, require_full_float32, resolve_formats,
                     zero_stats)
from .linear import calibrate_linear, lower_linear


@register_lowering("svm-linear", "svm-poly", "svm-rbf")
class SVMLowering(Lowering):
    def extract_params(self, model: Any) -> Dict[str, Any]:
        if model.kernel == "linear":
            return {"kernel": "linear",
                    "coef": np.asarray(model.coef),
                    "intercept": np.asarray(model.intercept)}
        return {"kernel": str(model.kernel),
                "support_vectors": np.asarray(model.support_vectors),
                "dual_coef": np.asarray(model.dual_coef),
                "intercept": np.asarray(model.intercept),
                "gamma": float(model.gamma),
                "coef0": float(model.coef0),
                "degree": int(model.degree)}

    def calibrate(self, params: Dict[str, Any], x: Any,
                  target: Target) -> Calibration:
        if params["kernel"] == "linear":
            return calibrate_linear(
                np.asarray(params["coef"], np.float32),
                np.asarray(params["intercept"], np.float32),
                np.asarray(x, np.float32))
        return _calibrate_kernel_svm(params, np.asarray(x, np.float32))

    def lower(self, qparams: Dict[str, Any], target: Target,
              plan: Optional[Any], device: torch.device) -> Lowered:
        if qparams["kernel"] == "linear":
            return lower_linear(qparams["coef"], qparams["intercept"],
                                target, plan, device)
        return _lower_kernel_svm(qparams, target, plan, device)


def _calibrate_kernel_svm(p: Dict[str, Any], x: np.ndarray) -> Calibration:
    """Float replay of the quantized kernel-SVM op sequence (the
    reference's, verbatim, so that ``auto*`` plans come out identical).

    Every elementwise intermediate lives in the shared feature-domain format
    (see the module docstring), so its peak folds into the ``kernel`` range.
    """
    sv = np.asarray(p["support_vectors"], np.float32)
    dual = np.asarray(p["dual_coef"], np.float32)
    icept = np.asarray(p["intercept"], np.float32)
    gamma, coef0, degree = p["gamma"], p["coef0"], int(p["degree"])

    dot = x @ sv.T
    # Constants quantized into the feature-domain format, plus 1.0 (qpow's
    # multiplicative identity / the RBF kernel's k <= 1 output).
    kdom = amax(np.float32(gamma), np.float32(coef0), 1.0)
    if p["kernel"] == "poly":
        base = np.float32(gamma) * dot + np.float32(coef0)
        kdom = max(kdom, amax(dot, base))
        # qpow_int's square-and-multiply intermediates all live in-format.
        k, b, d = np.ones_like(base), base, degree
        while d:
            if d & 1:
                k = k * b
                kdom = max(kdom, amax(k))
            b = b * b
            d >>= 1
            if d:
                kdom = max(kdom, amax(b))
    else:  # rbf
        x2 = np.sum(x * x, axis=-1)
        sv2 = np.sum(sv * sv, axis=-1)
        d2 = x2[:, None] - 2.0 * dot + sv2[None, :]
        arg = -np.float32(gamma) * d2
        k = np.exp(arg)
        kdom = max(kdom, amax(x2, sv2, dot, d2, arg, k))

    acc = k @ dual
    out = acc + icept
    matmuls = [("input", "support_vectors", "kernel"),
               ("kernel", "dual_coef", "out")]
    acc_ranges = {"kernel": amax(dot), "out": amax(acc)}
    if p["kernel"] == "rbf":
        # qsq_norm accumulates sum(q^2) with the same shift epilogue.
        matmuls += [("input", "input", "kernel"),
                    ("support_vectors", "support_vectors", "kernel")]
        acc_ranges["kernel"] = amax(dot, x2, sv2)
    return Calibration(
        ranges={"input": amax(x), "support_vectors": amax(sv),
                "kernel": kdom, "dual_coef": amax(dual),
                "intercept": amax(icept), "out": amax(out, icept)},
        groups=(("input", "support_vectors", "kernel"),
                ("intercept", "out")),
        matmuls=tuple(matmuls),
        acc_ranges=acc_ranges,
    )


def _lower_float_kernel_svm(kernel: str, sv: np.ndarray, dual: np.ndarray,
                            icept: np.ndarray, gamma: float, coef0: float,
                            degree: int, device: torch.device) -> Lowered:
    svt = torch.from_numpy(sv.astype(np.float32)).to(device)  # f32 serve
    dt = torch.from_numpy(dual.astype(np.float32)).to(device)
    bt = torch.from_numpy(icept.astype(np.float32)).to(device)
    g, c0 = float(np.float32(gamma)), float(np.float32(coef0))

    def predict(x):
        require_full_float32(device)
        x = as_input(x, device)
        if kernel == "poly":
            k = (g * (x @ svt.T) + c0) ** degree
        else:  # rbf
            d2 = ((x * x).sum(-1, keepdim=True) - 2 * x @ svt.T
                  + (svt * svt).sum(-1)[None, :])
            k = torch.exp(-g * d2)
        return (torch.argmax(k @ dt + bt, -1).to(torch.int32),
                zero_stats(device))

    flash = nbytes(sv.astype(np.float32), dual.astype(np.float32),
                   icept.astype(np.float32))
    sram = (sv.shape[0] + dual.shape[1]) * elem_bytes(None)
    return Lowered(predict, flash, sram, extras={})


def _lower_kernel_svm(p: Dict[str, Any], target: Target, plan: Optional[Any],
                      device: torch.device) -> Lowered:
    F = resolve_formats(target, plan)
    kernel = p["kernel"]
    sv = np.asarray(p["support_vectors"])
    dual = np.asarray(p["dual_coef"])
    icept = np.asarray(p["intercept"])
    gamma, coef0, degree = p["gamma"], p["coef0"], int(p["degree"])
    if F is None:
        return _lower_float_kernel_svm(kernel, sv, dual, icept, gamma, coef0,
                                       degree, device)

    from repro_torch.kernels import fxp_model, ops
    from repro_torch.kernels import ref as ref_ops

    # One feature/kernel-domain format (grouped with the input by the
    # planner), distinct dual/out formats across the decision matmul.
    fmt = F("kernel")
    out_fmt = F("out")
    qsv = q(sv, F("support_vectors"), device)
    qd = q(dual, F("dual_coef"), device)
    qb = q(icept, F("intercept"), device)  # grouped with 'out'
    qgamma = int(to_numpy(q(np.float32(gamma), fmt, "cpu")))
    qcoef0 = int(to_numpy(q(np.float32(coef0), fmt, "cpu")))
    dec_shift = fmt.frac_bits + F("dual_coef").frac_bits - out_fmt.frac_bits
    extras: Dict[str, Any] = {}

    if target.backend == "cuda":
        if fxp_model.svm_fits_smem(sv.shape[0]):
            extras["kernel_strategy"] = "megakernel"

            def predict(x):
                qx, stats = qx_with_stats(as_input(x, device), fmt)
                out = ops.fxp_svm_model(qx, qsv, qd, qb, kernel, fmt, out_fmt,
                                        qgamma, qcoef0, degree, dec_shift)
                return argmax_first(out), stats
        else:
            extras["kernel_strategy"] = "per-layer"
            qsv_t = qsv.T.contiguous()

            def predict(x):
                qx, stats = qx_with_stats(as_input(x, device), fmt)
                dot = ops.fxp_qmatmul(qx, qsv_t, fmt)
                k = ref_ops.svm_kernel_values(dot, qx, qsv, kernel, fmt,
                                              qgamma, qcoef0, degree)
                out = ops.fxp_layer(k, qd, qb, out_fmt, activation="none",
                                    shift=dec_shift)
                return argmax_first(out), stats
    else:
        qsv_t = qsv.T

        def predict(x):
            qx, s0 = qx_with_stats(as_input(x, device), fmt)
            dot, s1 = fxp.qmatmul_with_stats(qx, qsv_t, fmt)
            k = ref_ops.svm_kernel_values(dot, qx, qsv, kernel, fmt, qgamma,
                                          qcoef0, degree)
            out, s2 = ref_ops.fxp_layer_ref_with_stats(
                k, qd, qb, out_fmt, activation="none", shift=dec_shift)
            return argmax_first(out), s0.merge(s1).merge(s2)

    flash = nbytes(qsv, qd, qb)
    sram = (sv.shape[0] + dual.shape[1]) * elem_bytes(fmt)
    # The C emitter regenerates the same decision function from the
    # quantized tensors and constants the predict paths close over.
    extras["emit_spec"] = {
        "family": "svm",
        "kernel": kernel,
        "fmt": fmt,
        "out_fmt": out_fmt,
        "sv": to_numpy(qsv),
        "dual": to_numpy(qd),
        "b": to_numpy(qb),
        "qgamma": qgamma,
        "qcoef0": qcoef0,
        "degree": degree,
        "dec_shift": dec_shift,
    }
    return Lowered(predict, flash, sram, extras=extras)
