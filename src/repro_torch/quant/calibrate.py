"""Calibration driver: sample batch -> observed ranges -> :class:`QuantPlan`.

The calibrate stage runs between extract and quantize in the compile
pipeline (``repro_torch.compile.api``): the lowering replays its own program in
float over a representative batch, recording the max |value| of every tensor
path it will later quantize — static parameters (exact), activations and
accumulators (data-dependent) — plus the scale-sharing groups and matmul
triples the planner's constraints need.  :func:`make_plan` turns that
evidence into the frozen plan the quantize/lower stages consume.

Helpers here are the shared vocabulary of the per-lowering ``calibrate``
implementations, so every lowering describes ranges the same way.
"""

from __future__ import annotations

import numpy as np

from .plan import Calibration, QuantPlan, plan_formats

__all__ = ["amax", "activation_range", "make_plan", "Calibration"]


def amax(*arrays) -> float:
    """max |value| over any number of arrays (0.0 for all-empty input)."""
    peak = 0.0
    for a in arrays:
        a = np.asarray(a, np.float64)
        if a.size:
            peak = max(peak, float(np.max(np.abs(a))))
    return peak


def activation_range(sigmoid: str, pre_act_amax: float,
                     is_output: bool) -> float:
    """Range the format of a pre-activation tensor must cover.

    The layer output format holds both the pre-activation value *and* the
    fixed-point sigmoid's working constants (the same format flows through
    ``get_qsigmoid``), so the range widens per variant:

    * output layers (no activation): the logits themselves;
    * ``pwl2``/``pwl4``: the PLAN constants and the result live in [0, 1] —
      ``1.0`` must be representable;
    * ``exact``: computes ``1 + exp(-|x|) <= 2`` in-format;
    * ``rational``: computes ``1 + |x|`` in-format.
    """
    if is_output:
        return pre_act_amax
    if sigmoid == "exact":
        return max(pre_act_amax, 2.0)
    if sigmoid == "rational":
        return pre_act_amax + 1.0
    return max(pre_act_amax, 1.0)  # pwl2 / pwl4


def make_plan(lowering, params, target, calibration) -> QuantPlan:
    """Run the lowering's calibration pass and plan per-tensor formats.

    ``calibration`` is a sample batch shaped like inference input (a slice
    of training data is the usual choice); a calibrated ``Target`` cannot
    compile without one unless a previously planned ``QuantPlan`` is passed
    through (the artifact-archive load path).
    """
    if calibration is None:
        raise ValueError(
            f"number_format '{target.number_format}' is calibrated: pass a "
            f"sample batch via compile(model, target, calibration=x_sample) "
            f"so per-tensor ranges can be observed (or supply a stored "
            f"QuantPlan)")
    x = np.asarray(calibration, np.float32)
    if x.ndim == 1:
        x = x[None, :]
    if x.ndim != 2 or x.shape[0] == 0:
        raise ValueError(
            f"calibration batch must be a non-empty (batch, features) "
            f"array, got shape {x.shape}")
    calib = lowering.calibrate(params, x, target)
    return plan_formats(calib, target.container_bits)
