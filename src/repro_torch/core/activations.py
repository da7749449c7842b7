"""Sigmoid approximations for MLP inference (paper §III-D, contribution C3).

The PyTorch counterpart of :mod:`repro.core.activations`: the three drop-in
sigmoid replacements of the paper (``rational``, ``pwl2``, ``pwl4``) and the
exact sigmoid, each in the float domain and in the Qn.m integer domain.  The
PWL slopes are negative powers of two, so the integer versions are pure
shift/add.  Registry keys: ``exact | rational | pwl2 | pwl4``.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from .fixedpoint import FxpFormat, _rshift_round, _saturate, one_q, qdiv, qsigmoid

__all__ = [
    "sigmoid_exact",
    "sigmoid_rational",
    "sigmoid_pwl2",
    "sigmoid_pwl4",
    "get_sigmoid",
    "get_qsigmoid",
    "pwl4_consts",
    "SIGMOID_MAX_ERR",
    "SIGMOID_NAMES",
]

SIGMOID_NAMES = ("exact", "rational", "pwl2", "pwl4")

# Sup-norm error of each approximation vs the true sigmoid (float domain).
SIGMOID_MAX_ERR = {"exact": 0.0, "rational": 0.0830, "pwl2": 0.1200, "pwl4": 0.0200}


# --------------------------------------------------------------------------
# Float domain
# --------------------------------------------------------------------------
def sigmoid_exact(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def sigmoid_rational(x: torch.Tensor) -> torch.Tensor:
    """0.5 + 0.5*x/(1+|x|) — smooth, one divide, no exp."""
    return 0.5 + 0.5 * x / (1.0 + torch.abs(x))


def sigmoid_pwl2(x: torch.Tensor) -> torch.Tensor:
    """Single ramp clamped to [0,1]; breakpoints ±2."""
    return torch.clamp(0.25 * x + 0.5, 0.0, 1.0)


def sigmoid_pwl4(x: torch.Tensor) -> torch.Tensor:
    """PLAN 4-segment PWL (per half-axis), symmetric via 1 - f(|x|)."""
    ax = torch.abs(x)
    y = torch.where(
        ax >= 5.0,
        1.0,
        torch.where(
            ax >= 2.375,
            0.03125 * ax + 0.84375,
            torch.where(ax >= 1.0, 0.125 * ax + 0.625, 0.25 * ax + 0.5),
        ),
    )
    return torch.where(x >= 0, y, 1.0 - y)


_FLOAT_REGISTRY: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "exact": sigmoid_exact,
    "rational": sigmoid_rational,
    "pwl2": sigmoid_pwl2,
    "pwl4": sigmoid_pwl4,
}


def get_sigmoid(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    try:
        return _FLOAT_REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown sigmoid '{name}', expected one of {SIGMOID_NAMES}")


# --------------------------------------------------------------------------
# Qn.m integer domain — slopes are power-of-two shifts
# --------------------------------------------------------------------------
def qsigmoid_rational(x: torch.Tensor, fmt: FxpFormat) -> torch.Tensor:
    """0.5 + 0.5*x/(1+|x|) in Qn.m: one integer divide, one shift."""
    one = int(fmt.scale)
    half = one >> 1
    ax = x.to(fmt.wide_dtype).abs()
    denom = _saturate(ax + one, fmt)
    ratio = qdiv(x, denom, fmt)  # x / (1+|x|) in (-1, 1)
    out = half + _rshift_round(ratio.to(fmt.wide_dtype), 1)
    return _saturate(out, fmt)


def qsigmoid_pwl2(x: torch.Tensor, fmt: FxpFormat) -> torch.Tensor:
    """clip(x>>2 + 0.5, 0, 1) in Qn.m; the upper clamp is ``min(1.0, qmax)``
    so formats with no integer bits saturate instead of wrapping."""
    one = one_q(fmt)
    half = int(fmt.scale) >> 1
    ramp = _rshift_round(x.to(fmt.wide_dtype), 2) + half
    return _saturate(torch.clamp(ramp, 0, one), fmt)


def pwl4_consts(fmt: FxpFormat) -> Dict[str, int]:
    """Integer constants of the PLAN approximation for ``fmt``.

    Shared with the CUDA epilogue.  ``one`` stays unsaturated so the
    ``1 - y`` reflection holds before the final saturation."""
    one = int(fmt.scale)
    return {
        "one": one,
        "half": one >> 1,
        "t5": 5 * one,
        "t2375": int(round(2.375 * fmt.scale)),
        "t1": one,
        "c84375": int(round(0.84375 * fmt.scale)),
        "c625": int(round(0.625 * fmt.scale)),
    }


def qsigmoid_pwl4(x: torch.Tensor, fmt: FxpFormat) -> torch.Tensor:
    """PLAN segments in Qn.m.  Constants quantized once per format."""
    c = pwl4_consts(fmt)
    wide = fmt.wide_dtype
    xw = x.to(wide)
    ax = xw.abs()
    y = torch.where(
        ax >= c["t5"],
        torch.tensor(c["one"], dtype=wide, device=x.device),
        torch.where(
            ax >= c["t2375"],
            _rshift_round(ax, 5) + c["c84375"],
            torch.where(ax >= c["t1"], _rshift_round(ax, 3) + c["c625"],
                        _rshift_round(ax, 2) + c["half"]),
        ),
    )
    y = torch.where(xw >= 0, y, c["one"] - y)
    return _saturate(y, fmt)


def qsigmoid_exact(x: torch.Tensor, fmt: FxpFormat) -> torch.Tensor:
    return qsigmoid(x, fmt)


_FXP_REGISTRY = {
    "exact": qsigmoid_exact,
    "rational": qsigmoid_rational,
    "pwl2": qsigmoid_pwl2,
    "pwl4": qsigmoid_pwl4,
}


def get_qsigmoid(name: str) -> Callable[[torch.Tensor, FxpFormat], torch.Tensor]:
    try:
        return _FXP_REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown sigmoid '{name}', expected one of {SIGMOID_NAMES}")
