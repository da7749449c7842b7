"""Qn.m fixed-point arithmetic in PyTorch (paper §III-C, contribution C1).

The PyTorch counterpart of :mod:`repro.core.fixedpoint`, bit for bit: signed
Qn.m numbers in 8/16/32-bit integer containers, saturating arithmetic,
round-to-nearest rescaling, and the integer transcendentals (exp, sigmoid,
tanh, sqrt, reciprocal, power) the classifiers need.

Every operation computes in the format's ``wide_dtype`` (int16/int32/int64
for 8/16/32-bit containers) and wraps there exactly as the reference does;
for example :func:`qexp` on an 8-bit container multiplies in int16 and its
Horner products wrap at 16 bits.  Python integer constants combine with
tensors as weak scalars in both frameworks, so they never widen a result.

Integer matrix products go through :func:`imatmul`, which is exact and wraps
to a chosen accumulator width on any device (torch has no integer matmul on
CUDA): operands are split into 16-bit halves whose float64 products and sums
stay below 2^53.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "FxpFormat",
    "FXP32",
    "FXP16",
    "FXP8",
    "STATS_DTYPE",
    "quantize",
    "dequantize",
    "qadd",
    "qsub",
    "qneg",
    "qmul",
    "qdiv",
    "imatmul",
    "qmatmul",
    "qmatmul_with_stats",
    "requantize",
    "rshift_round_saturate",
    "quantize_with_stats",
    "qexp",
    "qsigmoid",
    "qtanh",
    "qsqrt",
    "qrecip",
    "qpow_int",
    "qrelu",
    "FxpStats",
    "one_q",
    "exp_poly_consts",
]

_DTYPES = {8: torch.int8, 16: torch.int16, 32: torch.int32}
_WIDE_DTYPES = {8: torch.int16, 16: torch.int32, 32: torch.int64}


@dataclasses.dataclass(frozen=True)
class FxpFormat:
    """A signed Qn.m fixed-point format in a ``total_bits`` integer container.

    value = stored_int / 2**frac_bits.  ``int_bits = total_bits - 1 - frac_bits``
    (one sign bit).  Representable range: [-(2**(total-1)) / 2**m,
    (2**(total-1) - 1) / 2**m].
    """

    total_bits: int
    frac_bits: int
    name: str = ""

    def __post_init__(self):
        if self.total_bits not in (8, 16, 32):
            raise ValueError(f"unsupported container width {self.total_bits}")
        if not 0 <= self.frac_bits < self.total_bits:
            raise ValueError(f"frac_bits {self.frac_bits} out of range")

    @property
    def int_bits(self) -> int:
        return self.total_bits - 1 - self.frac_bits

    @property
    def scale(self) -> float:
        return float(2 ** self.frac_bits)

    @property
    def qmin(self) -> int:
        return -(2 ** (self.total_bits - 1))

    @property
    def qmax(self) -> int:
        return 2 ** (self.total_bits - 1) - 1

    @property
    def min_value(self) -> float:
        return self.qmin / self.scale

    @property
    def max_value(self) -> float:
        return self.qmax / self.scale

    @property
    def resolution(self) -> float:
        return 1.0 / self.scale

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.total_bits]

    @property
    def wide_dtype(self) -> torch.dtype:
        """Accumulator dtype wide enough to hold a product of two values."""
        return _WIDE_DTYPES[self.total_bits]

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return self.name or f"Q{self.int_bits}.{self.frac_bits}/{self.total_bits}b"


# The paper's experimental formats (§IV): FXP32 = Q22.10, FXP16 = Q12.4.
FXP32 = FxpFormat(32, 10, "FXP32(Q22.10)")
FXP16 = FxpFormat(16, 4, "FXP16(Q12.4)")
FXP8 = FxpFormat(8, 2, "FXP8(Q5.2)")

# In-program overflow/underflow counters are int32 (one call cannot observe
# 2^31 elements); FxpStats.merge accumulates in int64 so long runs never wrap.
STATS_DTYPE = torch.int32


@dataclasses.dataclass
class FxpStats:
    """Overflow/underflow accounting (paper §V-A)."""

    overflow: torch.Tensor  # count of saturated elements
    underflow: torch.Tensor  # count of non-zero reals rounded to exactly zero
    total: torch.Tensor  # number of elements observed

    def merge(self, other: "FxpStats") -> "FxpStats":
        # int64 accumulation: the per-call counters are int32, and a serving
        # run that keeps merging per-request stats would wrap them.  Stays on
        # the counters' device, so merging never waits for the card.
        def add(a, b):
            return (torch.as_tensor(a).to(torch.int64)
                    + torch.as_tensor(b).to(torch.int64))

        return FxpStats(add(self.overflow, other.overflow),
                        add(self.underflow, other.underflow),
                        add(self.total, other.total))


def _saturate(x_wide: torch.Tensor, fmt: FxpFormat) -> torch.Tensor:
    return torch.clamp(x_wide, fmt.qmin, fmt.qmax).to(fmt.dtype)


def one_q(fmt: FxpFormat) -> int:
    """The constant 1.0 quantized into ``fmt``, saturating (``qmax`` for
    formats with no integer bits, which cannot represent 1.0)."""
    return min(1 << fmt.frac_bits, fmt.qmax)


def exp_poly_consts(fmt: FxpFormat) -> Tuple[int, Tuple[int, int, int, int]]:
    """Per-format integer constants of :func:`qexp`: ``(log2e_q, (c0..c3))``.

    Shared with the CUDA epilogue, which receives them from the host."""
    log2e_q = int(round(_LOG2_E * fmt.scale))
    coeffs = tuple(int(round(c * fmt.scale)) for c in _EXP2_COEFFS)
    return log2e_q, coeffs


# --------------------------------------------------------------------------
# Conversion
# --------------------------------------------------------------------------
def _to_container(q: torch.Tensor, fmt: FxpFormat) -> torch.Tensor:
    """Rounded float -> container, saturating like XLA's conversion.

    The clamp runs in float64, where ``qmax`` of a 32-bit container is exact
    (in float32 it rounds up to 2^31, which torch's cast would wrap to
    ``qmin``); NaN becomes 0, as XLA converts it."""
    q = torch.nan_to_num(q.to(torch.float64), nan=0.0)
    return torch.clamp(q, fmt.qmin, fmt.qmax).to(fmt.dtype)


def quantize(x, fmt: FxpFormat) -> torch.Tensor:
    """float -> Qn.m integer, round-to-nearest-even, saturating."""
    scaled = torch.as_tensor(x).to(torch.float32) * fmt.scale
    return _to_container(torch.round(scaled), fmt)


def quantize_with_stats(x, fmt: FxpFormat) -> Tuple[torch.Tensor, FxpStats]:
    x = torch.as_tensor(x)
    q = torch.round(x.to(torch.float32) * fmt.scale)
    over = ((q > fmt.qmax) | (q < fmt.qmin)).sum(dtype=STATS_DTYPE)
    under = ((q == 0) & (x != 0)).sum(dtype=STATS_DTYPE)
    total = torch.tensor(x.numel(), dtype=STATS_DTYPE, device=x.device)
    return _to_container(q, fmt), FxpStats(over, under, total)


def dequantize(q: torch.Tensor, fmt: FxpFormat) -> torch.Tensor:
    return q.to(torch.float32) / fmt.scale


# --------------------------------------------------------------------------
# Basic saturating arithmetic
# --------------------------------------------------------------------------
def qadd(a: torch.Tensor, b: torch.Tensor, fmt: FxpFormat) -> torch.Tensor:
    return _saturate(a.to(fmt.wide_dtype) + b.to(fmt.wide_dtype), fmt)


def qsub(a: torch.Tensor, b: torch.Tensor, fmt: FxpFormat) -> torch.Tensor:
    return _saturate(a.to(fmt.wide_dtype) - b.to(fmt.wide_dtype), fmt)


def qneg(a: torch.Tensor, fmt: FxpFormat) -> torch.Tensor:
    return _saturate(-a.to(fmt.wide_dtype), fmt)


def _rshift_round(x_wide: torch.Tensor, m: int) -> torch.Tensor:
    """Arithmetic right shift by ``m`` with round-to-nearest (ties away from 0).

    Floor-shift plus remainder, so no intermediate can overflow the dtype:
    exact for every representable ``x`` including the dtype's min/max.  The
    constant ``1 << (m - 1)`` is built with a tensor shift so that shifts at
    or past the dtype's width behave as XLA's do (0, not a Python bigint).
    """
    if m == 0:
        return x_wide
    half = torch.ones((), dtype=x_wide.dtype) << (m - 1)
    floor_q = x_wide >> m  # floor(x / 2^m): arithmetic shift
    rem = x_wide - (floor_q << m)  # remainder in [0, 2^m)
    # Ties away from zero: for x >= 0 bump on rem >= half, for x < 0 on
    # rem > half; compared as rem > half - (x >= 0) so nothing is added to
    # rem, which can itself be the dtype max.
    bump = rem > (half - (x_wide >= 0).to(x_wide.dtype))
    return floor_q + bump.to(x_wide.dtype)


def requantize(acc: torch.Tensor, shift: int, fmt: FxpFormat) -> torch.Tensor:
    """``saturate(round_shift(acc, shift))`` — the mixed-format epilogue
    (``shift = ma + mb - m_out``, non-negative by the planner)."""
    if shift < 0:
        raise ValueError(f"requantize shift must be >= 0, got {shift}")
    return _saturate(_rshift_round(acc, shift), fmt)


def rshift_round_saturate(acc: torch.Tensor, fmt: FxpFormat) -> torch.Tensor:
    """``saturate(round_shift(acc, m))`` — the single-format epilogue."""
    return requantize(acc, fmt.frac_bits, fmt)


def qmul(a: torch.Tensor, b: torch.Tensor, fmt: FxpFormat) -> torch.Tensor:
    """(a*b) >> m with rounding, saturating — elementwise Qn.m multiply."""
    wide = a.to(fmt.wide_dtype) * b.to(fmt.wide_dtype)
    return _saturate(_rshift_round(wide, fmt.frac_bits), fmt)


def qdiv(a: torch.Tensor, b: torch.Tensor, fmt: FxpFormat) -> torch.Tensor:
    """(a << m) / b with round-to-nearest, saturating. b == 0 saturates."""
    wide = fmt.wide_dtype
    wide_a = a.to(wide) << fmt.frac_bits
    wide_b = b.to(wide)
    safe_b = torch.where(wide_b == 0, 1, wide_b)
    sign = torch.where((wide_a < 0) != (safe_b < 0), -1, 1).to(wide)
    # Truncating division on magnitudes (``//`` floors, which equals
    # truncation for non-negative operands), then round-to-nearest with ties
    # away from zero — the MCU fixed-point division macro.
    q_trunc = sign * (wide_a.abs() // safe_b.abs())
    rem_t = wide_a - q_trunc * safe_b
    adjust_t = (rem_t.abs() * 2 >= safe_b.abs()).to(wide)
    q_rounded = q_trunc + adjust_t * sign
    by_zero = torch.where(a >= 0, fmt.qmax, fmt.qmin).to(wide)
    return _saturate(torch.where(wide_b == 0, by_zero, q_rounded), fmt)


def qrelu(a: torch.Tensor, fmt: FxpFormat) -> torch.Tensor:
    del fmt
    return torch.clamp_min(a, 0)


# --------------------------------------------------------------------------
# Matrix multiply — the inference hot spot
# --------------------------------------------------------------------------
# float64 represents every integer below 2^53 exactly: with 16-bit halves a
# product is below 2^32, so a sum of fewer than 2^21 of them is exact.
_IMATMUL_MAX_K = 1 << 20


def imatmul(a: torch.Tensor, b: torch.Tensor,
            acc_dtype: torch.dtype) -> torch.Tensor:
    """Exact integer ``a @ b`` wrapped to ``acc_dtype`` (two's complement).

    a: (..., K), b: (K, N), any integer dtypes up to 32 bits.  The result is
    the true sum modulo 2^width(acc_dtype) — what an accumulator of that
    dtype produces when it wraps — on the CPU and on CUDA alike.  Operands
    narrower than 32 bits take one float64 product; 32-bit operands are
    split into 16-bit halves (three products) and recombined modulo 2^64.
    """
    k = a.shape[-1]
    if b.shape[0] != k:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if k > _IMATMUL_MAX_K:
        raise ValueError(f"imatmul supports K <= {_IMATMUL_MAX_K}, got {k}")

    def exact(u, v):
        return torch.matmul(u.to(torch.float64),
                            v.to(torch.float64)).to(torch.int64)

    if a.element_size() < 4 and b.element_size() < 4:
        return exact(a, b).to(acc_dtype)  # |a*b| < 2^30: one product is exact
    a64, b64 = a.to(torch.int64), b.to(torch.int64)
    a_lo, a_hi = a64 & 0xFFFF, a64 >> 16
    b_lo, b_hi = b64 & 0xFFFF, b64 >> 16
    acc = (exact(a_lo, b_lo)
           + ((exact(a_lo, b_hi) + exact(a_hi, b_lo)) << 16)
           + (exact(a_hi, b_hi) << 32))  # wraps modulo 2^64
    return acc.to(acc_dtype)


def qmatmul(a: torch.Tensor, b: torch.Tensor, fmt: FxpFormat,
            preferred_wide: bool = True) -> torch.Tensor:
    """Fixed-point matmul: wide-accumulate int products, then one rounded
    right-shift by ``m`` and saturation.

    a: (..., K) int, b: (K, N) int -> (..., N) int in the same format.
    """
    acc = imatmul(a, b, fmt.wide_dtype if preferred_wide else torch.int32)
    return _saturate(_rshift_round(acc, fmt.frac_bits), fmt)


def qmatmul_with_stats(a: torch.Tensor, b: torch.Tensor, fmt: FxpFormat,
                       shift: Optional[int] = None
                       ) -> Tuple[torch.Tensor, FxpStats]:
    """Like :func:`qmatmul` but also returns overflow/underflow counts;
    ``shift`` overrides the requantization amount (``ma + mb - m_out``)."""
    shift = fmt.frac_bits if shift is None else shift
    acc = imatmul(a, b, fmt.wide_dtype)
    shifted = _rshift_round(acc, shift)
    over = ((shifted > fmt.qmax) | (shifted < fmt.qmin)).sum(dtype=STATS_DTYPE)
    under = ((shifted == 0) & (acc != 0)).sum(dtype=STATS_DTYPE)
    out = _saturate(shifted, fmt)
    total = torch.tensor(out.numel(), dtype=STATS_DTYPE, device=out.device)
    return out, FxpStats(over, under, total)


# --------------------------------------------------------------------------
# Transcendentals (range-reduced polynomials, pure integer ops)
# --------------------------------------------------------------------------
# 2^f for f in [0,1) as a cubic minimax polynomial; max |err| ~ 1e-4.
_EXP2_COEFFS = (0.9999936, 0.6964313, 0.2243984, 0.0792043)
_LOG2_E = 1.4426950408889634


def qexp(x: torch.Tensor, fmt: FxpFormat) -> torch.Tensor:
    """Fixed-point exp(x) = 2^k * 2^f, f in [0,1), in Qn.m integer ops.

    Saturates on overflow and flushes to zero for k below -m.  Shift amounts
    are clamped below the wide dtype's width, as the reference does."""
    m = fmt.frac_bits
    wide = fmt.wide_dtype
    log2e_q, (c0, c1, c2, c3) = exp_poly_consts(fmt)
    y = _rshift_round(x.to(wide) * log2e_q, m)  # x*log2e in Qn.m (wide)
    k = y >> m  # floor(y)
    f = y - (k << m)  # fractional part in [0, 2^m)
    acc = torch.full_like(f, c3)
    acc = _rshift_round(acc * f, m) + c2
    acc = _rshift_round(acc * f, m) + c1
    acc = _rshift_round(acc * f, m) + c0  # ~2^f in Qn.m
    k_i32 = k.to(torch.int32)
    max_shift = fmt.total_bits  # beyond this always saturates / flushes
    k_clamped = torch.clamp(k_i32, -max_shift, max_shift)
    pos = torch.where(k_clamped > 0, k_clamped, 0).to(wide)
    neg = torch.where(k_clamped < 0, -k_clamped, 0).to(wide)
    up_shift = torch.clamp_max(pos, fmt.total_bits - 1)
    shifted_up = acc << up_shift
    overflowed = (shifted_up >> up_shift) != acc
    qmax = torch.tensor(fmt.qmax, dtype=wide, device=x.device)
    up = torch.where(overflowed, qmax, shifted_up)
    down = acc >> torch.clamp_max(neg, fmt.total_bits + m)
    out = torch.where(k_clamped >= 0, up, down)
    out = torch.where(k_i32 >= fmt.int_bits, qmax, out)
    return _saturate(out, fmt)


def qrecip(x: torch.Tensor, fmt: FxpFormat) -> torch.Tensor:
    """1/x in Qn.m via exact integer division (2^(2m) / q)."""
    return qdiv(torch.full_like(x, one_q(fmt), dtype=fmt.dtype), x, fmt)


def qsigmoid(x: torch.Tensor, fmt: FxpFormat) -> torch.Tensor:
    """Exact-form fixed-point sigmoid 1/(1+exp(-x)) via exp(-|x|) and
    sigmoid(x) = 1 - sigmoid(-x) for the negative branch."""
    neg_abs = -x.to(fmt.wide_dtype).abs()
    e = qexp(_saturate(neg_abs, fmt), fmt)  # exp(-|x|) in (0, 1]
    one = torch.full_like(e, one_q(fmt))
    denom = qadd(one, e, fmt)
    pos = qdiv(one, denom, fmt)  # sigmoid(|x|)
    neg = qsub(one, pos, fmt)
    return torch.where(x >= 0, pos, neg)


def qtanh(x: torch.Tensor, fmt: FxpFormat) -> torch.Tensor:
    """tanh(x) = 2*sigmoid(2x) - 1, all in Qn.m."""
    two_x = _saturate(x.to(fmt.wide_dtype) << 1, fmt)
    s = qsigmoid(two_x, fmt)
    return _saturate(s.to(fmt.wide_dtype) * 2 - int(fmt.scale), fmt)


def qsqrt(x: torch.Tensor, fmt: FxpFormat) -> torch.Tensor:
    """sqrt in Qn.m: isqrt of (q << m) by integer Newton from a float seed."""
    wide = fmt.wide_dtype
    v = torch.clamp_min(x.to(wide), 0) << fmt.frac_bits
    seed = torch.sqrt(torch.clamp_min(v.to(torch.float32), 1.0)).to(wide)
    guess = torch.clamp_min(seed, 1)
    for _ in range(4):
        guess = (guess + v // torch.clamp_min(guess, 1)) >> 1
    guess = torch.where(v == 0, 0, guess)
    return _saturate(guess, fmt)


def qpow_int(x: torch.Tensor, p: int, fmt: FxpFormat) -> torch.Tensor:
    """x**p for small non-negative integer p (poly-kernel SVM degree)."""
    if p < 0:
        raise ValueError("qpow_int only supports non-negative integer powers")
    out = torch.full_like(x, one_q(fmt))
    base = x
    while p:
        if p & 1:
            out = qmul(out, base, fmt)
        base = qmul(base, base, fmt)
        p >>= 1
    return out


def to_numpy(t) -> np.ndarray:
    """Host numpy copy of a tensor (or array-like), for the emit spec and
    the tests."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)
