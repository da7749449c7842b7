"""Freestanding C99 code generation from lowered quantized programs.

The counterpart of :mod:`repro.emit.cgen`, over the port's own fixed-point
core.  The emitter does NOT re-derive any numerics: each quantized lowering
attaches an ``emit_spec`` to its ``Lowered.extras`` holding the exact
tensors it quantized and the shift/activation schedule its predict closes
over (byte for byte the reference's), and this module templates those into
C.  Every arithmetic helper in the generated runtime mirrors one function of
:mod:`repro_torch.core.fixedpoint` *bit for bit*, including the parts that
only show at the edges:

* ``fxp_rshr``        == ``_rshift_round`` (floor-shift + remainder,
  round-to-nearest ties away from zero — exact at dtype extremes);
* ``fxp_requant``     == ``requantize`` (shift then saturate);
* matmul accumulators run at the *format's wide dtype* (int16/int32/int64 for
  8/16/32-bit containers) exactly like ``qmatmul_with_stats`` — sums are
  taken mod 2^64 and wrapped to the wide width, never saturated;
* ``fxp_qexp``        == ``qexp`` including the deliberate wide-dtype wrap of
  its overflow-detecting left shift;
* the PWL/rational/exact sigmoids take their constants from the same
  ``exp_poly_consts`` / ``pwl4_consts`` / ``one_q`` helpers the tensor ops
  use, computed here in Python so the C stays integer-only.

The generated text is the reference's, character for character, after its
first ``/* ... */`` comment (which names this package): every literal is
printed from a Python ``int``, whatever integer type a spec holds.  All
signed shifts route through unsigned casts (no C undefined behaviour);
two's-complement wraps are explicit (``fxp_wrap``).  The generated unit is
freestanding: ``<stdint.h>`` is the only include, there is no libc call, and
:func:`assert_integer_only` proves there is no floating-point token.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List

import numpy as np

from repro_torch.core import activations as act_mod
from repro_torch.core import fixedpoint as fxp

__all__ = ["EmitError", "emit_c", "assert_integer_only", "input_format",
           "spec_of", "CTYPES"]


class EmitError(TypeError):
    """The artifact/program cannot be emitted as C (float target, LM kind,
    or a legacy artifact whose lowering predates the emit backend)."""


CTYPES = {8: "int8_t", 16: "int16_t", 32: "int32_t"}
_WIDE_BITS = {8: 16, 16: 32, 32: 64}


def spec_of(artifact) -> Dict[str, Any]:
    """The ``emit_spec`` of a compiled artifact, or a diagnosable error."""
    program = getattr(artifact, "_program", None)
    extras = getattr(program, "extras", None) or getattr(artifact, "extras", {})
    spec = (extras or {}).get("emit_spec")
    if spec is None:
        if not artifact.target.is_quantized:
            raise EmitError(
                "C emission needs a quantized target: float models have no "
                "fixed-point program to emit (compile with number_format="
                "'fxp32'/'fxp16'/'fxp8' or a calibrated 'auto*' format)")
        raise EmitError(
            f"the '{artifact.kind}' lowering does not provide an emit_spec; "
            f"C emission covers the classifier lowerings "
            f"(tree/logistic/mlp/svm-*)")
    return spec


def input_format(spec: Dict[str, Any]) -> fxp.FxpFormat:
    """The format inputs are quantized into before entering the C program."""
    return spec.get("in_fmt") or spec["fmt"]


# --------------------------------------------------------------------------
# literals / arrays
# --------------------------------------------------------------------------
def _ci(v) -> str:
    """A C integer literal for ``v`` — INT_MIN-safe, LL-suffixed past 32 bits."""
    v = int(v)
    if v == -(2 ** 31):
        return "(-2147483647 - 1)"
    if v == -(2 ** 63):
        return "(-9223372036854775807LL - 1)"
    if not -(2 ** 31) <= v < 2 ** 31:
        return f"{v}LL"
    return str(v)


def _carray(name: str, arr: np.ndarray, ctype: str) -> str:
    """``static const`` array definition (1-D or 2-D), wrapped for review."""
    arr = np.asarray(arr)

    def row(vals: np.ndarray) -> str:
        toks = [_ci(v) for v in vals.tolist()]
        lines: List[str] = []
        cur = "  "
        for t in toks:
            if len(cur) + len(t) + 2 > 76:
                lines.append(cur.rstrip())
                cur = "  "
            cur += t + ", "
        lines.append(cur.rstrip().rstrip(","))
        return "\n".join(lines)

    if arr.ndim == 1:
        return (f"static const {ctype} {name}[{arr.shape[0]}] = {{\n"
                f"{row(arr)}\n}};")
    if arr.ndim == 2:
        rows = ",\n".join("  {\n" + row(r).replace("\n", "\n  ") + "\n  }"
                          for r in arr)
        return (f"static const {ctype} {name}[{arr.shape[0]}][{arr.shape[1]}]"
                f" = {{\n{rows}\n}};")
    raise EmitError(f"cannot emit {arr.ndim}-D array '{name}'")


class _P:
    """Per-format C parameters, precomputed once."""

    def __init__(self, fmt: fxp.FxpFormat):
        self.fmt = fmt
        self.m = fmt.frac_bits
        self.tb = fmt.total_bits
        self.wb = _WIDE_BITS[fmt.total_bits]
        self.ib = fmt.int_bits
        self.qmin = fmt.qmin
        self.qmax = fmt.qmax
        self.ctype = CTYPES[fmt.total_bits]


# --------------------------------------------------------------------------
# the fixed-point runtime (self-contained, every helper `static inline`)
# --------------------------------------------------------------------------
_RUNTIME = r"""
/* ---- fixed-point runtime: mirrors repro/core/fixedpoint.py bit-for-bit.
 * Integer-only C99.  Signed shifts go through unsigned casts (defined
 * behaviour); two's-complement wraps are explicit via fxp_wrap. ---- */

static inline int64_t fxp_u2s(uint64_t u) {
  /* value-preserving uint64 -> int64 reinterpretation, no overflow UB */
  if (u <= (uint64_t)9223372036854775807LL) return (int64_t)u;
  return (int64_t)(u - (uint64_t)9223372036854775807LL - 1u)
         + (-9223372036854775807LL - 1);
}

static inline int64_t fxp_shl(int64_t v, int m) {
  return fxp_u2s((uint64_t)v << m);
}

static inline int64_t fxp_wrap(int64_t v, int bits) {
  /* wrap v into the two's-complement range of `bits` — the exact overflow
   * behaviour of the traced wide integer dtype */
  uint64_t mask, u;
  if (bits >= 64) return v;
  mask = (((uint64_t)1 << bits) - 1u);
  u = (uint64_t)v & mask;
  if (u & ((uint64_t)1 << (bits - 1))) u |= ~mask;
  return fxp_u2s(u);
}

static inline int32_t fxp_sat(int64_t v, int32_t qmin, int32_t qmax) {
  if (v < (int64_t)qmin) return qmin;
  if (v > (int64_t)qmax) return qmax;
  return (int32_t)v;
}

static inline int64_t fxp_mul_wrap(int64_t a, int64_t b) {
  return fxp_u2s((uint64_t)a * (uint64_t)b);
}

/* _rshift_round: floor-shift + remainder, round-to-nearest, ties away
 * from zero; exact for every representable input including dtype extremes */
static inline int64_t fxp_rshr(int64_t x, int m) {
  int64_t half, floor_q, rem;
  if (m == 0) return x;
  half = (int64_t)1 << (m - 1);
  floor_q = x >> m;
  rem = x - fxp_shl(floor_q, m);
  return floor_q + ((rem > half - (x >= 0)) ? 1 : 0);
}

/* requantize: saturate(round_shift(acc, shift)) */
static inline int32_t fxp_requant(int64_t acc, int shift, int32_t qmin,
                                  int32_t qmax) {
  return fxp_sat(fxp_rshr(acc, shift), qmin, qmax);
}

static inline int32_t fxp_qmul(int32_t a, int32_t b, int m, int32_t qmin,
                               int32_t qmax) {
  return fxp_requant((int64_t)a * (int64_t)b, m, qmin, qmax);
}

/* qdiv: (a << m) / b, truncating magnitude division then round-to-nearest
 * ties away from zero; b == 0 saturates by the sign of a */
static inline int32_t fxp_qdiv(int32_t a, int32_t b, int m, int32_t qmin,
                               int32_t qmax) {
  int64_t wa, q_trunc;
  uint64_t ua, ub, q, r;
  int negative;
  if (b == 0) return (a >= 0) ? qmax : qmin;
  wa = fxp_shl((int64_t)a, m);
  negative = (wa < 0) != (b < 0);
  ua = (wa < 0) ? (uint64_t)0 - (uint64_t)wa : (uint64_t)wa;
  ub = (b < 0) ? (uint64_t)0 - (uint64_t)(int64_t)b : (uint64_t)(int64_t)b;
  q = ua / ub;
  r = ua % ub;
  q_trunc = negative ? -fxp_u2s(q) : fxp_u2s(q);
  if (2u * r >= ub) q_trunc += negative ? -1 : 1;
  return fxp_sat(q_trunc, qmin, qmax);
}

/* qexp: exp(x) = 2^(x*log2e) = 2^k * 2^f with a cubic 2^f polynomial; the
 * overflow-detecting left shift deliberately wraps at the wide width,
 * exactly like the traced op */
static inline int32_t fxp_qexp(int32_t x, int m, int tb, int wb, int ib,
                               int32_t qmin, int32_t qmax, int64_t log2e_q,
                               int64_t c0, int64_t c1, int64_t c2,
                               int64_t c3) {
  int64_t y = fxp_rshr(fxp_wrap(fxp_mul_wrap((int64_t)x, log2e_q), wb), m);
  int64_t k = y >> m;
  int64_t f = y - fxp_shl(k, m);
  int32_t k_i32 = (int32_t)fxp_wrap(k, 32);
  int32_t k_cl = (k_i32 < -tb) ? -tb : ((k_i32 > tb) ? tb : k_i32);
  int pos = (k_cl > 0) ? k_cl : 0;
  int neg = (k_cl < 0) ? -k_cl : 0;
  int s_up = (pos < tb - 1) ? pos : (tb - 1);
  int s_dn = (neg < tb + m) ? neg : (tb + m);
  int64_t acc = c3;
  int64_t shifted_up, up, out;
  acc = fxp_wrap(fxp_rshr(fxp_wrap(fxp_mul_wrap(acc, f), wb), m) + c2, wb);
  acc = fxp_wrap(fxp_rshr(fxp_wrap(fxp_mul_wrap(acc, f), wb), m) + c1, wb);
  acc = fxp_wrap(fxp_rshr(fxp_wrap(fxp_mul_wrap(acc, f), wb), m) + c0, wb);
  shifted_up = fxp_wrap(fxp_shl(acc, s_up), wb);
  up = ((shifted_up >> s_up) != acc) ? (int64_t)qmax : shifted_up;
  out = (k_cl >= 0) ? up : (acc >> s_dn);
  if (k_i32 >= ib) out = (int64_t)qmax;
  return fxp_sat(out, qmin, qmax);
}

/* square-and-multiply x**p, multiplicative identity = quantized 1.0 */
static inline int32_t fxp_qpow(int32_t x, int p, int m, int32_t one,
                               int32_t qmin, int32_t qmax) {
  int32_t out = one;
  int32_t base = x;
  while (p) {
    if (p & 1) out = fxp_qmul(out, base, m, qmin, qmax);
    base = fxp_qmul(base, base, m, qmin, qmax);
    p >>= 1;
  }
  return out;
}

/* sigmoid variants — constants quantized host-side, passed as integers */
static inline int32_t fxp_qsig_exact(int32_t x, int m, int tb, int wb,
                                     int ib, int32_t qmin, int32_t qmax,
                                     int32_t one, int64_t log2e_q, int64_t c0,
                                     int64_t c1, int64_t c2, int64_t c3) {
  int64_t na = (x < 0) ? (int64_t)x : -(int64_t)x;
  int32_t e = fxp_qexp(fxp_sat(na, qmin, qmax), m, tb, wb, ib, qmin, qmax,
                       log2e_q, c0, c1, c2, c3);
  int32_t denom = fxp_sat((int64_t)one + (int64_t)e, qmin, qmax);
  int32_t pos = fxp_qdiv(one, denom, m, qmin, qmax);
  int32_t neg = fxp_sat((int64_t)one - (int64_t)pos, qmin, qmax);
  return (x >= 0) ? pos : neg;
}

static inline int32_t fxp_qsig_pwl2(int32_t x, int64_t one, int64_t half,
                                    int32_t qmin, int32_t qmax) {
  int64_t ramp = fxp_rshr((int64_t)x, 2) + half;
  if (ramp < 0) ramp = 0;
  if (ramp > one) ramp = one;
  return fxp_sat(ramp, qmin, qmax);
}

static inline int32_t fxp_qsig_pwl4(int32_t x, int32_t qmin, int32_t qmax,
                                    int64_t one, int64_t half, int64_t t5,
                                    int64_t t2375, int64_t t1,
                                    int64_t c84375, int64_t c625) {
  int64_t ax = (x < 0) ? -(int64_t)x : (int64_t)x;
  int64_t y;
  if (ax >= t5) y = one;
  else if (ax >= t2375) y = fxp_rshr(ax, 5) + c84375;
  else if (ax >= t1) y = fxp_rshr(ax, 3) + c625;
  else y = fxp_rshr(ax, 2) + half;
  if (x < 0) y = one - y;
  return fxp_sat(y, qmin, qmax);
}

static inline int32_t fxp_qsig_rational(int32_t x, int m, int32_t qmin,
                                        int32_t qmax, int64_t one,
                                        int64_t half) {
  int64_t ax = (x < 0) ? -(int64_t)x : (int64_t)x;
  int32_t denom = fxp_sat(ax + one, qmin, qmax);
  int32_t ratio = fxp_qdiv(x, denom, m, qmin, qmax);
  return fxp_sat(half + fxp_rshr((int64_t)ratio, 1), qmin, qmax);
}

/* first-occurrence argmax == jnp.argmax */
static inline int32_t fxp_argmax(const int32_t *v, int n) {
  int32_t best = 0;
  int i;
  for (i = 1; i < n; ++i) {
    if (v[i] > v[best]) best = i;
  }
  return best;
}
"""


def _act_call(var: str, act: str, p: _P) -> str:
    """C expression applying the quantized activation ``act`` to ``var``."""
    if act == "none":
        return var
    fmt = p.fmt
    if act == "exact":
        log2e, (c0, c1, c2, c3) = fxp.exp_poly_consts(fmt)
        one = fxp.one_q(fmt)
        return (f"fxp_qsig_exact({var}, {p.m}, {p.tb}, {p.wb}, {p.ib}, "
                f"{_ci(p.qmin)}, {_ci(p.qmax)}, {_ci(one)}, {_ci(log2e)}, "
                f"{_ci(c0)}, {_ci(c1)}, {_ci(c2)}, {_ci(c3)})")
    if act == "pwl2":
        return (f"fxp_qsig_pwl2({var}, {_ci(fxp.one_q(fmt))}, "
                f"{_ci(int(fmt.scale) >> 1)}, {_ci(p.qmin)}, {_ci(p.qmax)})")
    if act == "pwl4":
        c = act_mod.pwl4_consts(fmt)
        return (f"fxp_qsig_pwl4({var}, {_ci(p.qmin)}, {_ci(p.qmax)}, "
                f"{_ci(c['one'])}, {_ci(c['half'])}, {_ci(c['t5'])}, "
                f"{_ci(c['t2375'])}, {_ci(c['t1'])}, {_ci(c['c84375'])}, "
                f"{_ci(c['c625'])})")
    if act == "rational":
        one = int(fmt.scale)
        return (f"fxp_qsig_rational({var}, {p.m}, {_ci(p.qmin)}, "
                f"{_ci(p.qmax)}, {_ci(one)}, {_ci(one >> 1)})")
    raise EmitError(f"unknown activation '{act}'")


def _matvec(out_var: str, in_name: str, w_name: str, n_in: int,
            shift: int, out_p: _P, bias_name: str, row: str = "j") -> List[str]:
    """One output element of a fused layer: wide-accumulate matvec row +
    requantize + saturating bias add — ``fxp_layer_ref`` bit for bit."""
    return [
        f"    uint64_t acc = 0u;",
        f"    int32_t h;",
        f"    for (k = 0; k < {n_in}; ++k) {{",
        f"      acc += (uint64_t)((int64_t){in_name}[k]"
        f" * (int64_t){w_name}[{row}][k]);",
        f"    }}",
        f"    h = fxp_requant(fxp_wrap(fxp_u2s(acc), {out_p.wb}), {shift}, "
        f"{_ci(out_p.qmin)}, {_ci(out_p.qmax)});",
        f"    h = fxp_sat((int64_t)h + (int64_t){bias_name}[{row}], "
        f"{_ci(out_p.qmin)}, {_ci(out_p.qmax)});",
        f"    {out_var} = h;",
    ]


# --------------------------------------------------------------------------
# per-family emitters
# --------------------------------------------------------------------------
def _emit_layers(spec: Dict[str, Any], lines: List[str],
                 arrays: List[str]) -> None:
    """Shared linear/MLP body: chained fused layers + argmax."""
    if spec["family"] == "linear":
        ws = [spec["w"]]
        bs = [spec["b"]]
        out_fmts = [spec["out_fmt"]]
        shifts = [spec["shift"]]
        acts = ["none"]
    else:
        ws, bs = spec["ws"], spec["bs"]
        out_fmts, shifts, acts = spec["out_fmts"], spec["shifts"], spec["acts"]
    in_p = _P(spec["in_fmt"])
    n_layers = len(ws)
    dims = [int(ws[0].shape[0])] + [int(w.shape[1]) for w in ws]

    for i, (w, b) in enumerate(zip(ws, bs)):
        # Emit W transposed (out, in) so each output row is contiguous.
        arrays.append(_carray(f"EMB_W{i}", np.asarray(w).T,
                              CTYPES[spec_ctbits(w)]))
        arrays.append(_carray(f"EMB_B{i}", np.asarray(b),
                              CTYPES[spec_ctbits(b)]))

    lines.append(f"int32_t emb_predict(const {in_p.ctype} *x) {{")
    for i in range(n_layers - 1):
        lines.append(f"  int32_t h{i}[{dims[i + 1]}];")
    lines.append(f"  int32_t out[{dims[-1]}];")
    lines.append("  int j, k;")
    for i, (fo, shift, act) in enumerate(zip(out_fmts, shifts, acts)):
        p = _P(fo)
        src = "x" if i == 0 else f"h{i - 1}"
        dst = "out" if i == n_layers - 1 else f"h{i}"
        lines.append(f"  /* layer {i}: {dims[i]} -> {dims[i + 1]}, "
                     f"shift {shift}, activation {act} */")
        lines.append(f"  for (j = 0; j < {dims[i + 1]}; ++j) {{")
        lines += _matvec(f"{dst}[j]", src, f"EMB_W{i}", dims[i], shift, p,
                         f"EMB_B{i}")
        if act != "none":
            lines.append(f"    {dst}[j] = {_act_call(f'{dst}[j]', act, p)};")
        lines.append("  }")
    lines.append(f"  return fxp_argmax(out, {dims[-1]});")
    lines.append("}")


def spec_ctbits(arr: np.ndarray) -> int:
    """Container bits of a quantized numpy array (its itemsize)."""
    return int(np.asarray(arr).dtype.itemsize) * 8


def _emit_svm(spec: Dict[str, Any], lines: List[str],
              arrays: List[str]) -> None:
    p = _P(spec["fmt"])
    op = _P(spec["out_fmt"])
    sv = np.asarray(spec["sv"])
    dual = np.asarray(spec["dual"])
    icept = np.asarray(spec["b"])
    ns, nf = sv.shape
    nc = dual.shape[1]
    kernel = spec["kernel"]
    dec_shift = spec["dec_shift"]
    qgamma, qcoef0 = _ci(spec["qgamma"]), _ci(spec["qcoef0"])

    arrays.append(_carray("EMB_SV", sv, CTYPES[spec_ctbits(sv)]))
    arrays.append(_carray("EMB_DUAL", dual.T, CTYPES[spec_ctbits(dual)]))
    arrays.append(_carray("EMB_ICEPT", icept, CTYPES[spec_ctbits(icept)]))

    if kernel == "rbf":
        lines.append(f"""\
/* sum(q^2) at the wide width, one rounded shift + saturation at the end
 * (products wrap at the wide dtype, the sum accumulates mod 2^64 — the
 * traced _qsq_norm semantics) */
static int32_t emb_qsq_norm(const {p.ctype} *v, int n) {{
  uint64_t acc = 0u;
  int i;
  for (i = 0; i < n; ++i) {{
    int64_t q = (int64_t)v[i];
    acc += (uint64_t)fxp_wrap(fxp_mul_wrap(q, q), {p.wb});
  }}
  return fxp_requant(fxp_u2s(acc), {p.m}, {_ci(p.qmin)}, {_ci(p.qmax)});
}}

/* |sv_s|^2, computed once on first use (RAM, not flash) */
static int32_t emb_sv2[{ns}];
static int emb_sv2_ready = 0;
""")

    lines.append(f"int32_t emb_predict(const {p.ctype} *x) {{")
    lines.append(f"  int32_t kv[{ns}];")
    lines.append(f"  int32_t out[{nc}];")
    lines.append("  int s, c, k;")
    if kernel == "rbf":
        lines.append(f"""\
  int32_t x2;
  if (!emb_sv2_ready) {{
    for (s = 0; s < {ns}; ++s) {{
      emb_sv2[s] = emb_qsq_norm(EMB_SV[s], {nf});
    }}
    emb_sv2_ready = 1;
  }}
  x2 = emb_qsq_norm(x, {nf});""")
    lines.append(f"  /* kernel row: x . sv_s, shift {p.m} */")
    lines.append(f"  for (s = 0; s < {ns}; ++s) {{")
    lines.append(f"    uint64_t acc = 0u;")
    lines.append(f"    int32_t dot, t;")
    lines.append(f"    for (k = 0; k < {nf}; ++k) {{")
    lines.append(f"      acc += (uint64_t)((int64_t)x[k]"
                 f" * (int64_t)EMB_SV[s][k]);")
    lines.append(f"    }}")
    lines.append(f"    dot = fxp_requant(fxp_wrap(fxp_u2s(acc), {p.wb}), "
                 f"{p.m}, {_ci(p.qmin)}, {_ci(p.qmax)});")
    if kernel == "poly":
        lines.append(f"    /* k = (gamma * dot + coef0) ** degree */")
        lines.append(f"    t = fxp_sat((int64_t)fxp_qmul(dot, {qgamma}, "
                     f"{p.m}, {_ci(p.qmin)}, {_ci(p.qmax)}) + "
                     f"(int64_t){qcoef0}, {_ci(p.qmin)}, {_ci(p.qmax)});")
        lines.append(f"    kv[s] = fxp_qpow(t, {int(spec['degree'])}, {p.m}, "
                     f"{_ci(fxp.one_q(spec['fmt']))}, {_ci(p.qmin)}, "
                     f"{_ci(p.qmax)});")
    else:
        log2e, (c0, c1, c2, c3) = fxp.exp_poly_consts(spec["fmt"])
        lines.append(f"    /* k = exp(-gamma * (x2 - 2 dot + sv2)) */")
        lines.append(f"    t = fxp_sat((int64_t)dot + (int64_t)dot, "
                     f"{_ci(p.qmin)}, {_ci(p.qmax)});")
        lines.append(f"    t = fxp_sat((int64_t)x2 - (int64_t)t, "
                     f"{_ci(p.qmin)}, {_ci(p.qmax)});")
        lines.append(f"    t = fxp_sat((int64_t)t + (int64_t)emb_sv2[s], "
                     f"{_ci(p.qmin)}, {_ci(p.qmax)});")
        lines.append(f"    t = fxp_sat(-(int64_t)fxp_qmul(t, {qgamma}, "
                     f"{p.m}, {_ci(p.qmin)}, {_ci(p.qmax)}), "
                     f"{_ci(p.qmin)}, {_ci(p.qmax)});")
        lines.append(f"    kv[s] = fxp_qexp(t, {p.m}, {p.tb}, {p.wb}, "
                     f"{p.ib}, {_ci(p.qmin)}, {_ci(p.qmax)}, {_ci(log2e)}, "
                     f"{_ci(c0)}, {_ci(c1)}, {_ci(c2)}, {_ci(c3)});")
    lines.append("  }")
    lines.append(f"  /* decision: kv @ dual + intercept, shift {dec_shift} */")
    lines.append(f"  for (c = 0; c < {nc}; ++c) {{")
    lines.append(f"    uint64_t acc = 0u;")
    lines.append(f"    int32_t h;")
    lines.append(f"    for (s = 0; s < {ns}; ++s) {{")
    lines.append(f"      acc += (uint64_t)((int64_t)kv[s]"
                 f" * (int64_t)EMB_DUAL[c][s]);")
    lines.append(f"    }}")
    lines.append(f"    h = fxp_requant(fxp_wrap(fxp_u2s(acc), {op.wb}), "
                 f"{dec_shift}, {_ci(op.qmin)}, {_ci(op.qmax)});")
    lines.append(f"    out[c] = fxp_sat((int64_t)h + (int64_t)EMB_ICEPT[c], "
                 f"{_ci(op.qmin)}, {_ci(op.qmax)});")
    lines.append("  }")
    lines.append(f"  return fxp_argmax(out, {nc});")
    lines.append("}")


def _emit_tree(spec: Dict[str, Any], lines: List[str],
               arrays: List[str]) -> None:
    p = _P(spec["in_fmt"])
    thr = np.asarray(spec["threshold"])
    n = thr.shape[0]
    steps = int(spec["max_depth"]) + 1
    arrays.append(_carray("EMB_FEAT", np.asarray(spec["feature"], np.int16),
                          "int16_t"))
    arrays.append(_carray("EMB_THR", thr, CTYPES[spec_ctbits(thr)]))
    arrays.append(_carray("EMB_LEFT", np.asarray(spec["left"], np.int16),
                          "int16_t"))
    arrays.append(_carray("EMB_RIGHT", np.asarray(spec["right"], np.int16),
                          "int16_t"))
    arrays.append(_carray("EMB_LEAF",
                          np.asarray(spec["leaf_class"], np.int8), "int8_t"))
    lines.append(f"int32_t emb_predict(const {p.ctype} *x) {{")
    lines.append(f"  int32_t node = 0;")
    lines.append(f"  int d;")
    lines.append(f"  /* iterative traversal of {n} nodes, {steps} bounded "
                 f"steps; leaves (feature < 0) are absorbing */")
    lines.append(f"  for (d = 0; d < {steps}; ++d) {{")
    lines.append(f"    int32_t f = (int32_t)EMB_FEAT[node];")
    lines.append(f"    if (f >= 0) {{")
    lines.append(f"      node = (x[f] <= EMB_THR[node])")
    lines.append(f"             ? (int32_t)EMB_LEFT[node]")
    lines.append(f"             : (int32_t)EMB_RIGHT[node];")
    lines.append(f"    }}")
    lines.append(f"  }}")
    lines.append(f"  return (int32_t)EMB_LEAF[node];")
    lines.append("}")


# --------------------------------------------------------------------------
# entry point + the no-float guarantee
# --------------------------------------------------------------------------
def emit_c(spec: Dict[str, Any], kind: str = "", target_name: str = "",
           fingerprint: str = "") -> str:
    """Emit the complete freestanding C99 translation unit for ``spec``."""
    in_fmt = input_format(spec)
    in_p = _P(in_fmt)
    arrays: List[str] = []
    body: List[str] = []
    family = spec["family"]
    if family in ("linear", "mlp"):
        _emit_layers(spec, body, arrays)
    elif family == "svm":
        _emit_svm(spec, body, arrays)
    elif family == "tree":
        _emit_tree(spec, body, arrays)
    else:
        raise EmitError(f"no C emitter for family '{family}'")

    fp = f" fingerprint={fingerprint[:16]}" if fingerprint else ""
    header = f"""\
/* Generated by repro_torch.emit — EmbML-style fixed-point classifier.
 * kind={kind or family} target={target_name}{fp}
 * Freestanding integer-only C99: <stdint.h> is the only include, there is
 * no libc call and no floating-point operation.  Inputs are the host-side
 * quantized feature vector (container {in_p.ctype}, {in_p.m} fractional
 * bits); emb_predict returns the argmax class id.  Semantics mirror
 * repro_torch/core/fixedpoint.py exactly — the golden vectors replayed
 * through this translation unit are the cross-language oracle.
 */
#include <stdint.h>
"""
    src = "\n".join([header, _RUNTIME, "", "\n\n".join(arrays), ""]
                    + body) + "\n"
    assert_integer_only(src)
    return src


_COMMENT_RE = re.compile(r"/\*.*?\*/", re.S)
_FLOAT_TOKEN_RE = re.compile(
    r"\b(float|double|long\s+double)\b"  # float types
    r"|\d\.\d|\.\d|\d\."                 # decimal-point literals
    r"|\b\d+[eE][-+]?\d+\b"              # exponent literals
    r"|\b0[xX][0-9a-fA-F.]+[pP]"         # hex floats
    r"|#\s*include\s*<(?!stdint\.h)")    # any include beyond stdint


def assert_integer_only(source: str) -> None:
    """Prove the generated C contains no floating-point token and includes
    nothing but ``<stdint.h>`` — the paper's no-FPU guarantee, enforced
    syntactically on every emission (comments are exempt)."""
    code = _COMMENT_RE.sub("", source)
    m = _FLOAT_TOKEN_RE.search(code)
    if m:
        line = code.count("\n", 0, m.start()) + 1
        raise EmitError(
            f"generated C is not integer-only: found {m.group(0)!r} "
            f"(stripped-source line {line})")
