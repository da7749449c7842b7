"""repro_torch.core against repro.core, element by element (bit-exact).

Every ported fixed-point and activation function runs on the same integer
inputs in both packages: container edges (qmin, qmin+1, -1, 0, 1, qmax-1,
qmax) plus seeded random values, across 8/16/32-bit containers including
Q0.m formats (no integer bits) and Qn.0 formats, shifts 0 and width-1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables jax x64, as the reference runs)
from repro.core import activations as jact
from repro.core import fixedpoint as jfx
from repro_torch.core import activations as tact
from repro_torch.core import fixedpoint as tfx

FORMATS = [(8, 0), (8, 2), (8, 7), (16, 0), (16, 4), (16, 15), (32, 0),
           (32, 10), (32, 31)]
FMT_IDS = [f"w{b}m{m}" for b, m in FORMATS]
NP_DTYPES = {8: np.int8, 16: np.int16, 32: np.int32, 64: np.int64}


def _fmts(bits, frac):
    return jfx.FxpFormat(bits, frac), tfx.FxpFormat(bits, frac)


def _edge_values(bits, n_random=200, seed=0):
    """Container edges plus seeded random values, as a numpy array."""
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    edges = [lo, lo + 1, -1, 0, 1, hi - 1, hi, lo // 2, hi // 2, 3, -3]
    rng = np.random.RandomState(seed + bits)
    rand = rng.randint(lo, hi, size=n_random, dtype=np.int64)
    small = rng.randint(-(1 << min(bits - 1, 12)), 1 << min(bits - 1, 12),
                        size=n_random)
    return np.concatenate([edges, rand, small]).astype(NP_DTYPES[bits])


def _same(j, t):
    j = np.asarray(j)
    t = t.numpy()
    assert j.dtype == t.dtype, (j.dtype, t.dtype)
    np.testing.assert_array_equal(t, j)


UNARY = ["qneg", "qexp", "qrecip", "qsigmoid", "qtanh", "qsqrt", "qrelu",
         "pow0", "pow1", "pow2", "pow3", "sig_exact", "sig_rational",
         "sig_pwl2", "sig_pwl4"]


def _unary(mod_fx, mod_act, name):
    if name.startswith("pow"):
        p = int(name[3:])
        return lambda x, f: mod_fx.qpow_int(x, p, f)
    if name.startswith("sig_"):
        return mod_act.get_qsigmoid(name[4:])
    return getattr(mod_fx, name)


@pytest.mark.parametrize("op", UNARY)
@pytest.mark.parametrize("bits,frac", FORMATS, ids=FMT_IDS)
def test_unary_ops_match(op, bits, frac):
    jf, tf = _fmts(bits, frac)
    x = _edge_values(bits)
    _same(_unary(jfx, jact, op)(jnp.asarray(x), jf),
          _unary(tfx, tact, op)(torch.from_numpy(x), tf))


@pytest.mark.parametrize("op", ["qadd", "qsub", "qmul", "qdiv"])
@pytest.mark.parametrize("bits,frac", FORMATS, ids=FMT_IDS)
def test_binary_ops_match(op, bits, frac):
    jf, tf = _fmts(bits, frac)
    v = _edge_values(bits, n_random=40)
    a, b = np.meshgrid(v, v)
    a, b = a.ravel(), b.ravel()
    _same(getattr(jfx, op)(jnp.asarray(a), jnp.asarray(b), jf),
          getattr(tfx, op)(torch.from_numpy(a), torch.from_numpy(b), tf))


@pytest.mark.parametrize(
    "acc_bits,bits,frac",
    [(acc, b, m) for acc in (16, 32, 64) for b, m in FORMATS if acc >= b],
    ids=lambda v: str(v))
def test_requantize_matches(acc_bits, bits, frac):
    """requantize / rshift_round_saturate over accumulator extremes, for
    shifts 0, 1, m, the container's width-1 and the accumulator's width-1."""
    jf, tf = _fmts(bits, frac)
    acc = _edge_values(acc_bits) if acc_bits < 64 else np.concatenate([
        np.array([np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1, 0, 1],
                 np.int64),
        np.random.RandomState(3).randint(-2 ** 62, 2 ** 62, 300,
                                         dtype=np.int64)])
    for shift in sorted({0, 1, frac, bits - 1, acc_bits - 1}):
        _same(jfx.requantize(jnp.asarray(acc), shift, jf),
              tfx.requantize(torch.from_numpy(acc), shift, tf))
    _same(jfx.rshift_round_saturate(jnp.asarray(acc), jf),
          tfx.rshift_round_saturate(torch.from_numpy(acc), tf))


@pytest.mark.parametrize("bits,frac", FORMATS, ids=FMT_IDS)
def test_quantize_and_stats_match(bits, frac):
    jf, tf = _fmts(bits, frac)
    rng = np.random.RandomState(bits * 100 + frac)
    scale = 2.0 ** (bits - 1 - frac)
    ties = (np.arange(-8, 9) + 0.5) / 2 ** frac  # round-half-even cases
    x = np.concatenate([
        rng.randn(300) * scale, rng.randn(100) * scale * 4, ties,
        [0.0, -0.0, 1e-9, -1e-9, 1e30, -1e30, np.inf, -np.inf, np.nan,
         jf.max_value, jf.min_value, jf.max_value + 1, 2.0 ** 21,
         2.0 ** (bits - 1 - frac)],
    ]).astype(np.float32)
    _same(jfx.quantize(jnp.asarray(x), jf), tfx.quantize(torch.from_numpy(x), tf))
    jq, js = jfx.quantize_with_stats(jnp.asarray(x), jf)
    tq, ts = tfx.quantize_with_stats(torch.from_numpy(x), tf)
    _same(jq, tq)
    for field in ("overflow", "underflow", "total"):
        assert int(getattr(js, field)) == int(getattr(ts, field)), field
    q = _edge_values(bits)
    np.testing.assert_array_equal(
        tfx.dequantize(torch.from_numpy(q), tf).numpy(),
        np.asarray(jfx.dequantize(jnp.asarray(q), jf)))


@pytest.mark.parametrize("case", ["small", "full", "wrap"])
@pytest.mark.parametrize("bits,frac", FORMATS[1::3] + [(8, 7), (32, 31)],
                         ids=lambda v: str(v))
def test_qmatmul_with_stats_matches(case, bits, frac):
    """The ``ref`` backend's matmul accumulates in ``wide_dtype`` and wraps
    there (int16 for 8-bit containers) — the port must wrap identically."""
    jf, tf = _fmts(bits, frac)
    rng = np.random.RandomState(7)
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    k = {"small": 9, "full": 33, "wrap": 300}[case]
    if case == "small":
        lo, hi = lo // 16, hi // 16
    a = rng.randint(lo, hi + 1, (17, k)).astype(NP_DTYPES[bits])
    b = rng.randint(lo, hi + 1, (k, 5)).astype(NP_DTYPES[bits])
    if case == "wrap":
        a[0], b[:, 0] = hi, hi  # a sum far past every accumulator width
    for shift in (None, 0, bits - 1):
        jo, js = jfx.qmatmul_with_stats(jnp.asarray(a), jnp.asarray(b), jf,
                                        shift)
        to, ts = tfx.qmatmul_with_stats(torch.from_numpy(a),
                                        torch.from_numpy(b), tf, shift)
        _same(jo, to)
        for field in ("overflow", "underflow", "total"):
            assert int(getattr(js, field)) == int(getattr(ts, field))
    _same(jfx.qmatmul(jnp.asarray(a), jnp.asarray(b), jf),
          tfx.qmatmul(torch.from_numpy(a), torch.from_numpy(b), tf))


@pytest.mark.parametrize("acc_dtype", [torch.int16, torch.int32, torch.int64])
@pytest.mark.parametrize("bits", [8, 16, 32])
def test_imatmul_is_exact_modulo_width(bits, acc_dtype):
    """imatmul against Python integers (no overflow) reduced mod 2^width."""
    rng = np.random.RandomState(bits)
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    a = rng.randint(lo, hi + 1, (6, 700), dtype=np.int64)
    b = rng.randint(lo, hi + 1, (700, 4), dtype=np.int64)
    a[0], b[:, 0] = lo, lo
    out = tfx.imatmul(torch.from_numpy(a.astype(NP_DTYPES[bits])),
                      torch.from_numpy(b.astype(NP_DTYPES[bits])), acc_dtype)
    width = torch.iinfo(acc_dtype).bits
    exact = a.astype(object) @ b.astype(object)
    wrapped = [[((int(v) + 2 ** (width - 1)) % 2 ** width) - 2 ** (width - 1)
                for v in row] for row in exact]
    assert out.dtype == acc_dtype
    assert out.tolist() == wrapped


def test_constants_and_stats_merge_match():
    for bits, frac in FORMATS:
        jf, tf = _fmts(bits, frac)
        assert jfx.one_q(jf) == tfx.one_q(tf)
        assert jfx.exp_poly_consts(jf) == tfx.exp_poly_consts(tf)
        assert jact.pwl4_consts(jf) == tact.pwl4_consts(tf)
        assert (tf.dtype, tf.wide_dtype) == (
            {8: torch.int8, 16: torch.int16, 32: torch.int32}[bits],
            {8: torch.int16, 16: torch.int32, 32: torch.int64}[bits])
    big = torch.tensor(2 ** 31 - 1, dtype=torch.int32)
    s = tfx.FxpStats(big, big, big)
    merged = s.merge(s)
    assert merged.total.dtype == torch.int64
    assert int(merged.total) == 2 * (2 ** 31 - 1)


@pytest.mark.parametrize("name", tact.SIGMOID_NAMES)
def test_float_sigmoids_match(name):
    """Float-domain sigmoids: the same IEEE float32 ops in both frameworks;
    ``exact`` is a library sigmoid on each side, held to 2 float32 ulps."""
    x = np.concatenate([np.linspace(-12, 12, 2001),
                        [-5.0, -2.375, -1.0, 0.0, 1.0, 2.375, 5.0]]
                       ).astype(np.float32)
    j = np.asarray(jact.get_sigmoid(name)(jnp.asarray(x)))
    t = tact.get_sigmoid(name)(torch.from_numpy(x)).numpy()
    if name == "exact":
        np.testing.assert_allclose(t, j, rtol=2.4e-7, atol=1.2e-7)
    else:
        np.testing.assert_array_equal(t, j)
