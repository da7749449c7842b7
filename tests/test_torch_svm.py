"""The kernel-SVM kernels' plain versions against the reference package
(bit-exact).

* ``fxp_svm_model_plain`` against ``fxp_svm_model_pallas`` run in interpret
  mode, and ``fxp_qmatmul_plain`` against ``fxp_qmatmul_pallas``: poly and
  rbf at 8/16/32 bits, on typical values, on rows at qmin/qmax, on
  full-range values whose x . sv^T wraps the int32 accumulator and whose
  sums of squares wrap int32 (16-bit) or int64 (32-bit).
* The port's int64 oracles of ``kernels/ref.py`` against the reference's.
* Routing of the new wrappers, and the shared-memory fit predicate that
  sends the paper's D5 and D6 SVMs to the megakernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables jax x64, as the reference runs)
from repro.core import fixedpoint as jfx
from repro.kernels import ref as jref
from repro.kernels.fxp_model import fxp_svm_model_pallas
from repro.kernels.fxp_qmatmul import fxp_qmatmul_pallas
from repro_torch.core import fixedpoint as tfx
from repro_torch.kernels import fxp_model as tmodel
from repro_torch.kernels import fxp_qmatmul as tqm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

NP = {8: np.int8, 16: np.int16, 32: np.int32}
M, F, S, C = 12, 24, 20, 5
REGIMES = ("typical", "edge", "wrap")


def _ints(rng, shape, bits, mag=None):
    lo, hi = (-(2 ** (bits - 1)), 2 ** (bits - 1) - 1) if mag is None else \
        (-(2 ** mag), 2 ** mag - 1)
    return rng.randint(lo, hi + 1, shape, dtype=np.int64).astype(NP[bits])


def _case(bits, regime, seed):
    """(qx, sv, dual, icept, fmt frac, out frac, qgamma, qcoef0, dec_shift)."""
    rng = np.random.RandomState(seed * 7 + bits)
    qmin, qmax = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    if regime == "typical":
        mag = {8: 3, 16: 6, 32: 11}[bits]
        frac = {8: 2, 16: 4, 32: 10}[bits]
        qx, sv = _ints(rng, (M, F), bits, mag), _ints(rng, (S, F), bits, mag)
    else:
        frac = {8: 5, 16: 12, 32: 24}[bits] if regime == "edge" else bits - 2
        qx, sv = _ints(rng, (M, F), bits), _ints(rng, (S, F), bits)
        if regime == "edge":  # whole rows at the container's extremes
            qx[0], qx[1], sv[0], sv[1] = qmax, qmin, qmax, qmin
            qx[2, ::2], qx[2, 1::2] = qmax, qmin
    dual = _ints(rng, (S, C), bits, {8: 4, 16: 8, 32: 14}[bits])
    icept = _ints(rng, (C,), bits)
    icept[:2] = qmax, qmin
    out_frac = max(0, frac - 1)
    one = 2 ** frac
    qgamma = int(rng.randint(1, min(qmax, 3 * one)))
    qcoef0 = int(rng.randint(-min(qmax, one), min(qmax, one)))
    dec_shift = frac + (frac // 2) - out_frac
    return qx, sv, dual, icept, frac, out_frac, qgamma, qcoef0, dec_shift


def _same(j, t):
    j = np.asarray(j)
    t = t.numpy()
    assert j.dtype == t.dtype, (j.dtype, t.dtype)
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("kind", ["poly", "rbf"])
@pytest.mark.parametrize("bits", [8, 16, 32])
def test_fxp_svm_model_plain_matches_pallas(bits, kind, regime):
    qx, sv, dual, icept, frac, out_frac, qg, qc, dec = _case(
        bits, regime, seed=REGIMES.index(regime))
    if regime == "wrap" and bits > 8:
        true = qx.astype(np.int64) @ sv.astype(np.int64).T
        assert np.abs(true).max() >= 2 ** 31  # x . sv^T wraps int32
        sq = (qx.astype(np.float64) ** 2).sum(1)
        assert sq.max() >= (2 ** 31 if bits == 16 else 2 ** 63)
    degree = {"typical": 2, "edge": 3, "wrap": 1}[regime]
    jf, jo = jfx.FxpFormat(bits, frac), jfx.FxpFormat(bits, out_frac)
    tf, to = tfx.FxpFormat(bits, frac), tfx.FxpFormat(bits, out_frac)
    j_args = [jnp.asarray(v) for v in (qx, sv, dual, icept)]
    t_args = [torch.from_numpy(v) for v in (qx, sv, dual, icept)]
    want = fxp_svm_model_pallas(*j_args, kind, jf, jo, qg, qc, degree, dec,
                                bm=M // 2, interpret=True)
    got = tmodel.fxp_svm_model_plain(*t_args, kind, tf, to, qg, qc, degree,
                                     dec)
    _same(want, got)
    # the int64-accumulating oracles agree with each other
    _same(jref.fxp_svm_model_ref(*j_args, kind, jf, jo, qg, qc, degree, dec),
          tref.fxp_svm_model_ref(*t_args, kind, tf, to, qg, qc, degree, dec))
    # the chained per-layer spelling equals the megakernel's function
    dot = tqm.fxp_qmatmul_plain(t_args[0], t_args[1].T.contiguous(), tf)
    k = tref.svm_kernel_values(dot, t_args[0], t_args[1], kind, tf, qg, qc,
                               degree)
    chained = tops.fxp_layer(k, t_args[2], t_args[3], to, "none", dec)
    assert torch.equal(chained, got)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_poly_degrees_match_pallas(degree):
    qx, sv, dual, icept, frac, out_frac, qg, qc, dec = _case(16, "typical", 9)
    jf, jo = jfx.FxpFormat(16, frac), jfx.FxpFormat(16, out_frac)
    tf, to = tfx.FxpFormat(16, frac), tfx.FxpFormat(16, out_frac)
    want = fxp_svm_model_pallas(
        *[jnp.asarray(v) for v in (qx, sv, dual, icept)], "poly", jf, jo, qg,
        qc, degree, dec, bm=M, interpret=True)
    got = tmodel.fxp_svm_model_plain(
        *[torch.from_numpy(v) for v in (qx, sv, dual, icept)], "poly", tf, to,
        qg, qc, degree, dec)
    _same(want, got)


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("bits", [8, 16, 32])
def test_fxp_qmatmul_plain_matches_pallas(bits, regime):
    qx, sv, _, _, frac, _, _, _, _ = _case(bits, regime, seed=3)
    b = np.ascontiguousarray(sv.T)  # (F, S)
    jf, tf = jfx.FxpFormat(bits, frac), tfx.FxpFormat(bits, frac)
    # bk = F // 3: the accumulator is carried across three K grid steps
    want = fxp_qmatmul_pallas(jnp.asarray(qx), jnp.asarray(b), jf, bm=M, bn=S,
                              bk=F // 3, interpret=True)
    got = tqm.fxp_qmatmul_plain(torch.from_numpy(qx), torch.from_numpy(b), tf)
    _same(want, got)
    _same(jref.fxp_qmatmul_ref(jnp.asarray(qx), jnp.asarray(b), jf),
          tref.fxp_qmatmul_ref(torch.from_numpy(qx), torch.from_numpy(b), tf))


@pytest.mark.parametrize("bits", [8, 16, 32])
def test_squared_norms_match_reference(bits):
    """qsq_norm: int64 sums at every width, wrapping mod 2^64 at 32 bits."""
    rng = np.random.RandomState(bits)
    q = _ints(rng, (9, 561), bits)
    q[0], q[1] = 2 ** (bits - 1) - 1, -(2 ** (bits - 1))
    for frac in (0, bits // 2, bits - 1):
        jf, tf = jfx.FxpFormat(bits, frac), tfx.FxpFormat(bits, frac)
        wide = jnp.asarray(q).astype(jf.wide_dtype)
        want = jfx.rshift_round_saturate(jnp.sum(wide * wide, -1), jf)
        _same(want, tfx.qsq_norm(torch.from_numpy(q), tf))


def test_svm_wrappers_route_and_fit_predicate():
    qx, sv, dual, icept, frac, out_frac, qg, qc, dec = _case(16, "typical", 4)
    tf, to = tfx.FxpFormat(16, frac), tfx.FxpFormat(16, out_frac)
    t = [torch.from_numpy(v) for v in (qx, sv, dual, icept)]
    svt = t[1].T.contiguous()
    before = (tmodel.fxp_svm_model_cuda.launches, tqm.fxp_qmatmul_cuda.launches)
    with tops.count_dispatches() as c:
        got = tops.fxp_svm_model(*t, "rbf", tf, to, qg, qc, 2, dec)
        dot = tops.fxp_qmatmul(t[0], svt, tf)
    assert c.count == 2
    assert (tmodel.fxp_svm_model_cuda.launches,
            tqm.fxp_qmatmul_cuda.launches) == before  # CPU: plain versions
    assert torch.equal(got, tmodel.fxp_svm_model_plain(
        *t, "rbf", tf, to, qg, qc, 2, dec))
    assert torch.equal(dot, tqm.fxp_qmatmul_plain(t[0], svt, tf))
    assert torch.equal(
        tops.fxp_svm_model(*t, "poly", tf, to, qg, qc, 2, dec, impl="ref"),
        tref.fxp_svm_model_ref(*t, "poly", tf, to, qg, qc, 2, dec))
    assert torch.equal(tops.fxp_qmatmul(t[0], svt, tf, impl="ref"),
                       tref.fxp_qmatmul_ref(t[0], svt, tf))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tmodel.fxp_svm_model_cuda(*t, "rbf", tf, to, qg, qc, 2, dec)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tqm.fxp_qmatmul_cuda(t[0], svt, tf)
    with pytest.raises(KeyError):
        tmodel.fxp_svm_model_plain(*t, "sigmoid", tf, to, qg, qc, 2, dec)
    # The paper's D5 and D6 SVMs (300 support vectors) take the megakernel
    # at every width; the tile of kernel values bounds the support set.
    assert tmodel.svm_smem_bytes(300) == 4 * (32 * 300 + 300 + 32) + 8448
    assert tmodel.svm_fits_smem(300)
    assert tmodel.svm_fits_smem(1696) and not tmodel.svm_fits_smem(1697)
