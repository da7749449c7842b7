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
* The CUDA megakernel's split of the decision sum over a cluster's blocks,
  modelled in plain torch for any split into G slices, against
  ``fxp_svm_model_plain``; the same for every slot of a fleet of models
  with their own parameters (the fleet kernel runs the same cluster body),
  against ``fxp_svm_fleet_plain``; and the cluster's launch plan, compiled
  for the host, for every support-vector count the predicates admit.
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
from repro_torch.kernels.fxp_layer import epilogue_plain
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


def _split_decision(k, dual, icept, out_fmt, dec_shift, slices):
    """A plain-torch model of the megakernel's split decision stage: each
    block's uint32 partial of k . dual over its slice of the support
    vectors (every product and sum taken mod 2^32 in int64), the cluster's
    sum of the partials mod 2^32, then the shared epilogue."""
    mask = (1 << 32) - 1
    total = torch.zeros((k.shape[0], dual.shape[1]), dtype=torch.int64)
    for a, b in slices:
        prods = (k[:, a:b, None].to(torch.int64)
                 * dual[None, a:b].to(torch.int64)) & mask
        total = (total + (prods.sum(1) & mask)) & mask
    acc = torch.where(total >= 2 ** 31, total - 2 ** 32, total)
    return epilogue_plain(acc.to(torch.int32), icept[None, :], out_fmt,
                          "none", dec_shift)


@pytest.mark.parametrize("kind", ["poly", "rbf"])
@pytest.mark.parametrize("n_sv", [33, 300])
@pytest.mark.parametrize("bits", [8, 16, 32])
def test_split_decision_stage_is_bit_exact(bits, n_sv, kind):
    """The CUDA megakernel splits the support vectors over a cluster and
    sums the blocks' uint32 partials.  Modelled in plain torch, splits into
    G slices equal ``fxp_svm_model_plain`` bit for bit, with duals at
    qmin/qmax and (poly) kernel values at qmin/qmax, so that the partial
    sums wrap at 16 and 32 bits; the kernel's own split is held to the
    plain version on the card (``tests/test_torch_cuda.py``)."""
    rng = np.random.RandomState(bits * 7 + n_sv)
    qmin, qmax = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    frac = bits // 4 + 2  # few fraction bits: qmul(dot, qmax) saturates
    fmt, out_fmt = tfx.FxpFormat(bits, frac), tfx.FxpFormat(bits, frac - 1)
    mag = None if kind == "poly" else bits // 4  # rbf: k away from 0
    qx, sv = (torch.from_numpy(_ints(rng, shape, bits, mag))
              for shape in ((M, F), (n_sv, F)))
    dual = torch.from_numpy(np.where(rng.rand(n_sv, C) < 0.5, qmin, qmax)
                            .astype(NP[bits]))
    icept = torch.from_numpy(_ints(rng, (C,), bits))
    qgamma, qcoef0 = (qmax, 0) if kind == "poly" else (1, 0)
    args = (kind, fmt, out_fmt, qgamma, qcoef0, 1, frac)
    want = tmodel.fxp_svm_model_plain(qx, sv, dual, icept, *args)
    dot = tfx.rshift_round_saturate(tfx.imatmul(qx, sv.T, torch.int32), fmt)
    k = tref.svm_kernel_values(dot, qx, sv, kind, fmt, qgamma, qcoef0, 1)
    if kind == "poly":  # kernel values at the container's extremes
        assert int((k == qmax).sum()) and int((k == qmin).sum())
        true = k.to(torch.float64) @ dual.to(torch.float64)
        assert bits == 8 or float(true.abs().max()) >= 2 ** 31  # sums wrap
    else:
        assert int((k != 0).sum()) > k.numel() // 2
    for g in (1, 2, 3, 5, 8):
        edges = [i * n_sv // g for i in range(g + 1)]
        slices = tuple(zip(edges, edges[1:]))
        got = _split_decision(k, dual, icept, out_fmt, frac, slices)
        assert torch.equal(got, want), (g, slices)


@pytest.mark.parametrize("kind", ["poly", "rbf"])
@pytest.mark.parametrize("bits", [8, 16, 32])
def test_fleet_split_decision_is_bit_exact(bits, kind):
    """The fleet kernel runs the cluster body on every model: slot e splits
    model e's support vectors over the cluster exactly as model e's own
    launch does.  E = 3 models, each with its own formats, q(gamma),
    q(coef0), degree and dec_shift, each split into G slices: every split
    equals the slot of ``fxp_svm_fleet_plain`` and ``fxp_svm_model_plain``
    of that model, with duals at qmin/qmax so that the partial sums wrap at
    16 and 32 bits."""
    rng = np.random.RandomState(bits * 13 + len(kind))
    e_models, n_sv = 3, 130
    qmin, qmax = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    mag = None if kind == "poly" else bits // 4
    qx, sv = (torch.from_numpy(_ints(rng, shape, bits, mag))
              for shape in ((e_models, M, F), (e_models, n_sv, F)))
    dual = torch.from_numpy(np.where(rng.rand(e_models, n_sv, C) < 0.5, qmin,
                                     qmax).astype(NP[bits]))
    icept = torch.from_numpy(_ints(rng, (e_models, C), bits))
    params = []
    for e in range(e_models):
        frac = bits // 4 + 2 - e % 2
        fmt, out_fmt = tfx.FxpFormat(bits, frac), tfx.FxpFormat(bits, frac - 1)
        if kind == "poly":  # model 0's kernel values at the extremes
            qgamma = qmax if e == 0 else int(rng.randint(1, qmax))
            qcoef0 = int(rng.randint(-(2 ** frac), 2 ** frac))
        else:
            qgamma, qcoef0 = 1 + e, 0
        params.append((fmt, out_fmt, qgamma, qcoef0, 1 + e, frac - e % 2))
    fleet = tmodel.fxp_svm_fleet_plain(qx, sv, dual, icept, kind, params)
    wrapped = 0
    for e, (fmt, out_fmt, qgamma, qcoef0, degree, dec) in enumerate(params):
        want = tmodel.fxp_svm_model_plain(qx[e], sv[e], dual[e], icept[e],
                                          kind, *params[e])
        assert torch.equal(fleet[e], want), e
        dot = tfx.rshift_round_saturate(
            tfx.imatmul(qx[e], sv[e].T, torch.int32), fmt)
        k = tref.svm_kernel_values(dot, qx[e], sv[e], kind, fmt, qgamma,
                                   qcoef0, degree)
        true = k.to(torch.float64) @ dual[e].to(torch.float64)
        wrapped += int(float(true.abs().max()) >= 2 ** 31)
        for g in (1, 2, 3, 5, 8):
            edges = [i * n_sv // g for i in range(g + 1)]
            slices = tuple(zip(edges, edges[1:]))
            got = _split_decision(k, dual[e], icept[e], out_fmt, dec, slices)
            assert torch.equal(got, want), (e, g, slices)
    assert bits == 8 or kind == "rbf" or wrapped  # poly sums wrap


SVM_PLAN_HARNESS = r"""
#include "fxp_svm_body.cuh"
extern "C" int plan(int S, int* out) {
  fxp::SvmPlan p;
  if (!fxp::svm_plan(S, &p)) return 0;
  out[0] = p.n_chunks; out[1] = p.g; out[2] = p.cap; out[3] = p.smem;
  return 1;
}
extern "C" void rank_chunks(int rank, int g, int n_chunks, int* out) {
  fxp::svm_rank_chunks(rank, g, n_chunks, out, out + 1);
}
extern "C" int plan_rows(int S, int rows, int* out) {
  fxp::SvmPlan p;
  if (!fxp::svm_plan(S, &p, rows)) return 0;
  out[0] = p.n_chunks; out[1] = p.g; out[2] = p.cap; out[3] = p.smem;
  return 1;
}
"""


def test_cluster_plan_splits_every_admitted_model(tmp_path_factory,
                                                  monkeypatch):
    """The cluster body's plan (``svm_plan`` in ``csrc/fxp_svm_body.cuh``,
    compiled for the host): for every S the routing predicate admits, a
    cluster of at most 8 blocks whose ranks own contiguous, non-empty runs
    of 64-vector chunks covering all S vectors, within one block's shared
    memory; the fleet admits what the single model admits, whatever E."""
    import ctypes

    from test_torch_epilogue import _host_build
    from repro_torch.kernels.tune import SMEM_PER_BLOCK

    monkeypatch.delenv("REPRO_MEGAKERNEL_VMEM", raising=False)
    lib = _host_build(tmp_path_factory, "svm_plan", SVM_PLAN_HARNESS)
    lib.plan.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.rank_chunks.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    admitted = 0
    for s in range(1, 1800):
        if not tmodel.svm_fits_smem(s):
            assert s > 1696
            continue
        admitted += 1
        assert tmodel.svm_fleet_fits_smem(4, s)
        out = (ctypes.c_int * 4)()
        assert lib.plan(s, out) == 1, s
        n_chunks, g, cap, smem = out
        assert n_chunks == -(-s // 64) and g == min(8, n_chunks)
        assert cap % 64 == 0 and g * cap >= s and smem <= SMEM_PER_BLOCK
        covered = 0
        for rank in range(g):
            rc = (ctypes.c_int * 2)()
            lib.rank_chunks(rank, g, n_chunks, rc)
            begin, end = rc
            assert begin == covered and end > begin, (s, rank)
            n_local = min(s, end * 64) - begin * 64
            assert 1 <= n_local <= cap
            covered = end
        assert covered == n_chunks
    assert admitted == 1696
    assert not tmodel.svm_fleet_fits_smem(0, 300)


def test_cluster_plan_at_every_tuned_row_count(tmp_path_factory, monkeypatch):
    """``svm_plan`` at the cluster heights the tuner chooses between (16, 32
    and 64 rows, an instance each): the same split of the vectors as the
    default, shared memory of the staging buffers, the (rows, cap + 1)
    kernel values and the norms, within one block wherever the routing
    count admits that ``bm``; other heights are refused."""
    import ctypes

    from test_torch_epilogue import _host_build
    from repro_torch.kernels import tune

    monkeypatch.delenv("REPRO_MEGAKERNEL_VMEM", raising=False)
    lib = _host_build(tmp_path_factory, "svm_plan_rows", SVM_PLAN_HARNESS)
    lib.plan.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.plan_rows.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    for s in (1, 31, 33, 64, 300, 1000, 1696):
        ref = (ctypes.c_int * 4)()
        assert lib.plan(s, ref) == 1
        for rows in tune.MODEL_BMS:
            out = (ctypes.c_int * 4)()
            assert lib.plan_rows(s, rows, out) == 1, (s, rows)
            n_chunks, g, cap, smem = out
            assert (n_chunks, g, cap) == tuple(ref[:3])
            stage = 2 * 32 * (rows + 4 + 68)
            assert smem == 4 * (stage + rows * (cap + 1) + cap + rows)
            assert smem <= tune.SMEM_PER_BLOCK
            if rows == 32:
                assert smem == ref[3]
            if tmodel.svm_fits_smem(s, rows):
                assert rows in tune.model_candidates(
                    "svm-rbf", (561, s, 6), 16)
        for rows in (0, 8, 48, 128):
            assert lib.plan_rows(s, rows, (ctypes.c_int * 4)()) == 0
