"""repro_torch.kernels against repro.kernels (bit-exact).

* The plain PyTorch versions of the two ported kernels against the Pallas
  kernels run in interpret mode, on seeded numpy integers, including inputs
  whose dot products wrap the int32 accumulator.
* The int64 oracles of ``kernels/ref.py`` against the reference oracles.
* Routing: a CPU tensor takes the plain version and launches no kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables jax x64, as the reference runs)
from repro.core import fixedpoint as jfx
from repro.kernels import ref as jref
from repro.kernels.fxp_layer import fxp_layer_pallas
from repro.kernels import tune as jtune
from repro.kernels.fxp_model import fxp_mlp_model_pallas
from repro_torch.core import fixedpoint as tfx
from repro_torch.kernels import fxp_layer as tlayer
from repro_torch.kernels import fxp_model as tmodel
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tune as ttune

NP_DTYPES = {8: np.int8, 16: np.int16, 32: np.int32}
ACTS = ("none", "exact", "rational", "pwl2", "pwl4")


def _ints(rng, shape, bits, mag=None):
    """Seeded ints of a container: full range, or |v| < 2^mag."""
    if mag is None:
        lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    else:
        lo, hi = -(2 ** mag), 2 ** mag - 1
    return rng.randint(lo, hi + 1, shape).astype(NP_DTYPES[bits])


def _layer_case(bits, case, seed=0):
    """(a, b, bias, frac, shift) for one container width and input regime."""
    rng = np.random.RandomState(seed + bits)
    m, k, n = 13, 48, 7
    mag = {8: 4, 16: 7, 32: 12}[bits]
    if case == "typical":
        frac, shift = {8: 2, 16: 4, 32: 10}[bits], None
        a, b = _ints(rng, (m, k), bits, mag), _ints(rng, (k, n), bits, mag)
    elif case == "shift0":
        frac, shift = 0, 0
        a, b = _ints(rng, (m, k), bits, mag), _ints(rng, (k, n), bits, mag)
    else:  # "wrap": full-range operands; shift width-1 with a Q0.m output
        frac, shift = bits - 1, bits - 1
        a, b = _ints(rng, (m, k), bits), _ints(rng, (k, n), bits)
        a[0], b[:, 0] = 2 ** (bits - 1) - 1, 2 ** (bits - 1) - 1
        a[1], b[:, 1] = -(2 ** (bits - 1)), -(2 ** (bits - 1))
    bias = _ints(rng, (n,), bits)
    bias[:2] = [2 ** (bits - 1) - 1, -(2 ** (bits - 1))]
    return a, b, bias, frac, shift


def _same(j, t):
    j = np.asarray(j)
    t = t.numpy()
    assert j.dtype == t.dtype, (j.dtype, t.dtype)
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("case", ["typical", "shift0", "wrap"])
@pytest.mark.parametrize("activation", ACTS)
@pytest.mark.parametrize("bits", [8, 16, 32])
def test_fxp_layer_plain_matches_pallas(bits, activation, case):
    a, b, bias, frac, shift = _layer_case(bits, case)
    if case == "wrap" and bits > 8:  # 8-bit sums cannot reach 2^31 here
        true = a.astype(np.int64) @ b.astype(np.int64)
        assert np.abs(true).max() >= 2 ** 31  # the int32 accumulator wraps
    jf, tf = jfx.FxpFormat(bits, frac), tfx.FxpFormat(bits, frac)
    m, k = a.shape
    n = b.shape[1]
    # bk = k // 3: the accumulator is carried across three K grid steps.
    want = fxp_layer_pallas(jnp.asarray(a), jnp.asarray(b), jnp.asarray(bias),
                            jf, activation, shift=shift, bm=m, bn=n,
                            bk=k // 3, interpret=True)
    got = tlayer.fxp_layer_plain(torch.from_numpy(a), torch.from_numpy(b),
                                 torch.from_numpy(bias), tf, activation, shift)
    _same(want, got)


def _mlp_case(bits, act, wrap, seed=1):
    rng = np.random.RandomState(seed + bits)
    dims = (11, 9, 6, 3)
    fracs = {8: (2, 3, 1), 16: (4, 6, 3), 32: (10, 12, 8)}[bits]
    mag = None if wrap else {8: 3, 16: 6, 32: 11}[bits]
    x = _ints(rng, (10, dims[0]), bits, mag)
    ws = [_ints(rng, (i, o), bits, mag) for i, o in zip(dims, dims[1:])]
    bs = [_ints(rng, (o,), bits, mag) for o in dims[1:]]
    if wrap:
        x[0], ws[0][:, 0] = 2 ** (bits - 1) - 1, 2 ** (bits - 1) - 1
    acts = (act, act, "none")
    sched = [(s, f, a) for s, f, a in zip((3, 0, bits - 1), fracs, acts)]
    jsched = tuple((s, jfx.FxpFormat(bits, f), a) for s, f, a in sched)
    tsched = tuple((s, tfx.FxpFormat(bits, f), a) for s, f, a in sched)
    return x, ws, bs, jsched, tsched


@pytest.mark.parametrize("wrap", [False, True], ids=["typical", "wrap"])
@pytest.mark.parametrize("activation", ACTS[1:])
@pytest.mark.parametrize("bits", [8, 16, 32])
def test_fxp_mlp_model_plain_matches_pallas(bits, activation, wrap):
    x, ws, bs, jsched, tsched = _mlp_case(bits, activation, wrap)
    want = fxp_mlp_model_pallas(jnp.asarray(x),
                                tuple(jnp.asarray(w) for w in ws),
                                tuple(jnp.asarray(b) for b in bs), jsched,
                                bm=x.shape[0], interpret=True)
    got = tmodel.fxp_mlp_model_plain(torch.from_numpy(x),
                                     [torch.from_numpy(w) for w in ws],
                                     [torch.from_numpy(b) for b in bs], tsched)
    _same(want, got)


@pytest.mark.parametrize("bits", [8, 16, 32])
def test_ref_oracles_match(bits):
    """The int64-accumulating oracles, on typical and wrapping inputs."""
    for case in ("typical", "shift0", "wrap"):
        a, b, bias, frac, shift = _layer_case(bits, case, seed=5)
        jf, tf = jfx.FxpFormat(bits, frac), tfx.FxpFormat(bits, frac)
        ja, jb, jbias = jnp.asarray(a), jnp.asarray(b), jnp.asarray(bias)
        ta, tb, tbias = (torch.from_numpy(v) for v in (a, b, bias))
        _same(jref.fxp_qmatmul_ref(ja, jb, jf, shift),
              tref.fxp_qmatmul_ref(ta, tb, tf, shift))
        for act in ACTS:
            _same(jref.fxp_layer_ref(ja, jb, jbias, jf, act, shift),
                  tref.fxp_layer_ref(ta, tb, tbias, tf, act, shift))
            jh, js = jref.fxp_layer_ref_with_stats(ja, jb, jbias, jf, act, shift)
            th, ts = tref.fxp_layer_ref_with_stats(ta, tb, tbias, tf, act, shift)
            _same(jh, th)
            assert [int(v) for v in (js.overflow, js.underflow, js.total)] == \
                [int(v) for v in (ts.overflow, ts.underflow, ts.total)]
    x, ws, bs, jsched, tsched = _mlp_case(bits, "exact", wrap=True)
    _same(jref.fxp_mlp_model_ref(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                                 [jnp.asarray(b) for b in bs], jsched),
          tref.fxp_mlp_model_ref(torch.from_numpy(x),
                                 [torch.from_numpy(w) for w in ws],
                                 [torch.from_numpy(b) for b in bs], tsched))


def test_cpu_tensors_route_to_plain_and_launch_nothing():
    a, b, bias, frac, _ = _layer_case(16, "typical")
    fmt = tfx.FxpFormat(16, frac)
    ta, tb, tbias = (torch.from_numpy(v) for v in (a, b, bias))
    x, ws, bs, _, tsched = _mlp_case(16, "pwl4", wrap=False)
    tx = torch.from_numpy(x)
    tws = [torch.from_numpy(w) for w in ws]
    tbs = [torch.from_numpy(v) for v in bs]
    before = (tlayer.fxp_layer_cuda.launches, tmodel.fxp_mlp_model_cuda.launches)
    with tops.count_dispatches() as c:
        got_layer = tops.fxp_layer(ta, tb, tbias, fmt, "exact")
        got_model = tops.fxp_mlp_model(tx, tws, tbs, tsched)
    assert c.count == 2
    assert (tlayer.fxp_layer_cuda.launches,
            tmodel.fxp_mlp_model_cuda.launches) == before
    assert torch.equal(got_layer,
                       tlayer.fxp_layer_plain(ta, tb, tbias, fmt, "exact"))
    assert torch.equal(got_model, tmodel.fxp_mlp_model_plain(tx, tws, tbs,
                                                             tsched))
    # impl="ref" takes the int64 oracle
    assert torch.equal(tops.fxp_layer(ta, tb, tbias, fmt, "exact", impl="ref"),
                       tref.fxp_layer_ref(ta, tb, tbias, fmt, "exact"))
    # the launchers themselves refuse host tensors instead of falling back
    with pytest.raises(ValueError, match="CUDA tensors"):
        tlayer.fxp_layer_cuda(ta, tb, tbias, fmt)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tmodel.fxp_mlp_model_cuda(tx, tws, tbs, tsched)
    with pytest.raises(KeyError):
        tops.fxp_layer(ta, tb, tbias, fmt, impl="pallas")


def test_epilogue_params_and_fit_predicate(monkeypatch):
    fmt = tfx.FxpFormat(16, 4)
    row = tlayer.epilogue_params(5, fmt, "pwl4")
    assert row.dtype == np.int64 and row.shape == (tlayer.EPILOGUE_FIELDS,)
    assert list(row[:9]) == [5, 4, 4, 16, 32, 11, -32768, 32767, 16]
    assert list(row[9:14]) == [tfx.exp_poly_consts(fmt)[0],
                               *tfx.exp_poly_consts(fmt)[1]]
    with pytest.raises(ValueError):
        tlayer.epilogue_params(32, fmt, "none")
    with pytest.raises(KeyError):
        tlayer.epilogue_params(0, fmt, "relu")
    # D6 (561 -> 64 -> 6) takes the megakernel at every container width
    monkeypatch.delenv("REPRO_MEGAKERNEL_VMEM", raising=False)
    for bits in (8, 16, 32):
        assert tmodel.mlp_fits_smem([561, 64, 6], bits)
    assert tmodel.mlp_smem_bytes([561, 64, 6], 32) == 2 * 32 * 561 * 4
    assert not tmodel.mlp_fits_smem([4] * (tmodel.MAX_LAYERS + 2), 8)
    assert not tmodel.mlp_fits_smem([1000, 64, 6], 32)
    monkeypatch.setenv("REPRO_MEGAKERNEL_VMEM", "0")
    assert not tmodel.mlp_fits_smem([12, 16, 3], 8)


def test_tune_helpers_match():
    for n in [1, 2, 3, 7, 8, 9, 64, 65, 3089, 65536, 65537]:
        assert ttune.pow2ceil(n) == jtune.pow2ceil(n)
        for cap in (8, 256, 1 << 30):
            assert ttune.batch_bucket(n, cap) == jtune.batch_bucket(n, cap)
    assert ttune.batch_bucket(0) == jtune.batch_bucket(0) == 1
    assert ttune.device_key("cpu") == "cpu:cpu"
