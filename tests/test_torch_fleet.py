"""Fleet stacking in the port against the live JAX package.

At the sizes of ``tests/test_fleet.py`` (F=8, C=3, MLP hidden (8,), E=3),
seeded models go through both packages (the reference on ``pallas``, its
fleet kernels in interpret mode; the port on ``cuda`` with ``device="cpu"``,
the fleet kernels' plain versions):

* ``fleet_signature`` equals the reference's for the same models at the
  same targets, and is None where no stacked program exists;
* ``FleetStack`` slot e equals the reference ``FleetStack``'s slot e and
  member e's own ``predict``, bit for bit, for shared (M, F) and per-slot
  (E, M, F) rows: heterogeneous ``auto16`` MLPs, logistic models as 1-layer
  MLPs, and poly/rbf SVMs (uniform ``fxp16`` and per-model ``auto16``);
* one stacked forward is one kernel dispatch;
* ``stack_fleet`` raises where the reference's does;
* the fleet kernels' plain versions equal the port's and the reference's
  oracles (``fxp_*_fleet_ref``) on the same integer operands.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_cases import (compile_pair, fleet_blobs, fleet_params,
                               megakernel_budget)
from repro import compile as jcompile
from repro.core.fixedpoint import FxpFormat as JFormat
from repro.kernels import ref as jref
from repro_torch import compile as tcompile
from repro_torch.core.fixedpoint import FxpFormat
from repro_torch.kernels import fxp_model, ops
from repro_torch.kernels import ref as tref

E = 3


@pytest.fixture(scope="module")
def blobs():
    return fleet_blobs()


@pytest.fixture(scope="module")
def fleets(blobs):
    """name -> [(jax_artifact, port_artifact)] per member."""
    xtr, ytr = blobs[0], blobs[1]

    def members(kind, fmt, n, calibrated):
        out = []
        for s in range(n):
            cal = xtr[40 * s:120 + 40 * s] if calibrated else None
            out.append(compile_pair(*fleet_params(kind, s, xtr, ytr), fmt,
                                    calibration=cal))
        return out

    return {"mlp-auto16": members("mlp", "auto16", E, True),
            "logistic-auto16": members("logistic", "auto16", 2, True),
            "rbf-fxp16": members("svm-rbf", "fxp16", 2, False),
            "poly-auto16": members("svm-poly", "auto16", E, True)}


def test_signature_equals_reference(fleets, blobs):
    for name, pairs in fleets.items():
        for jart, tart in pairs:
            sig = tcompile.fleet_signature(tart)
            assert sig is not None, name
            assert sig == jcompile.fleet_signature(jart), name
        assert len({tcompile.fleet_signature(t) for _, t in pairs}) == 1
    assert tcompile.fleet_signature(fleets["logistic-auto16"][0][1])[:3] == (
        "mlp", 16, (8, 3))


def test_signature_none_without_a_stacked_program(blobs):
    from repro_torch.models import train_decision_tree

    xtr, ytr = blobs[0], blobs[1]
    kind, params = fleet_params("mlp", 0, xtr, ytr)
    tree = tcompile.compile(train_decision_tree(xtr, ytr, 3, max_depth=4),
                            tcompile.Target(number_format="fxp16",
                                            backend="cuda"), device="cpu")
    assert tcompile.fleet_signature(tree) is None
    model = fleet_params("mlp", 0, xtr, ytr)
    from repro_torch.convert import model_from_params

    m = model_from_params(*model)
    for target in (tcompile.Target(number_format="fxp16", backend="ref"),
                   tcompile.Target(number_format="flt", backend="cuda")):
        art = tcompile.compile(m, target, device="cpu")
        assert tcompile.fleet_signature(art) is None
    with megakernel_budget(0):
        per_layer = tcompile.compile(
            m, tcompile.Target(number_format="fxp16", backend="cuda"),
            device="cpu")
    assert per_layer.kernel_strategy == "per-layer"
    assert tcompile.fleet_signature(per_layer) is None


@pytest.mark.parametrize("name", ["mlp-auto16", "logistic-auto16",
                                  "rbf-fxp16", "poly-auto16"])
@pytest.mark.parametrize("rows", ["shared", "per-slot"])
def test_stack_slot_identity(fleets, blobs, name, rows):
    pairs = fleets[name]
    e = len(pairs)
    xte = blobs[2]
    if rows == "shared":
        x = xte[:13]
    else:
        x = np.stack([xte[9 * i:9 * i + 9] for i in range(e)])
    jstack = jcompile.stack_fleet([j for j, _ in pairs])
    tstack = tcompile.stack_fleet([t for _, t in pairs])
    assert tstack.signature == jstack.signature
    assert (tstack.n_models, tstack.n_features) == (e, 8)
    got = tstack.predict(x)
    assert got.dtype == np.int32 and got.shape == (e, x.shape[-2])
    np.testing.assert_array_equal(got, jstack.predict(x))
    assert len(np.unique(got)) > 1  # labels that can tell slots apart
    for i, (jart, tart) in enumerate(pairs):
        xi = x if rows == "shared" else x[i]
        np.testing.assert_array_equal(got[i], tart.predict(xi))
        np.testing.assert_array_equal(got[i], jart.predict(xi))
    if name == "mlp-auto16":  # the calibrated members froze distinct plans
        specs = [t.extras["emit_spec"] for _, t in pairs]
        assert len({tuple(s["shifts"]) + tuple(
            (f.total_bits, f.frac_bits) for f in s["out_fmts"])
            for s in specs}) > 1


def test_stack_is_one_dispatch(fleets, blobs):
    tarts = [t for _, t in fleets["mlp-auto16"]]
    stack = tcompile.stack_fleet(tarts)
    with ops.count_dispatches() as c:
        stack.predict(blobs[2][:4])
    assert c.count == 1
    stack = tcompile.stack_fleet([t for _, t in fleets["rbf-fxp16"]])
    with ops.count_dispatches() as c:
        stack.predict(blobs[2][:4])
    assert c.count == 1


def test_stack_fleet_rejects_what_the_reference_rejects(fleets):
    mlps, svms = fleets["mlp-auto16"], fleets["rbf-fxp16"]
    for stack_fleet, k in ((jcompile.stack_fleet, 0),
                           (tcompile.stack_fleet, 1)):
        with pytest.raises(ValueError):
            stack_fleet([mlps[0][k]])  # a fleet of one is not a fleet
        with pytest.raises(ValueError):
            stack_fleet([mlps[0][k], svms[0][k]])
        with pytest.raises(ValueError):
            stack_fleet([])


def test_fleet_fit_predicates():
    assert fxp_model.mlp_fleet_fits_smem(8, (561, 64, 6), 16)
    assert fxp_model.mlp_fleet_fits_smem(1000, (561, 64, 6), 32)
    assert not fxp_model.mlp_fleet_fits_smem(0, (561, 64, 6), 16)
    assert not fxp_model.mlp_fleet_fits_smem(2, (561, 4000, 6), 32)
    assert fxp_model.svm_fleet_fits_smem(4, 300)
    assert not fxp_model.svm_fleet_fits_smem(4, 5000)
    with megakernel_budget(0):
        assert not fxp_model.mlp_fleet_fits_smem(2, (8, 8, 3), 16)


def _ints(rng, shape, bits):
    mag = {8: 3, 16: 7, 32: 12}[bits]
    return rng.randint(-(2 ** mag), 2 ** mag, shape).astype(
        {8: np.int8, 16: np.int16, 32: np.int32}[bits])


@pytest.mark.parametrize("bits", [8, 16, 32])
def test_mlp_fleet_plain_matches_oracles(bits):
    rng = np.random.RandomState(bits)
    x = _ints(rng, (E, 5, 8), bits)
    ws = [_ints(rng, (E, 8, 8), bits), _ints(rng, (E, 8, 3), bits)]
    bs = [_ints(rng, (E, 8), bits), _ints(rng, (E, 3), bits)]
    acts = ("exact", "rational", "pwl4")
    frac = min(bits - 6, 10)  # int32 sums stay in range: the oracles agree
    plans = [((4 + e, frac - e % 2, acts[e]), (3, frac, "none"))
             for e in range(E)]
    tsched = tuple(tuple((s, FxpFormat(bits, f), a) for s, f, a in p)
                   for p in plans)
    jsched = tuple(tuple((s, JFormat(bits, f), a) for s, f, a in p)
                   for p in plans)
    tx, tws, tbs = (torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
                    [torch.from_numpy(b) for b in bs])
    got = ops.fxp_mlp_fleet(tx, tws, tbs, tsched)
    assert torch.equal(got, fxp_model.fxp_mlp_fleet_plain(tx, tws, tbs,
                                                          tsched))
    assert torch.equal(got, tref.fxp_mlp_fleet_ref(tx, tws, tbs, tsched))
    want = jref.fxp_mlp_fleet_ref(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                                  [jnp.asarray(b) for b in bs], jsched)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["poly", "rbf"])
@pytest.mark.parametrize("bits", [16, 32])
def test_svm_fleet_plain_matches_oracles(bits, kind):
    rng = np.random.RandomState(bits + len(kind))
    x, sv = _ints(rng, (E, 6, 8), bits), _ints(rng, (E, 12, 8), bits)
    dual, icept = _ints(rng, (E, 12, 3), bits), _ints(rng, (E, 3), bits)
    frac = min(bits - 6, 10)  # int32 sums stay in range: the oracles agree
    raw = [(frac - e % 2, frac - 1, 1 + e, 2 - e, 1 + e % 3, 2 + e)
           for e in range(E)]
    tparams = [(FxpFormat(bits, f), FxpFormat(bits, fo), g, c, d, s)
               for f, fo, g, c, d, s in raw]
    jparams = [(JFormat(bits, f), JFormat(bits, fo), g, c, d, s)
               for f, fo, g, c, d, s in raw]
    targs = [torch.from_numpy(a) for a in (x, sv, dual, icept)]
    got = ops.fxp_svm_fleet(*targs, kind, tparams)
    assert torch.equal(got, fxp_model.fxp_svm_fleet_plain(*targs, kind,
                                                          tparams))
    assert torch.equal(got, tref.fxp_svm_fleet_ref(*targs, kind, tparams))
    want = jref.fxp_svm_fleet_ref(*[jnp.asarray(a) for a in
                                    (x, sv, dual, icept)], kind, jparams)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fleet_wrappers_validate():
    x = torch.zeros((2, 4, 8), dtype=torch.int16)
    ws = [torch.zeros((2, 8, 3), dtype=torch.int16)]
    bs = [torch.zeros((2, 3), dtype=torch.int16)]
    s16 = ((0, FxpFormat(16, 4), "none"),)
    with pytest.raises(ValueError, match="container"):
        fxp_model.fxp_mlp_fleet_plain(
            x, ws, bs, (s16, ((0, FxpFormat(32, 4), "none"),)))
    with pytest.raises(ValueError, match="CUDA"):
        fxp_model.fxp_mlp_fleet_cuda(x, ws, bs, (s16, s16))
    with pytest.raises(KeyError):
        fxp_model.fxp_svm_fleet_plain(x, x, x, x[:, 0], "linear", ())
