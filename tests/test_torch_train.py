"""The port's optimizers and classifier trainers against the reference's.

* ``adamw`` (float32 and float64 parameters, weight decay), ``sgd`` (with
  and without momentum), ``global_norm``, ``clip_by_global_norm`` and the
  three schedules: one step on the same inputs equals the reference's
  within 1e-7 relative (float32 arithmetic on both sides; only summation
  order may differ);
* ``train_logistic``, ``train_linear_svm`` and ``train_kernel_svm`` (rbf
  and poly, float64): on the same seeded blobs with the same seed both
  packages see the same batches from zero parameters, so the port's
  coefficients must be within 1e-5 of the reference's, relative to the
  largest coefficient (measured: a few 1e-7), and the labels of the two
  models equal on at least 99% of the held-out rows;
* the port's MLP loop (``fit_mlp``) started from the reference's
  ``_init_params(PRNGKey(seed), sizes)`` gives weights within 1e-5 of the
  reference's ``train_mlp`` (same measure), and ``train_mlp`` from its own
  numpy initialisation reaches the reference's held-out accuracy within 2
  points.
"""

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables jax x64, as the reference runs)
import jax
import jax.numpy as jnp
from repro import models as jm
from repro.models import mlp as jmlp
from repro.train import optim as joptim
from repro.train import schedule as jschedule
from repro_torch import models as tm
from repro_torch.models import mlp as tmlp
from repro_torch.train import fit as tfit
from repro_torch.train import optim as toptim
from repro_torch.train import schedule as tschedule

COEF_RTOL = 1e-5  # of the largest |coefficient|
STEP_RTOL = 1e-7


@pytest.fixture(scope="module")
def blobs():
    x, y, c = tm.synthetic_blobs(1200, n_features=12, n_classes=3, seed=1)
    return x[:900], y[:900], x[900:], y[900:], c


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want))) / scale
    assert err <= rtol, f"max error {err:.3g} of the largest value"


def _tree(rng, dtype):
    return {"w": (rng.randn(7, 5)).astype(dtype),
            "layers": [{"b": rng.randn(5).astype(dtype)},
                       {"b": (rng.randn(3) * 1e-3).astype(dtype)}]}


def _to_torch(tree):
    return toptim.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _assert_trees(ttree, jtree, rtol=STEP_RTOL):
    tl = jax.tree.leaves(toptim.tree_map(lambda t: t, ttree),
                         is_leaf=lambda t: isinstance(t, torch.Tensor))
    jl = jax.tree.leaves(jtree)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        assert str(t.dtype).replace("torch.", "") == str(j.dtype)
        _close(t.numpy(), np.asarray(j), rtol)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", ["adamw", "sgd", "sgd_momentum"])
def test_one_step_matches_reference(dtype, name):
    rng = np.random.RandomState(0)
    params, grads = _tree(rng, dtype), _tree(rng, dtype)
    make = {"adamw": lambda o: o.adamw(3e-3, weight_decay=1e-2),
            "sgd": lambda o: o.sgd(0.1),
            "sgd_momentum": lambda o: o.sgd(0.1, momentum=0.9)}[name]
    jopt, topt = make(joptim), make(toptim)
    jp, jg = _to_jax(params), _to_jax(grads)
    tp, tg = _to_torch(params), _to_torch(grads)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for _ in range(3):  # three steps: the moments and bias corrections move
        ju, jstate = jopt.update(jg, jstate, jp)
        tu, tstate = topt.update(tg, tstate, tp)
        _assert_trees(tu, ju)
        jp, tp = joptim.apply_updates(jp, ju), toptim.apply_updates(tp, tu)
        _assert_trees(tp, jp)
    assert int(tstate.step) == int(jstate.step) == 3
    if name == "adamw":  # float32 moments whatever the parameters' dtype
        assert {m.dtype for m in toptim.tree_leaves(tstate.mu)} == \
            {torch.float32}
        _assert_trees(tstate.nu, jstate.nu)


def test_global_norm_and_clip_match_reference():
    rng = np.random.RandomState(1)
    tree = _tree(rng, np.float32)
    tree["w64"] = rng.randn(4).astype(np.float64) * 10
    jt, tt = _to_jax(tree), _to_torch(tree)
    _close(toptim.global_norm(tt).numpy(), np.asarray(joptim.global_norm(jt)),
           STEP_RTOL)
    for max_norm in (0.5, 1e6):
        tc, tn = toptim.clip_by_global_norm(tt, max_norm)
        jc, jn = joptim.clip_by_global_norm(jt, max_norm)
        _close(tn.numpy(), np.asarray(jn), STEP_RTOL)
        _assert_trees(tc, jc)


@pytest.mark.parametrize("name", ["constant", "warmup", "cosine"])
def test_schedules_match_reference(name):
    make = {"constant": lambda s: s.constant(3e-3),
            "warmup": lambda s: s.warmup_linear(1e-2, 7),
            "cosine": lambda s: s.cosine_schedule(1e-2, 5, 40)}[name]
    jfn, tfn = make(jschedule), make(tschedule)
    for step in (0, 1, 3, 5, 6, 17, 39, 40, 55):
        want = np.asarray(jfn(jnp.asarray(step, jnp.int32)))
        got = tfn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and want.dtype == np.float32
        _close(got.numpy(), want, STEP_RTOL)


def test_batches_are_the_reference_loops():
    n, bs, epochs, seed = 103, 16, 3, 5
    rng = np.random.RandomState(seed)
    want = []
    for _ in range(epochs):
        perm = rng.permutation(n)
        want += [perm[i:i + bs] for i in range(0, n - bs + 1, bs)]
    got = tfit.epoch_batches(n, bs, epochs, seed)
    np.testing.assert_array_equal(got, np.stack(want))
    assert tfit.epoch_batches(5, 16, 3, 0).shape == (0, 16)


def _agree(a, b, x):
    from repro_torch import compile as tcompile

    la = tcompile.compile(a, number_format="flt", device="cpu").predict(x)
    lb = tcompile.compile(b, number_format="flt", device="cpu").predict(x)
    return float((la == lb).mean())


@pytest.mark.parametrize("name", ["logistic", "linear_svm", "rbf", "poly"])
def test_trainers_match_reference(blobs, name):
    xtr, ytr, xte, _, c = blobs
    kw = dict(epochs=15, batch_size=128, seed=3)
    if name == "logistic":
        jmod = jm.train_logistic(xtr, ytr, c, **kw)
        tmod = tm.train_logistic(xtr, ytr, c, device="cpu", **kw)
        pairs = [(tmod.coef, jmod.coef), (tmod.intercept, jmod.intercept)]
    elif name == "linear_svm":
        jmod = jm.train_linear_svm(xtr, ytr, c, **kw)
        tmod = tm.train_linear_svm(xtr, ytr, c, device="cpu", **kw)
        pairs = [(tmod.coef, jmod.coef), (tmod.intercept, jmod.intercept)]
        assert tmod.dtype == jmod.dtype == "float32"
    else:
        kw.update(kernel=name, n_prototypes=60)
        jmod = jm.train_kernel_svm(xtr, ytr, c, **kw)
        tmod = tm.train_kernel_svm(xtr, ytr, c, device="cpu", **kw)
        np.testing.assert_array_equal(tmod.support_vectors,
                                      jmod.support_vectors)
        assert tmod.dual_coef.dtype == np.float64 == jmod.dual_coef.dtype
        assert (tmod.gamma, tmod.coef0, tmod.degree) == \
            (jmod.gamma, jmod.coef0, jmod.degree)
        pairs = [(tmod.dual_coef, jmod.dual_coef),
                 (tmod.intercept, jmod.intercept)]
    for got, want in pairs:
        assert got.dtype == want.dtype
        _close(got, want, COEF_RTOL)
    from repro_torch.convert import model_from_params
    from repro import compile as jcompile

    kind = jcompile.model_kind(jmod)
    same = model_from_params(kind, jcompile.get_lowering(kind)
                             .extract_params(jmod))
    assert _agree(tmod, same, xte) >= 0.99


def test_mlp_loop_from_reference_init(blobs):
    xtr, ytr, _, _, c = blobs
    sizes, seed = [12, 16, c], 2
    p0 = jmlp._init_params(jax.random.PRNGKey(seed), sizes)
    assert [(str(l["w"].dtype), str(l["b"].dtype)) for l in p0] == \
        [("float64", "float32")] * 2
    jmod = jm.train_mlp(xtr, ytr, c, hidden=(16,), epochs=10, batch_size=64,
                        seed=seed)
    tmod = tmlp.fit_mlp(jax.tree.map(np.asarray, p0), xtr, ytr, epochs=10,
                        batch_size=64, seed=seed, device="cpu")
    for got, want in zip(tmod.weights + tmod.biases,
                         jmod.weights + jmod.biases):
        assert got.dtype == want.dtype == np.float32
        _close(got, want, COEF_RTOL)


def test_train_mlp_reaches_reference_accuracy(blobs):
    xtr, ytr, xte, yte, c = blobs
    # a harder split of the same labels: class means 1.5 sigma apart
    rng = np.random.RandomState(4)
    x = (rng.randn(c, 12)[np.r_[ytr, yte]]
         + rng.randn(len(ytr) + len(yte), 12) * 1.5).astype(np.float32)
    xtr, xte = x[:len(ytr)], x[len(ytr):]
    jmod = jm.train_mlp(xtr, ytr, c, hidden=(16,), epochs=40, seed=0)
    tmod = tm.train_mlp(xtr, ytr, c, hidden=(16,), epochs=40, seed=0,
                        device="cpu")
    init = tmlp.mlp_init_params([12, 16, c], 0)
    assert init[0]["w"].dtype == np.float64 and init[0]["b"].dtype == \
        np.float32
    jacc = float((jmod.predict(xte) == yte).mean())
    from repro_torch import compile as tcompile

    tacc = float((tcompile.compile(tmod, number_format="flt", device="cpu")
                  .predict(xte) == yte).mean())
    assert tacc >= jacc - 0.02, (tacc, jacc)
    assert tacc > 1.0 / c + 0.2


def test_trainers_run_on_the_card_unless_asked(blobs, monkeypatch):
    xtr, ytr, _, _, c = blobs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for train in (tm.train_logistic, tm.train_linear_svm,
                  tm.train_kernel_svm, tm.train_mlp):
        with pytest.raises(RuntimeError, match="CUDA"):
            train(xtr, ytr, c, epochs=1)
