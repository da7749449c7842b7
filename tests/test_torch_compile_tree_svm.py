"""The port's tree and SVM compile -> predict paths against the reference.

Seeded models on the 12-feature blobs data, scaled by 1/4 so that the
poly kernel saturates only in part at fxp16 (a CART tree trained by the
reference, a least-squares linear SVM, and poly/rbf SVMs on 24 stratified
prototypes with least-squares duals) are carried over with
``model_from_params`` and compiled by both packages for every quantized tag
and ``flt``, on ``cuda`` (the port on a CPU device, running the kernels'
plain versions; the reference on ``pallas``) and on ``ref``.  Labels, stats,
``emit_spec`` (byte for byte), the QuantPlan descriptor, ``kernel_strategy``
and the flash/SRAM model must be equal.

The reference's ``pallas`` tree compile raises on the installed JAX
(``jax.core.trace_state_clean`` is gone, ``repro/kernels/ops.py:512``), so
on ``cuda`` a tree is held against the reference's ``ref`` artifact and its
Pallas kernel called directly in interpret mode.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from _torch_port_cases import QUANT_TAGS, megakernel_budget
from repro import compile as jcompile
from repro import models as jmodels
from repro.core import fixedpoint as jfx
from repro.core.trees import TreeArrays as JTreeArrays
from repro.kernels.tree_ensemble import pack_tree, tree_ensemble_pallas
from repro_torch import compile as tcompile
from repro_torch.convert import model_from_params
from repro_torch.models.svm import _pick_prototypes

KINDS = ("tree", "svm-linear", "svm-poly", "svm-rbf")
TAGS = dict(QUANT_TAGS, flt=dict(number_format="flt"))
N_CALIBRATION = 256
# Rows whose float64 top-2 decision gap is below this may flip between two
# float32 evaluation orders (XLA vs PyTorch).
FLT_GAP = 1e-3
SCALE = 0.25
# Kernel constants that fxp16 (Q12.4) represents exactly.
SVM_CONSTS = {"svm-poly": dict(gamma=0.125, coef0=1.0, degree=3),
              "svm-rbf": dict(gamma=0.125, coef0=0.0, degree=2)}


def _kernel_features(kind, x, sv, gamma, coef0, degree):
    dot = x @ sv.T
    if kind == "svm-poly":
        return (gamma * dot + coef0) ** degree
    d2 = (x * x).sum(1)[:, None] - 2 * dot + (sv * sv).sum(1)[None, :]
    return np.exp(-gamma * d2)


def _lstsq(h, y):
    onehot = np.eye(int(y.max()) + 1)[y]
    sol = np.linalg.lstsq(np.c_[h, np.ones(len(h))], onehot, rcond=None)[0]
    return sol[:-1], sol[-1]


def model_params(kind, x, y):
    """Extracted-params dict of a seeded model of ``kind`` fitted to
    (x, y), in the reference lowerings' layout."""
    x64 = np.asarray(x, np.float64)
    if kind == "tree":
        model = jmodels.train_decision_tree(x, y, int(y.max()) + 1,
                                            max_depth=6)
        return jcompile.get_lowering("tree").extract_params(model)
    if kind == "svm-linear":
        coef, icept = _lstsq(x64, y)
        return {"kernel": "linear", "coef": coef.astype(np.float32),
                "intercept": icept.astype(np.float32)}
    sv = _pick_prototypes(x64, y, int(y.max()) + 1, 24, seed=5)
    consts = SVM_CONSTS[kind]
    dual, icept = _lstsq(_kernel_features(kind, x64, sv, **consts), y)
    return {"kernel": kind[len("svm-"):], "support_vectors": sv,
            "dual_coef": dual, "intercept": icept, **consts}


def jax_model(kind, p):
    if kind == "tree":
        return jmodels.DecisionTreeModel(JTreeArrays(
            **{k: p[k] for k in ("feature", "threshold", "left", "right",
                                 "leaf_class", "max_depth", "n_classes",
                                 "n_features")}))
    if kind == "svm-linear":
        return jmodels.SVMModel("linear", coef=p["coef"],
                                intercept=p["intercept"], dtype="float32")
    return jmodels.SVMModel(p["kernel"], support_vectors=p["support_vectors"],
                            dual_coef=p["dual_coef"], intercept=p["intercept"],
                            gamma=p["gamma"], coef0=p["coef0"],
                            degree=p["degree"])


def float_decision(kind, p, x):
    x = np.asarray(x, np.float64)
    if kind == "svm-linear":
        return x @ p["coef"] + p["intercept"]
    k = _kernel_features(kind, x, p["support_vectors"], p["gamma"],
                         p["coef0"], p["degree"])
    return k @ p["dual_coef"] + p["intercept"]


class Pairs:
    """Compiles each (kind, tag, backend, layout, per-layer) once per
    module, in both packages: ``pair(...) -> (jax_artifact, port_artifact)``.
    A tree on ``cuda`` pairs with the reference's ``ref`` artifact."""

    def __init__(self, x_train, y_train):
        self.x_cal = x_train[:N_CALIBRATION]
        self.params = {k: model_params(k, x_train, y_train) for k in KINDS}
        self._memo = {}

    def pair(self, kind, tag, backend, layout="iterative", per_layer=False):
        key = (kind, tag, backend, layout, per_layer)
        if key not in self._memo:
            p = self.params[kind]
            kw = dict(TAGS[tag], tree_layout=layout)
            jbackend = "ref" if backend == "ref" or kind == "tree" else "pallas"
            cal = self.x_cal if kw["number_format"].startswith("auto") else None
            with megakernel_budget(0 if per_layer else None):
                jart = jcompile.compile(
                    jax_model(kind, p),
                    jcompile.Target(backend=jbackend, **kw), calibration=cal)
                tart = tcompile.compile(
                    model_from_params(kind, p),
                    tcompile.Target(backend=backend, **kw), calibration=cal,
                    device="cpu")
            self._memo[key] = (jart, tart)
        return self._memo[key]


@pytest.fixture(scope="module")
def cases(blobs):
    x_train, y_train, x_test, _, _ = blobs
    return Pairs(x_train * SCALE, y_train), x_test * SCALE


def assert_same_spec(jspec, tspec):
    """emit_spec equality: formats by (bits, frac), arrays byte for byte
    with their dtype and shape, everything else by value."""
    assert jspec.keys() == tspec.keys()
    for key, jv in jspec.items():
        tv = tspec[key]
        if key.endswith("fmt"):
            assert (jv.total_bits, jv.frac_bits) == \
                (tv.total_bits, tv.frac_bits), key
        elif isinstance(jv, np.ndarray) or hasattr(jv, "dtype"):
            jv = np.asarray(jv)
            assert isinstance(tv, np.ndarray), key
            assert (jv.dtype, jv.shape) == (tv.dtype, tv.shape), key
            assert jv.tobytes() == tv.tobytes(), key
        else:
            assert type(jv) is type(tv) and jv == tv, key


def _tree_kernel_labels(jart, x):
    """The reference's tree kernel in interpret mode on the artifact's
    quantized tree and inputs (cast to float32, as its lowering does)."""
    spec = jart.extras["emit_spec"]
    tree = JTreeArrays(spec["feature"], spec["threshold"], spec["left"],
                       spec["right"], spec["leaf_class"], spec["max_depth"], 0,
                       x.shape[1])
    qx = jfx.quantize(jnp.asarray(x), spec["in_fmt"]).astype(jnp.float32)
    packed = tuple(jnp.asarray(a) for a in pack_tree(tree))
    return np.asarray(tree_ensemble_pallas(qx, *packed, block_batch=64,
                                           interpret=True))


@pytest.mark.parametrize("backend", ["cuda", "ref"])
@pytest.mark.parametrize("tag", QUANT_TAGS)
@pytest.mark.parametrize("kind", KINDS)
def test_quantized_matches_reference(cases, kind, tag, backend):
    cache, x = cases
    jart, tart = cache.pair(kind, tag, backend)
    assert tart.kernel_strategy == jart.kernel_strategy
    if backend == "cuda" and kind in ("svm-poly", "svm-rbf"):
        assert tart.kernel_strategy == "megakernel"
    assert tart.plan_key == jart.plan_key
    assert tart.fingerprint == jart.fingerprint
    assert tart.memory_report() == jart.memory_report()
    assert_same_spec(jart.extras["emit_spec"], tart.extras["emit_spec"])
    jlab, jstats = jart.predict_with_stats(x)
    tlab, tstats = tart.predict_with_stats(x)
    np.testing.assert_array_equal(tlab, jlab)
    assert tstats == jstats
    if not (tag == "auto8" and kind in ("svm-poly", "svm-rbf")):
        # The labels carry information.  (An 8-bit kernel domain holds
        # the inputs and the kernel values in one format, and the calibrated
        # kernel SVMs' labels come out constant in both packages.)
        assert len(np.unique(tlab)) > 1
    np.testing.assert_array_equal(tart.predict(x[:7]), jlab[:7])
    if kind == "tree" and backend == "cuda":
        np.testing.assert_array_equal(tlab, _tree_kernel_labels(jart, x))


@pytest.mark.parametrize("layout", ["ifelse", "oblivious"])
@pytest.mark.parametrize("tag", ["fxp16", "auto8", "flt"])
def test_tree_layouts_match_reference(cases, tag, layout):
    cache, x = cases
    for backend in ("ref", "cuda"):
        jart, tart = cache.pair("tree", tag, backend, layout=layout)
        assert tart.memory_report() == jart.memory_report()
        np.testing.assert_array_equal(tart.predict(x), jart.predict(x))


@pytest.mark.parametrize("backend", ["cuda", "ref"])
@pytest.mark.parametrize("kind", KINDS)
def test_flt_matches_within_gap(cases, kind, backend):
    cache, x = cases
    jart, tart = cache.pair(kind, "flt", backend)
    assert tart.memory_report() == jart.memory_report()
    assert tart.kernel_strategy is None and jart.kernel_strategy is None
    if kind == "tree":  # float32 compares on both sides: exact
        np.testing.assert_array_equal(tart.predict(x), jart.predict(x))
        return
    logits = float_decision(kind, cache.params[kind], x)
    top2 = np.sort(logits, axis=1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) >= FLT_GAP
    assert decided.mean() > 0.9  # the check must cover most rows
    np.testing.assert_array_equal(tart.predict(x)[decided],
                                  jart.predict(x)[decided])


@pytest.mark.parametrize("tag", QUANT_TAGS)
@pytest.mark.parametrize("kind", ["svm-poly", "svm-rbf"])
def test_forced_per_layer_svm_route_matches(cases, kind, tag):
    cache, x = cases
    jart, tart = cache.pair(kind, tag, "cuda", per_layer=True)
    assert tart.kernel_strategy == jart.kernel_strategy == "per-layer"
    mega = cache.pair(kind, tag, "cuda")[1]
    assert tart.cache_key != mega.cache_key
    np.testing.assert_array_equal(tart.predict(x), jart.predict(x))
    np.testing.assert_array_equal(tart.predict(x), mega.predict(x))
