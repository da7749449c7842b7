"""Shared cases of the port's end-to-end tests (tests/test_torch_compile*.py).

Seeded numpy parameters go into a reference model and, through
``repro_torch.convert.model_from_params``, into the port's model; both
packages compile them for the same Target and must agree bit for bit.
"""

import contextlib
import os

import numpy as np

import repro  # noqa: F401  (enables jax x64, as the reference runs)
from repro import compile as jcompile
from repro import models as jmodels
from repro_torch import compile as tcompile
from repro_torch.convert import model_from_params

QUANT_TAGS = {
    "fxp32": dict(number_format="fxp32"),
    "fxp16": dict(number_format="fxp16"),
    "fxp16_pwl4": dict(number_format="fxp16", sigmoid="pwl4"),
    "auto16": dict(number_format="auto16"),
    "auto8": dict(number_format="auto8"),
}
N_CALIBRATION = 256


def model_params(name, x, y):
    """(kind, extracted-params dict) of a seeded model whose output layer is
    fitted by least squares to one-hot labels (x, y), so that its labels
    vary as a trained model's do; hidden layers are seeded random."""
    rng = np.random.RandomState({"mlp1": 11, "mlp2": 12, "logistic": 13}[name])
    x = np.asarray(x, np.float64)
    onehot = np.eye(int(y.max()) + 1)[y]

    def readout(h):
        sol = np.linalg.lstsq(np.c_[h, np.ones(len(h))], onehot, rcond=None)[0]
        return sol[:-1].astype(np.float32), sol[-1].astype(np.float32)

    if name == "logistic":
        coef, intercept = readout(x)
        return "logistic", {"coef": coef, "intercept": intercept}
    sizes = {"mlp1": (12, 16, 3), "mlp2": (12, 16, 8, 3)}[name]
    weights, biases, h = [], [], x
    for i, o in zip(sizes[:-2], sizes[1:-1]):
        weights.append((rng.randn(i, o) * 0.3).astype(np.float32))
        biases.append((rng.randn(o) * 0.5).astype(np.float32))
        h = 1.0 / (1.0 + np.exp(-(h @ weights[-1] + biases[-1])))
    w, b = readout(h)
    return "mlp", {"weights": weights + [w], "biases": biases + [b]}


def jax_model(kind, params):
    if kind == "mlp":
        return jmodels.MLPModel(weights=list(params["weights"]),
                                biases=list(params["biases"]))
    return jmodels.LogisticModel(params["coef"], params["intercept"])


@contextlib.contextmanager
def megakernel_budget(value):
    """Set ``REPRO_MEGAKERNEL_VMEM`` (both packages read it) for a block."""
    old = os.environ.get("REPRO_MEGAKERNEL_VMEM")
    if value is None:
        os.environ.pop("REPRO_MEGAKERNEL_VMEM", None)
    else:
        os.environ["REPRO_MEGAKERNEL_VMEM"] = str(value)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("REPRO_MEGAKERNEL_VMEM", None)
        else:
            os.environ["REPRO_MEGAKERNEL_VMEM"] = old


class PairCache:
    """Compiles each (model, tag, backend, per-layer) once per session, in
    both packages: ``pair(...) -> (jax_artifact, port_artifact)``."""

    def __init__(self, x_train, y_train, n_calibration=N_CALIBRATION):
        self.x_train, self.y_train = x_train, y_train
        self.x_cal = x_train[:n_calibration]
        self._memo = {}

    def params(self, name):
        return model_params(name, self.x_train, self.y_train)

    def pair(self, name, tag, backend, per_layer=False):
        key = (name, tag, backend, per_layer)
        if key not in self._memo:
            kind, params = self.params(name)
            kw = QUANT_TAGS.get(tag, dict(number_format=tag))
            jbackend = {"cuda": "pallas", "ref": "ref"}[backend]
            cal = self.x_cal if kw["number_format"].startswith("auto") else None
            with megakernel_budget(0 if per_layer else None):
                jart = jcompile.compile(
                    jax_model(kind, params),
                    jcompile.Target(backend=jbackend, **kw), calibration=cal)
                tart = tcompile.compile(
                    model_from_params(kind, params),
                    tcompile.Target(backend=backend, **kw), calibration=cal,
                    device="cpu")
            self._memo[key] = (jart, tart)
        return self._memo[key]


def assert_same_spec(jspec, tspec):
    """emit_spec equality: formats by (bits, frac), arrays byte for byte."""
    assert jspec.keys() == tspec.keys()
    for key, jv in jspec.items():
        tv = tspec[key]
        if key.endswith("fmt"):
            assert (jv.total_bits, jv.frac_bits) == (tv.total_bits,
                                                     tv.frac_bits), key
        elif key.endswith("fmts"):
            assert [(f.total_bits, f.frac_bits) for f in jv] == \
                [(f.total_bits, f.frac_bits) for f in tv], key
        elif key in ("ws", "bs"):
            assert len(jv) == len(tv)
            for ja, ta in zip(jv, tv):
                assert ja.dtype == ta.dtype and ja.shape == ta.shape, key
                assert ja.tobytes() == ta.tobytes(), key
        elif key in ("w", "b"):
            assert jv.dtype == tv.dtype and jv.tobytes() == tv.tobytes(), key
        else:
            assert list(np.atleast_1d(jv)) == list(np.atleast_1d(tv)), key


def float_logits(kind, params, x):
    """Float64 logits from the same params, in numpy (the flt yardstick)."""
    h = np.asarray(x, np.float64)
    if kind == "logistic":
        return h @ params["coef"] + params["intercept"]
    ws, bs = params["weights"], params["biases"]
    for i, (w, b) in enumerate(zip(ws, bs)):
        h = h @ w + b
        if i < len(ws) - 1:
            h = 1.0 / (1.0 + np.exp(-h))
    return h


# --------------------------------------------------------------------------
# the serving slice: a fleet of small models on shared blobs data
# (the sizes of tests/test_fleet.py: F=8, C=3, MLP hidden (8,), E=3)
# --------------------------------------------------------------------------
FLEET_F, FLEET_C = 8, 3
SVM_KW = {"rbf": dict(gamma=0.125, coef0=0.0, degree=2),
          "poly": dict(gamma=0.125, coef0=1.0, degree=2)}


def fleet_blobs(seed=7, n=360):
    """(x_train, y_train, x_test, y_test) of the reference's fleet tests."""
    rng = np.random.RandomState(seed)
    means = rng.randn(FLEET_C, FLEET_F) * 4.0
    y = rng.randint(0, FLEET_C, n).astype(np.int32)
    x = (means[y] + rng.randn(n, FLEET_F)).astype(np.float32)
    return x[:240], y[:240], x[240:], y[240:]


def fleet_params(kind, seed, x, y):
    """(kind, extracted params) of a seeded fleet member fitted to (x, y):
    an 8->8->3 MLP, a logistic model, or a poly/rbf SVM on 12 prototypes
    (``kind`` 'mlp', 'logistic', 'svm-poly', 'svm-rbf')."""
    rng = np.random.RandomState(100 + seed)
    x64 = np.asarray(x, np.float64)
    onehot = np.eye(FLEET_C)[y]

    def readout(h):
        sol = np.linalg.lstsq(np.c_[h, np.ones(len(h))], onehot, rcond=None)[0]
        return sol[:-1], sol[-1]

    if kind == "mlp":
        w0 = (rng.randn(FLEET_F, 8) * 0.3).astype(np.float32)
        b0 = (rng.randn(8) * 0.5).astype(np.float32)
        w1, b1 = readout(1.0 / (1.0 + np.exp(-(x64 @ w0 + b0))))
        return kind, {"weights": [w0, w1.astype(np.float32)],
                      "biases": [b0, b1.astype(np.float32)]}
    if kind == "logistic":
        coef, icept = readout(x64 + rng.randn(*x64.shape) * 0.5)
        return kind, {"coef": coef.astype(np.float32),
                      "intercept": icept.astype(np.float32)}
    svm = kind[len("svm-"):]
    sv = x64[rng.choice(len(x64), 12, replace=False)] * 0.5
    consts = SVM_KW[svm]
    dot = (x64 * 0.5) @ sv.T
    if svm == "poly":
        k = (consts["gamma"] * dot + consts["coef0"]) ** consts["degree"]
    else:
        d2 = ((x64 * 0.5) ** 2).sum(1)[:, None] - 2 * dot + (sv * sv).sum(1)
        k = np.exp(-consts["gamma"] * d2)
    dual, icept = readout(k)
    return kind, {"kernel": svm, "support_vectors": sv, "dual_coef": dual,
                  "intercept": icept, **consts}


def jax_fleet_model(kind, params):
    if kind.startswith("svm-"):
        return jmodels.SVMModel(params["kernel"],
                                support_vectors=params["support_vectors"],
                                dual_coef=params["dual_coef"],
                                intercept=params["intercept"],
                                gamma=params["gamma"], coef0=params["coef0"],
                                degree=params["degree"])
    return jax_model(kind, params)


def compile_pair(kind, params, number_format, calibration=None):
    """(reference artifact on pallas, port artifact on cuda on the host)."""
    kw = dict(number_format=number_format)
    jart = jcompile.compile(jax_fleet_model(kind, params),
                            jcompile.Target(backend="pallas", **kw),
                            calibration=calibration)
    tart = tcompile.compile(model_from_params(kind, params),
                            tcompile.Target(backend="cuda", **kw),
                            calibration=calibration, device="cpu")
    return jart, tart
