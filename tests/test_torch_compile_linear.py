"""The port's logistic path against the reference, plus the slice's
cross-cutting contracts: float targets within tolerance, no JAX import
anywhere in the port, no silent host fallback, unported kernels raise."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_port_cases import (QUANT_TAGS, PairCache, assert_same_spec,
                               fleet_blobs, fleet_params, float_logits,
                               jax_model)
from repro import compile as jcompile
from repro_torch import compile as tcompile
from repro_torch.compile.lowerings.common import require_full_float32
from repro_torch.convert import model_from_params
from repro_torch.kernels import ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Rows whose float top-2 logit gap is below this may flip between two
# float32 evaluation orders (XLA vs PyTorch matmul and sigmoid).
FLT_GAP = 1e-4


@pytest.fixture(scope="module")
def cases(blobs):
    x_train, y_train, x_test, _, _ = blobs
    return PairCache(x_train, y_train), x_test


@pytest.mark.parametrize("backend", ["cuda", "ref"])
@pytest.mark.parametrize("tag", QUANT_TAGS)
def test_logistic_matches_reference(cases, tag, backend):
    cache, x = cases
    jart, tart = cache.pair("logistic", tag, backend)
    assert tart.kernel_strategy is None and jart.kernel_strategy is None
    assert tart.plan_key == jart.plan_key
    assert_same_spec(jart.extras["emit_spec"], tart.extras["emit_spec"])
    jlab, jstats = jart.predict_with_stats(x)
    tlab, tstats = tart.predict_with_stats(x)
    np.testing.assert_array_equal(tlab, jlab)
    assert tstats == jstats


@pytest.mark.parametrize("backend", ["cuda", "ref"])
@pytest.mark.parametrize("name", ["mlp1", "mlp2", "logistic"])
def test_flt_matches_within_gap(cases, name, backend):
    cache, x = cases
    jart, tart = cache.pair(name, "flt", backend)
    logits = float_logits(*cache.params(name), x)
    top2 = np.sort(logits, axis=1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) >= FLT_GAP
    assert decided.mean() > 0.9  # the check must cover most rows
    np.testing.assert_array_equal(tart.predict(x)[decided],
                                  jart.predict(x)[decided])


@pytest.fixture
def matmul_precision():
    """Restores the float32 matmul precision settings a test changes."""
    backends = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)
    saved = [b.fp32_precision for b in backends]
    yield
    for b, v in zip(backends, saved):
        b.fp32_precision = v


@pytest.mark.parametrize("name", ["mlp1", "logistic", "svm-rbf"])
def test_float_targets_refuse_reduced_precision_matmuls(cases, name,
                                                        matmul_precision):
    # Compiling a float target changes no process-wide setting, and a float
    # predict run after reduced-precision matmuls were turned on raises
    # rather than give their labels.
    cache, x = cases
    cuda_mm, cpu_mm = torch.backends.cuda.matmul, torch.backends.mkldnn.matmul
    cuda_mm.fp32_precision = "tf32"
    if name == "svm-rbf":
        xtr, ytr, x, _ = fleet_blobs()
        model = model_from_params(*fleet_params(name, 0, xtr, ytr))
    else:
        model = model_from_params(*cache.params(name))
    art = tcompile.compile(model, tcompile.Target(number_format="flt",
                                                  backend="cuda"),
                           device="cpu")
    assert cuda_mm.fp32_precision == "tf32"
    labels = art.predict(x)  # the CUDA setting leaves host matmuls alone
    with pytest.raises(RuntimeError, match="full float32"):
        require_full_float32(torch.device("cuda"))
    for reduced in ("bf16", "tf32"):
        cpu_mm.fp32_precision = reduced
        with pytest.raises(RuntimeError, match="full float32"):
            art.predict(x)
    cpu_mm.fp32_precision = "ieee"
    cuda_mm.fp32_precision = "ieee"
    require_full_float32(torch.device("cuda"))
    np.testing.assert_array_equal(art.predict(x), labels)


def test_fixed_batch_policy_matches(cases):
    cache, x = cases
    kind, params = cache.params("mlp2")
    kw = dict(number_format="fxp16", batch_policy="fixed", batch_size=64)
    jart = jcompile.compile(jax_model(kind, params), jcompile.Target(**kw))
    tart = tcompile.compile(model_from_params(kind, params),
                            tcompile.Target(**kw), device="cpu")
    jlab, jstats = jart.predict_with_stats(x[:10])
    tlab, tstats = tart.predict_with_stats(x[:10])
    np.testing.assert_array_equal(tlab, jlab)
    assert tstats == jstats
    with pytest.raises(ValueError, match="exceeds"):
        tart.predict(x[:65])


def test_default_device_is_cuda_and_raises_without_one(cases, monkeypatch):
    kind, params = cases[0].params("mlp1")
    model = model_from_params(kind, params)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcompile.compile(model, tcompile.Target(number_format="fxp16",
                                                backend="cuda"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcompile.compile(model, tcompile.Target(number_format="fxp16"),
                         device="cuda")
    art = tcompile.compile(model, tcompile.Target(number_format="fxp16",
                                                  backend="cuda"),
                           device="cpu")
    assert art.device == torch.device("cpu")


def test_unported_kernels_and_backends_raise(cases):
    kind, params = cases[0].params("mlp1")
    model = model_from_params(kind, params)
    x = cases[1][:16]
    for sig in ("pwl4", "pwl2", "rational"):
        # ported: the flt PWL sigmoids on cuda go through pwl_activation,
        # one dispatch per hidden layer; the ref backend computes them in
        # plain torch ops, and both give the same labels
        art = tcompile.compile(model, tcompile.Target(sigmoid=sig,
                                                      backend="cuda"),
                               device="cpu")
        with ops.count_dispatches() as c:
            got = art.predict(x)
        assert c.count == len(params["weights"]) - 1
        ref = tcompile.compile(model, tcompile.Target(sigmoid=sig,
                                                      backend="ref"),
                               device="cpu")
        np.testing.assert_array_equal(got, ref.predict(x))
    # ported since: C emission is a backend of the port (tests/
    # test_torch_emit.py holds it against the reference)
    assert tcompile.Target(number_format="fxp16", backend="emit").backend \
        == "emit" and "emit" in tcompile.BACKENDS
    with pytest.raises(KeyError):
        tcompile.Target(backend="pallas")


def test_port_imports_neither_jax_nor_reference():
    """Every module of repro_torch imports with jax and repro unavailable,
    and chip_smoke.py names neither."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "repro"), n


@pytest.mark.parametrize("name", ["mlp1", "mlp2", "logistic"])
def test_model_containers_carry_params(cases, name):
    """A container made by model_from_params yields, through the port's
    lowering, exactly the params the reference lowering extracts."""
    cache, _ = cases
    kind, params = cache.params(name)
    model = model_from_params(kind, params)
    assert tcompile.model_kind(model) == kind
    got = tcompile.get_lowering(kind).extract_params(model)
    want = jcompile.get_lowering(kind).extract_params(jax_model(kind, params))
    assert got.keys() == want.keys()
    for key in want:
        g, w = got[key], want[key]
        for ga, wa in (zip(g, w) if isinstance(w, list) else [(g, w)]):
            assert ga.dtype == wa.dtype and ga.shape == wa.shape
            np.testing.assert_array_equal(ga, wa)
    if kind == "mlp":
        assert model.layer_sizes == jax_model(kind, params).layer_sizes
