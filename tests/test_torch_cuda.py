"""The port's CUDA kernels on the card (skipped on hosts without one).

Each kernel against its plain PyTorch version, bit for bit, and the compiled
artifacts on the card against the same artifacts on the host.  Run on the
GPU host without the reference package's conftest (which imports JAX):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch import compile as tc
from repro_torch.core.fixedpoint import FxpFormat, quantize
from repro_torch.kernels import (fxp_layer, fxp_model, fxp_qmatmul, ops,
                                 tree_ensemble)
from repro_torch.models import (LogisticModel, SVMModel, init_mlp,
                                train_decision_tree)

pytestmark = pytest.mark.cuda
ACTS = fxp_layer.LAYER_ACTIVATIONS
NP = {8: np.int8, 16: np.int16, 32: np.int32}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _ints(rng, shape, bits, full):
    mag = bits - 1 if full else {8: 3, 16: 7, 32: 12}[bits]
    return torch.from_numpy(rng.randint(-(2 ** mag), 2 ** mag, shape)
                            .astype(NP[bits]))


@pytest.mark.parametrize("full", [False, True], ids=["mid", "full"])
@pytest.mark.parametrize("bits", [8, 16, 32])
def test_fxp_layer_kernel_matches_plain(dev, bits, full):
    rng = np.random.RandomState(bits)
    for act in ACTS:
        for m, k, n in ((1, 561, 64), (37, 64, 6), (300, 561, 6)):
            fmt = FxpFormat(bits, bits - 1 if full else bits - 6)
            shift = bits - 1 if full else 7
            a, b = _ints(rng, (m, k), bits, full), _ints(rng, (k, n), bits, full)
            bias = _ints(rng, (n,), bits, True)
            a, b, bias = a.to(dev), b.to(dev), bias.to(dev)
            got = fxp_layer.fxp_layer_cuda(a, b, bias, fmt, act, shift)
            want = fxp_layer.fxp_layer_plain(a, b, bias, fmt, act, shift)
            assert torch.equal(got, want), (act, m, k, n)


@pytest.mark.parametrize("bits", [8, 16, 32])
def test_fxp_mlp_model_kernel_matches_plain(dev, bits):
    rng = np.random.RandomState(bits)
    for act in ACTS:
        for m in (1, 33, 500):
            x = _ints(rng, (m, 561), bits, False).to(dev)
            ws = [_ints(rng, s, bits, False).to(dev)
                  for s in ((561, 64), (64, 6))]
            bs = [_ints(rng, (s,), bits, True).to(dev) for s in (64, 6)]
            sched = ((7, FxpFormat(bits, bits - 6), act),
                     (3, FxpFormat(bits, bits - 6), "none"))
            before = fxp_model.fxp_mlp_model_cuda.launches
            got = ops.fxp_mlp_model(x, ws, bs, sched)
            assert fxp_model.fxp_mlp_model_cuda.launches == before + 1
            want = fxp_model.fxp_mlp_model_plain(x, ws, bs, sched)
            assert torch.equal(got, want), (act, m)


@pytest.mark.parametrize("number_format", ["fxp16", "auto8"])
def test_artifacts_on_card_match_host(dev, number_format):
    rng = np.random.RandomState(0)
    x = (rng.randn(300, 561) * 2).astype(np.float32)
    models = [init_mlp([561, 64, 6], seed=0),
              LogisticModel((rng.randn(561, 6) * 0.1).astype(np.float32),
                            np.zeros(6, np.float32))]
    for model in models:
        target = tc.Target(number_format=number_format, backend="cuda")
        card = tc.compile(model, target, calibration=x[:64])
        host = tc.compile(model, target, calibration=x[:64], device="cpu")
        assert card.device.type == "cuda"
        np.testing.assert_array_equal(card.predict(x), host.predict(x))


@pytest.mark.parametrize("full", [False, True], ids=["mid", "full"])
@pytest.mark.parametrize("bits", [8, 16, 32])
def test_fxp_qmatmul_kernel_matches_plain(dev, bits, full):
    rng = np.random.RandomState(bits + 100)
    fmt = FxpFormat(bits, bits - 2 if full else bits - 6)
    for m, k, n in ((1, 561, 300), (37, 561, 300), (300, 8, 300)):
        a, b = _ints(rng, (m, k), bits, full), _ints(rng, (k, n), bits, full)
        a, b = a.to(dev), b.to(dev)
        before = fxp_qmatmul.fxp_qmatmul_cuda.launches
        got = ops.fxp_qmatmul(a, b, fmt)
        assert fxp_qmatmul.fxp_qmatmul_cuda.launches == before + 1
        assert torch.equal(got, fxp_qmatmul.fxp_qmatmul_plain(a, b, fmt))


@pytest.mark.parametrize("full", [False, True], ids=["mid", "full"])
@pytest.mark.parametrize("kind", ["poly", "rbf"])
@pytest.mark.parametrize("bits", [8, 16, 32])
def test_fxp_svm_model_kernel_matches_plain(dev, bits, kind, full):
    rng = np.random.RandomState(bits + (kind == "rbf"))
    frac = bits - 2 if full else bits - 6
    fmt, out_fmt = FxpFormat(bits, frac), FxpFormat(bits, frac - 1)
    for m, f, s, c in ((1, 561, 300, 6), (33, 561, 300, 6), (500, 8, 300, 10)):
        x, sv = _ints(rng, (m, f), bits, full), _ints(rng, (s, f), bits, full)
        x[0] = 2 ** (bits - 1) - 1
        dual, icept = _ints(rng, (s, c), bits, False), _ints(rng, (c,), bits,
                                                              True)
        qg = int(rng.randint(1, 2 ** min(frac + 1, bits - 1)))
        qc = int(rng.randint(-2 ** frac, 2 ** frac))
        args = [t.to(dev) for t in (x, sv, dual, icept)] + [
            kind, fmt, out_fmt, qg, qc, 1 + m % 3, frac // 2 + 1]
        before = fxp_model.fxp_svm_model_cuda.launches
        got = ops.fxp_svm_model(*args)
        assert fxp_model.fxp_svm_model_cuda.launches == before + 1
        assert torch.equal(got, fxp_model.fxp_svm_model_plain(*args)), (m, f)


def test_tree_ensemble_kernel_matches_plain(dev):
    rng = np.random.RandomState(3)
    x = rng.randn(2000, 40).astype(np.float32)
    y = ((x[:, 0] > 0).astype(np.int32) + (x[:, 7] > 0.5)
         + (x[:, 30] < -1)).astype(np.int32)
    tree = train_decision_tree(x, y, 4, max_depth=8).tree
    rows = rng.randn(700, 40).astype(np.float32)
    rows[0, 5], rows[1, 39], rows[2, int(tree.feature[0])] = np.nan, np.inf, \
        -np.inf
    rows[3, [1, 2]] = -np.inf
    cases = [(tree, torch.from_numpy(rows).to(dev))]
    for fmt in (FxpFormat(16, 4), FxpFormat(32, 10)):
        qx = quantize(torch.from_numpy(rows), fmt).to(torch.float32)
        cases.append((tree.quantized(fmt), qx.to(dev)))
    for t, xs in cases:
        for m in (1, 255, 700):
            before = tree_ensemble.tree_ensemble_cuda.launches
            got = ops.tree_predict(t, xs[:m])
            assert tree_ensemble.tree_ensemble_cuda.launches == before + 1
            assert torch.equal(got, tree_ensemble.tree_ensemble_plain(
                t, xs[:m]))


@pytest.mark.parametrize("number_format", ["fxp16", "auto8", "flt"])
def test_tree_svm_artifacts_on_card_match_host(dev, number_format):
    rng = np.random.RandomState(1)
    x = rng.randn(400, 20).astype(np.float32)
    y = ((x[:, 0] > 0).astype(np.int32) + (x[:, 3] > 0.5)).astype(np.int32)
    sv = x[:30].astype(np.float64)
    models = [train_decision_tree(x, y, 3, max_depth=6),
              SVMModel("linear", coef=rng.randn(20, 3).astype(np.float32),
                       intercept=np.zeros(3, np.float32))]
    models += [SVMModel(k, support_vectors=sv, dual_coef=rng.randn(30, 3),
                        intercept=rng.randn(3), gamma=0.125, coef0=1.0,
                        degree=2) for k in ("poly", "rbf")]
    if number_format == "flt":
        models = models[:1]  # float matmuls may round differently per device
    for model in models:
        target = tc.Target(number_format=number_format, backend="cuda")
        card = tc.compile(model, target, calibration=x[:64])
        host = tc.compile(model, target, calibration=x[:64], device="cpu")
        np.testing.assert_array_equal(card.predict(x), host.predict(x))
