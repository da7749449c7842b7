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
from repro_torch.core.fixedpoint import FxpFormat
from repro_torch.kernels import fxp_layer, fxp_model, ops
from repro_torch.models import LogisticModel, init_mlp

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
