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


def _regime_ints(rng, shape, bits, regime):
    """mid: a few units; full: the whole container; edge: only the
    container's extremes, 0 and -1."""
    if regime == "edge":
        lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
        return torch.from_numpy(rng.choice([lo, hi, 0, -1], size=shape)
                                .astype(NP[bits]))
    return _ints(rng, shape, bits, regime == "full")


@pytest.mark.parametrize("bits", [8, 16, 32])
def test_fxp_qmatmul_tensor_core_tile_matches_plain(dev, bits):
    """The tile on the int8 tensor cores (one, four or ten MMAs a product):
    M in {1, 7, 64, 3089, 65536} x K in {8, 33, 561} x N in {6, 300, 301},
    the regimes in turn, A a row slice (not 16-byte aligned) every other
    case; at 16 and 32 bits some int32 dot must wrap.  Then a K past the
    point where one s32 partial of full-range 16-bit values would overflow:
    the accumulators must wrap, not saturate."""
    rng = np.random.RandomState(bits + 200)
    regimes = ("mid", "full", "edge")
    wrapped, i = 0, 0
    for m in (1, 7, 64, 3089, 65536):
        for k in (8, 33, 561):
            for n in (6, 300, 301):
                regime, offset = regimes[i % 3], i % 2
                frac = {"mid": bits - 6, "full": bits - 2,
                        "edge": bits - 1}[regime]
                fmt = FxpFormat(bits, frac)
                a = _regime_ints(rng, (m + offset, k), bits, regime).to(dev)
                a = a[offset:]
                b = _regime_ints(rng, (k, n), bits, regime).to(dev)
                got = fxp_qmatmul.fxp_qmatmul_cuda(a, b, fmt)
                want = fxp_qmatmul.fxp_qmatmul_plain(a, b, fmt)
                assert torch.equal(got, want), (m, k, n, regime, offset)
                dot = a[:64].to(torch.float64) @ b.to(torch.float64)
                wrapped += int(dot.abs().max() >= 2 ** 31)
                i += 1
    assert bits == 8 or wrapped, "no case wrapped the int32 dot"
    fmt = FxpFormat(bits, bits - 1)
    a = _regime_ints(rng, (5, 40000), bits, "full").to(dev)
    b = _regime_ints(rng, (40000, 9), bits, "full").to(dev)
    assert torch.equal(fxp_qmatmul.fxp_qmatmul_cuda(a, b, fmt),
                       fxp_qmatmul.fxp_qmatmul_plain(a, b, fmt))


@pytest.mark.parametrize("bits", [8, 16, 32])
def test_fxp_layer_wide_route_on_row_slice_matches_plain(dev, bits):
    """fxp_layer's wide route (the tile shared with fxp_qmatmul) on row
    slices of A at odd offsets: the per-layer MLP's 561 x 64, and ragged K
    and N around the stage and the 64-wide tile, every activation in
    turn."""
    rng = np.random.RandomState(bits + 300)
    shapes = ((1, 561, 64), (7, 561, 64), (3089, 561, 64), (65536, 561, 64),
              (65, 33, 301), (64, 8, 40), (100, 129, 65))
    for i, (m, k, n) in enumerate(shapes):
        assert fxp_layer.narrow_plan(k, n) is None
        full = i % 2 == 1
        act = ACTS[i % len(ACTS)]
        fmt = FxpFormat(bits, bits - 1 if full else bits - 6)
        shift = bits - 1 if full else 7
        offset = 1 + 2 * (i % 2)
        a = _ints(rng, (m + offset, k), bits, full).to(dev)[offset:]
        b = _ints(rng, (k, n), bits, full).to(dev)
        bias = _ints(rng, (n,), bits, True).to(dev)
        before = fxp_layer.fxp_layer_cuda.launches
        got = fxp_layer.fxp_layer_cuda(a, b, bias, fmt, act, shift)
        assert fxp_layer.fxp_layer_cuda.launches == before + 1
        want = fxp_layer.fxp_layer_plain(a, b, bias, fmt, act, shift)
        assert torch.equal(got, want), (m, k, n, act)


@pytest.mark.parametrize("route", ["smem", "global"])
def test_tree_ensemble_containers_and_table_routes(dev, route, monkeypatch):
    """The kernel on float32 rows with non-finite values and on each
    integer container (int32 values in [2^24, 2^31), where the cast
    rounds, included), with the node table in shared memory and, with the
    budget lowered to 0 nodes, in device memory."""
    if route == "global":
        monkeypatch.setattr(tree_ensemble, "TABLE_SMEM_NODES", 0)
    rng = np.random.RandomState(5)
    x = rng.randn(3000, 40).astype(np.float32)
    y = ((x[:, 0] > 0).astype(np.int32) + (x[:, 7] > 0.5)
         + (x[:, 30] < -1)).astype(np.int32)
    tree = train_decision_tree(x, y, 4, max_depth=10).tree
    assert tree_ensemble.table_in_smem(tree.n_nodes) == (route == "smem")
    rows = rng.randn(4099, 40).astype(np.float32)
    rows[0, 5], rows[1, 39], rows[2, int(tree.feature[0])] = np.nan, np.inf, \
        -np.inf
    rows[3, [1, 2]] = -np.inf
    rows[40, 7], rows[41, 0] = -np.inf, np.nan
    cases = [(tree, torch.from_numpy(rows).to(dev))]
    for bits, frac in ((8, 4), (16, 8), (32, 10), (32, 28)):
        fmt = FxpFormat(bits, frac)
        qx = quantize(torch.from_numpy(np.nan_to_num(rows, posinf=5.0,
                                                     neginf=-5.0)), fmt)
        cases.append((tree.quantized(fmt), qx.to(dev)))
    big = torch.from_numpy(rng.randint(2 ** 24, 2 ** 31 - 1, (300, 40))
                           * rng.choice([-1, 1], (300, 40))).to(torch.int32)
    cases.append((tree.quantized(FxpFormat(32, 28)), big.to(dev)))
    for t, xs in cases:
        for m in (1, 31, 33, 700, xs.shape[0]):
            before = tree_ensemble.tree_ensemble_cuda.launches
            got = ops.tree_predict(t, xs[:m])
            assert tree_ensemble.tree_ensemble_cuda.launches == before + 1
            assert torch.equal(got, tree_ensemble.tree_ensemble_plain(
                t, xs[:m])), (xs.dtype, m)


@pytest.mark.parametrize("full", [False, True], ids=["mid", "full"])
@pytest.mark.parametrize("kind", ["poly", "rbf"])
@pytest.mark.parametrize("bits", [8, 16, 32])
def test_fxp_svm_model_kernel_matches_plain(dev, bits, kind, full):
    rng = np.random.RandomState(bits + (kind == "rbf"))
    frac = bits - 2 if full else bits - 6
    fmt, out_fmt = FxpFormat(bits, frac), FxpFormat(bits, frac - 1)
    # and the cluster's split of the support vectors: one vector to the fit
    # predicate's limit (1696), S not a multiple of G x 64, ragged batches
    # up to 65536 rows (D5 width where the plain version would be slow)
    split = [(m, 561 if s <= 300 and m <= 3089 else 8, s, 6)
             for s in (1, 31, 33, 300, 1696) for m in (1, 31, 3089, 65536)]
    assert fxp_model.svm_fits_smem(1696)
    for m, f, s, c in ((1, 561, 300, 6), (33, 561, 300, 6), (500, 8, 300, 10),
                       *split):
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


# --------------------------------------------------------------------------
# the serving slice: pwl_activation, the fleet kernels, the service
# --------------------------------------------------------------------------
PWL_EDGES = [0.0, -0.0, 1.0, -1.0, 2.375, -2.375, 5.0, -5.0, np.inf, -np.inf,
             np.nan, 1e-45, -1e-45, 1e-39, -1e-39, 3.4e38, -3.4e38]


@pytest.mark.parametrize("variant", ["pwl2", "pwl4", "rational", "silu_pwl4"])
def test_pwl_activation_kernel_matches_plain(dev, variant):
    from repro_torch.kernels import pwl_activation

    rng = np.random.RandomState(5)
    for shape in ((3089, 64), (7, 13), (1,), (5, 3, 2)):
        x = (rng.randn(*shape) * 4).astype(np.float32)
        flat = x.reshape(-1)
        flat[:len(PWL_EDGES)] = np.asarray(PWL_EDGES, np.float32)[:flat.size]
        xt = torch.from_numpy(x).to(dev)
        before = pwl_activation.pwl_activation_cuda.launches
        got = ops.pwl_activation(xt, variant)
        assert pwl_activation.pwl_activation_cuda.launches == before + 1
        want = pwl_activation.pwl_activation_plain(xt, variant)
        assert got.shape == xt.shape
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # an unaligned view takes the element-by-element path
    xt = torch.from_numpy(rng.randn(1001).astype(np.float32)).to(dev)[1:]
    assert torch.equal(ops.pwl_activation(xt, variant).view(torch.int32),
                       pwl_activation.pwl_activation_plain(
                           xt, variant).view(torch.int32))


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("variant", ["pwl2", "pwl4", "rational", "silu_pwl4"])
def test_pwl_activation_narrow_floats_match_plain(dev, variant, dtype):
    """float16 and bfloat16 load and store narrow, compute in float32 and
    round to nearest even: bit for bit against the plain version's cast."""
    from repro_torch.kernels import pwl_activation

    dt = getattr(torch, dtype)
    rng = np.random.RandomState(6)
    for shape, offset in (((3089, 64), 0), ((7, 13), 0), ((1,), 0),
                          ((4097,), 1)):
        flat = (rng.randn(int(np.prod(shape)) + offset) * 4).astype(
            np.float32)
        flat[offset:offset + len(PWL_EDGES)] = np.asarray(
            PWL_EDGES, np.float32)[:flat.size - offset]
        xt = torch.from_numpy(flat).to(dev).to(dt)[offset:].view(shape)
        before = pwl_activation.pwl_activation_cuda.launches
        got = ops.pwl_activation(xt, variant)
        assert pwl_activation.pwl_activation_cuda.launches == before + 1
        want = pwl_activation.pwl_activation_plain(xt, variant)
        assert got.dtype == dt and got.shape == xt.shape
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("variant", ["pwl2", "pwl4", "rational", "silu_pwl4"])
def test_pwl_activation_bias_matches_plain(dev, variant, dtype):
    """The fused bias at widths that cross the kernel's 16-byte vectors,
    non-finite values in x and in the bias, and a view off the 16-byte
    boundary: bit for bit against the plain version's ``pwl(x + b)``."""
    from repro_torch.kernels import pwl_activation

    dt = getattr(torch, dtype)
    as_int = torch.int32 if dtype == "float32" else torch.int16
    rng = np.random.RandomState(9)
    for width in (1, 6, 7, 33, 64, 561, 4864):
        for rows, offset in ((1, 0), (5, 0), (3089, 0), (7, 1)):
            flat = (rng.randn(rows * width + offset) * 4).astype(np.float32)
            flat[offset:offset + len(PWL_EDGES)] = np.asarray(
                PWL_EDGES, np.float32)[:flat.size - offset]
            x = torch.from_numpy(flat).to(dev).to(dt)[offset:].view(
                rows, width)
            b = (rng.randn(width) * 2).astype(np.float32)
            b[:4] = np.asarray([-0.0, np.inf, -np.inf, np.nan])[:width]
            b = torch.from_numpy(b).to(dev).to(dt)
            before = pwl_activation.pwl_activation_cuda.launches
            got = ops.pwl_activation(x, variant, bias=b)
            assert pwl_activation.pwl_activation_cuda.launches == before + 1
            want = pwl_activation.pwl_activation_plain(x, variant, bias=b)
            assert got.dtype == dt and got.shape == x.shape
            assert torch.equal(got.view(as_int), want.view(as_int)), (
                width, rows, offset)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_pwl4_gate_is_one_launch(dev, dtype):
    """On a CUDA tensor the LM's pwl4 SiLU gate is one silu_pwl4 launch,
    equal to the kernel route's plain version; the exact gate launches
    nothing of the port."""
    from repro_torch.kernels import pwl_activation
    from repro_torch.lm import layers

    x = torch.randn(4, 4864, generator=torch.Generator().manual_seed(0))
    x = (x * 4).to(dev).to(getattr(torch, dtype))
    before = pwl_activation.pwl_activation_cuda.launches
    got = layers.gated_silu(x, "pwl4")
    assert pwl_activation.pwl_activation_cuda.launches == before + 1
    want = pwl_activation.pwl_activation_plain(x, "silu_pwl4")
    assert torch.equal(got, want)
    layers.gated_silu(x, "exact")
    assert pwl_activation.pwl_activation_cuda.launches == before + 1


@pytest.mark.parametrize("bits", [8, 16, 32])
def test_fxp_mlp_fleet_kernel_matches_plain(dev, bits):
    rng = np.random.RandomState(bits + 7)
    for e, m in ((2, 1), (3, 33), (8, 500)):
        x = _ints(rng, (e, m, 561), bits, False).to(dev)
        ws = [_ints(rng, (e,) + s, bits, False).to(dev)
              for s in ((561, 64), (64, 6))]
        bs = [_ints(rng, (e, s), bits, True).to(dev) for s in (64, 6)]
        scheds = tuple(
            ((7 + i % 3, FxpFormat(bits, bits - 6 - i % 2), ACTS[i % 5]),
             (3 + i % 2, FxpFormat(bits, bits - 6), "none"))
            for i in range(e))
        before = fxp_model.fxp_mlp_fleet_cuda.launches
        got = ops.fxp_mlp_fleet(x, ws, bs, scheds)
        assert fxp_model.fxp_mlp_fleet_cuda.launches == before + 1
        want = fxp_model.fxp_mlp_fleet_plain(x, ws, bs, scheds)
        assert torch.equal(got, want), (e, m)
        for i in range(e):  # slot i is model i's own megakernel launch
            own = fxp_model.fxp_mlp_model_cuda(x[i], [w[i] for w in ws],
                                               [b[i] for b in bs], scheds[i])
            assert torch.equal(got[i], own)


def _edge_ints(rng, shape, bits):
    """Only the container's extremes and their neighbours: 16-bit dots
    wrap int32."""
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    return torch.from_numpy(np.choose(rng.randint(0, 5, shape),
                                      [lo, lo + 1, -1, hi - 1, hi])
                            .astype(NP[bits]))


MLP_EDGE_SHAPES = (  # (E or 0 for one model, M, widths)
    (0, 3089, (561, 64, 6)), (0, 31, (8, 16, 10)), (0, 17, (33, 40, 6)),
    (0, 1, (64, 10)), (0, 16, (561, 6)), (0, 65536, (561, 64, 6)),
    (0, 40, (40, 32, 24, 48, 16, 33, 8, 12, 6)), (2, 3089, (561, 64, 6)),
    (8, 3089, (561, 6)), (8, 33, (561, 64, 6)))


@pytest.mark.parametrize("edge", [False, True], ids=["mid", "edge"])
@pytest.mark.parametrize("bits", [8, 16, 32])
def test_fxp_mlp_tensor_core_edges_match_plain(dev, bits, edge):
    """The MLP megakernels (int8 tensor cores at 8 and 16 bits) against
    their plain versions: K not a multiple of 32, N not a multiple of 8,
    batches around the 16-row tile, 8 layers, fleet slices that start off a
    16-byte boundary (M 3089, K 561), a logistic fleet (one layer), widths
    at the routing predicate's limit, and edge values whose int32 dots
    wrap."""
    rng = np.random.RandomState(bits + 3 * edge)
    limit = 232_448 // (2 * 32 * bits // 8)
    shapes = MLP_EDGE_SHAPES + ((0, 20, (limit, 64, 6)),
                                (2, 9, (48, limit, 6)))
    wrapped = 0
    for e, m, dims in shapes:
        n = max(e, 1)
        if edge:
            x = _edge_ints(rng, (n, m, dims[0]), bits)
            ws = [_edge_ints(rng, (n, i, o), bits)
                  for i, o in zip(dims, dims[1:])]
        else:
            x = _ints(rng, (n, m, dims[0]), bits, False)
            ws = [_ints(rng, (n, i, o), bits, False)
                  for i, o in zip(dims, dims[1:])]
        bs = [_ints(rng, (n, o), bits, True) for o in dims[1:]]
        dot = x[0, :64].double() @ ws[0][0].double()
        wrapped += int(dot.abs().max() >= 2 ** 31)
        scheds = tuple(
            tuple(((0 if edge else 7) + (j + l) % 2,
                   FxpFormat(bits, bits - 1 if edge else bits - 6),
                   ACTS[(j + l) % len(ACTS)] if l < len(dims) - 2
                   else "none")
                  for l in range(len(dims) - 1))
            for j in range(n))
        x, ws, bs = x.to(dev), [w.to(dev) for w in ws], [b.to(dev) for b in bs]
        if e:
            got = fxp_model.fxp_mlp_fleet_cuda(x, ws, bs, scheds)
            want = fxp_model.fxp_mlp_fleet_plain(x, ws, bs, scheds)
        else:
            args = (x[0], [w[0] for w in ws], [b[0] for b in bs], scheds[0])
            got = fxp_model.fxp_mlp_model_cuda(*args)
            want = fxp_model.fxp_mlp_model_plain(*args)
        assert torch.equal(got, want), (e, m, dims)
    if bits == 16 and edge:
        assert wrapped, "no case wrapped the int32 dot"


@pytest.mark.parametrize("kind", ["poly", "rbf"])
@pytest.mark.parametrize("bits", [8, 16, 32])
def test_fxp_svm_fleet_kernel_matches_plain(dev, bits, kind):
    rng = np.random.RandomState(bits + 11 + (kind == "rbf"))
    for e, m, f, s, c in ((2, 1, 561, 300, 6), (4, 37, 8, 300, 10)):
        x = _ints(rng, (e, m, f), bits, False).to(dev)
        sv = _ints(rng, (e, s, f), bits, False).to(dev)
        dual = _ints(rng, (e, s, c), bits, False).to(dev)
        icept = _ints(rng, (e, c), bits, True).to(dev)
        params = []
        for i in range(e):
            frac = bits - 6 - i % 2
            params.append((FxpFormat(bits, frac), FxpFormat(bits, frac - 1),
                           int(rng.randint(1, 2 ** min(frac, bits - 2))),
                           int(rng.randint(-2 ** frac, 2 ** frac)),
                           1 + i % 3, frac // 2 + i % 2))
        before = fxp_model.fxp_svm_fleet_cuda.launches
        got = ops.fxp_svm_fleet(x, sv, dual, icept, kind, params)
        assert fxp_model.fxp_svm_fleet_cuda.launches == before + 1
        want = fxp_model.fxp_svm_fleet_plain(x, sv, dual, icept, kind, params)
        assert torch.equal(got, want), (e, m, f)


@pytest.mark.parametrize("n", [1, 6, 10, 31, 32, 33])
@pytest.mark.parametrize("bits", [8, 16, 32])
def test_fxp_layer_narrow_route_matches_plain(dev, bits, n):
    """The narrow route's shapes (N <= 32; 33 takes the tile loop) at K 1,
    8, 300 and 561, every activation in turn, A a row slice (not 16-byte
    aligned), full-range sums that wrap; and the largest K whose weights
    fit the narrow route beside the first K past it."""
    rng = np.random.RandomState(bits * 3 + n)
    k_fit = max([k for k in range(1, 8192) if fxp_layer.narrow_plan(k, n)]
                or [561])
    cases = [(k, m, full) for k in (1, 8, 300, 561)
             for m, full in ((1, True), (37, False), (3089, True))]
    cases += [(k_fit, 65, False), (k_fit + 1, 65, False)]
    for i, (k, m, full) in enumerate(cases):
        act = ACTS[i % len(ACTS)]
        fmt = FxpFormat(bits, bits - 1 if full else bits - 6)
        shift = bits - 1 if full else 7
        a = _ints(rng, (m + 1, k), bits, full).to(dev)[1:]
        b = _ints(rng, (k, n), bits, full).to(dev)
        bias = _ints(rng, (n,), bits, True).to(dev)
        got = fxp_layer.fxp_layer_cuda(a, b, bias, fmt, act, shift)
        want = fxp_layer.fxp_layer_plain(a, b, bias, fmt, act, shift)
        assert torch.equal(got, want), (k, m, act)


@pytest.mark.parametrize("kind", ["poly", "rbf"])
@pytest.mark.parametrize("bits", [8, 16, 32])
def test_fxp_svm_fleet_cluster_slots_match_model_kernel(dev, bits, kind):
    """The fleet on the cluster body: E in {1, 2, 4, 8} x S around the
    cluster split, each model its own parameters; the fleet equals its
    plain version and each slot equals ``fxp_svm_model_cuda`` of that
    model."""
    rng = np.random.RandomState(bits * 5 + (kind == "rbf"))
    for i, (e, s) in enumerate((e, s) for e in (1, 2, 4, 8)
                               for s in (1, 31, 33, 300, 1696)):
        m = (1, 31, 3298)[i % 3]
        x = _ints(rng, (e, m, 8), bits, False).to(dev)
        sv = _ints(rng, (e, s, 8), bits, False).to(dev)
        dual = _ints(rng, (e, s, 10), bits, False).to(dev)
        icept = _ints(rng, (e, 10), bits, True).to(dev)
        params = []
        for j in range(e):
            frac = bits - 6 - j % 2
            params.append((FxpFormat(bits, frac), FxpFormat(bits, frac - 1),
                           int(rng.randint(1, 2 ** min(frac, bits - 2))),
                           int(rng.randint(-2 ** frac, 2 ** frac)),
                           1 + j % 3, frac // 2 + j % 2))
        got = fxp_model.fxp_svm_fleet_cuda(x, sv, dual, icept, kind, params)
        want = fxp_model.fxp_svm_fleet_plain(x, sv, dual, icept, kind, params)
        assert torch.equal(got, want), (e, s, m)
        for j, p in enumerate(params):
            solo = fxp_model.fxp_svm_model_cuda(x[j], sv[j], dual[j],
                                                icept[j], kind, *p)
            assert torch.equal(got[j], solo), (e, s, m, j)


def test_service_fleet_on_card_matches_host(dev):
    from repro_torch.serve import BatchingPolicy, InferenceService

    rng = np.random.RandomState(2)
    x = (rng.randn(200, 20) * 2).astype(np.float32)
    results = {}
    for where in ("cuda", "cpu"):
        svc = InferenceService(device=where)
        try:
            for s in range(3):
                svc.register(f"m{s}", init_mlp([20, 16, 4], seed=s),
                             tc.Target(number_format="auto16",
                                       backend="cuda"),
                             calibration=x[20 * s:100 + 20 * s],
                             policy=BatchingPolicy(max_batch=8,
                                                   max_wait_ms=2))
            assert len(svc.enable_fleet()) == 1
            futs = [(n, svc.submit(n, x[i:i + 1 + i % 3]))
                    for i in range(60) for n in ("m0", "m1", "m2")]
            results[where] = [f.result(timeout=120) for _, f in futs]
            fleet = svc.stats()["_fleets"][0]
            assert fleet["stack_fallbacks"] == 0
        finally:
            svc.close()
    for a, b in zip(results["cuda"], results["cpu"]):
        np.testing.assert_array_equal(a, b)


def test_flt_pwl_mlp_on_card_launches_kernel(dev):
    from repro_torch.kernels import pwl_activation

    rng = np.random.RandomState(4)
    x = rng.randn(300, 30).astype(np.float32)
    for sig in ("pwl2", "pwl4", "rational"):
        art = tc.compile(init_mlp([30, 16, 4], seed=1),
                         tc.Target(sigmoid=sig, backend="cuda"))
        before = pwl_activation.pwl_activation_cuda.launches
        labels = art.predict(x)
        assert pwl_activation.pwl_activation_cuda.launches == before + 1
        assert labels.shape == (300,) and labels.max() < 4


def test_flt_predict_refuses_tf32_set_after_compile(dev):
    rng = np.random.RandomState(5)
    x = rng.randn(300, 30).astype(np.float32)
    matmul = torch.backends.cuda.matmul
    saved = matmul.fp32_precision
    art = tc.compile(init_mlp([30, 16, 4], seed=1), tc.Target(backend="cuda"))
    assert matmul.fp32_precision == saved  # compile changes no setting
    labels = art.predict(x)
    try:
        matmul.fp32_precision = "tf32"
        with pytest.raises(RuntimeError, match="full float32"):
            art.predict(x)
    finally:
        matmul.fp32_precision = saved
    np.testing.assert_array_equal(art.predict(x), labels)


def test_staging_buffer_event_follows_its_copy(dev):
    from repro_torch.compile.lowerings.common import as_input
    from repro_torch.serve.batching import StagingBuffer

    buf = StagingBuffer((4096, 561), np.float32, dev)
    assert buf.device == dev and buf.handed.is_pinned()
    view = buf.acquire()
    view[:] = 1.5
    on_card = as_input(buf.handed, dev)
    buf.release()
    assert buf.acquire() is view  # waited for the copy
    view[:] = 0.0
    assert bool((on_card == 1.5).all())


@pytest.mark.parametrize("dtype,atol,row_rtol", [(torch.float32, 2e-5, None),
                                                 (torch.bfloat16, 3e-2, 4e-2)])
def test_flash_attention_kernel_matches_plain(dev, dtype, atol, row_rtol):
    """float32 and bfloat16 (the reference's bounds; in bfloat16 also each
    row's max error within 4e-2 of the row's max |value|, as in
    chip_smoke.py), causal and full, every head dim, S around the 64-wide
    tiles and the prefill's 2048, one head and the LM's 56 (4 x 14 heads)
    with K/V of 56 rows and, grouped in the kernel, of 8 (G 7)."""
    from repro_torch.compile.lowerings.common import require_full_float32
    from repro_torch.kernels import flash_attention as fa

    require_full_float32(dev)  # the plain version's float32 products
    g = torch.Generator(device=dev).manual_seed(0)
    for causal in (True, False):
        for dh in fa.HEAD_DIMS:
            for s in (1, 7, 63, 64, 65, 129, 300, 2048):
                for bh, group in ((1, 1), (56, 1), (56, 7)):
                    q = torch.randn(bh, s, dh, generator=g, device=dev)
                    k, v = (torch.randn(bh // group, s, dh, generator=g,
                                        device=dev) for _ in range(2))
                    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
                    before = fa.flash_attention_cuda.launches
                    got = ops.flash_attention(q, k, v, causal)
                    assert fa.flash_attention_cuda.launches == before + 1
                    want = fa.flash_attention_plain(q, k, v, causal)
                    assert got.dtype == dtype and got.shape == want.shape
                    assert bool(torch.isfinite(got).all())
                    diff = (got.float() - want.float()).abs()
                    err = float(diff.max())
                    assert err <= atol, (causal, dh, bh, s, group, err)
                    if row_rtol is not None:
                        rel = float((diff.amax(-1) / want.float().abs()
                                     .amax(-1).clamp_min(1e-30)).max())
                        assert rel <= row_rtol, (causal, dh, bh, s, group, rel)
    with pytest.raises(ValueError, match="head dims up to"):
        fa.flash_attention_cuda(*(torch.zeros(1, 8, 129, device=dev)
                                  for _ in range(3)))
    with pytest.raises(TypeError, match="float tensors"):
        fa.flash_attention_cuda(*(torch.zeros(1, 8, 64, device=dev,
                                              dtype=torch.int32)
                                  for _ in range(3)))


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 3e-2),
                                        (torch.float16, 2.0 ** -8)])
def test_flash_attention_padded_head_dims_and_float16(dev, dtype, atol):
    """Head dims between the kernel's instances (56, 80, 112: deepseek-v3,
    hubert, zamba2) are zero-padded to the next instance and sliced back;
    float16 runs the float32 instance and rounds its output once (within
    one float16 ulp below 8 in magnitude)."""
    from repro_torch.compile.lowerings.common import require_full_float32
    from repro_torch.kernels import flash_attention as fa

    require_full_float32(dev)
    g = torch.Generator(device=dev).manual_seed(1)
    dims = (56, 80, 112) + ((32, 64, 128) if dtype == torch.float16 else ())
    for dh in dims:
        for s in (7, 65, 300):
            for causal in (True, False):
                q = torch.randn(56, s, dh, generator=g, device=dev).to(dtype)
                k, v = (torch.randn(8, s, dh, generator=g, device=dev)
                        .to(dtype) for _ in range(2))
                before = fa.flash_attention_cuda.launches
                got = ops.flash_attention(q, k, v, causal)
                assert fa.flash_attention_cuda.launches == before + 1
                want = fa.flash_attention_plain(q, k, v, causal)
                assert got.dtype == dtype and got.shape == q.shape
                err = float((got.float() - want.float()).abs().max())
                assert err <= atol, (dh, s, causal, err)


def test_lm_forward_on_card_launches_kernel_per_layer(dev):
    """A reduced qwen2 forward on the card: one flash_attention launch per
    layer, logits equal to the same forward through the oracle's
    attention, and to the host's."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.lm import model as M

    cfg = get_config("qwen2-0.5b").reduced()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    tok = torch.from_numpy(np.random.RandomState(0).randint(
        1, cfg.vocab_size, (2, 77)).astype(np.int32)).to(dev)
    before = fa.flash_attention_cuda.launches
    logits = M.forward(params, {"tokens": tok}, cfg)
    assert fa.flash_attention_cuda.launches == before + cfg.n_layers
    plain = M.forward(params, {"tokens": tok}, cfg, attn_impl="ref")
    assert fa.flash_attention_cuda.launches == before + cfg.n_layers
    scale = float(plain.abs().max())
    assert float((logits - plain).abs().max()) <= 1e-4 * scale
    host = M.forward({k: _to_cpu(v) for k, v in params.items()},
                     {"tokens": tok.cpu()}, cfg)
    assert float((logits.cpu() - host).abs().max()) <= 1e-4 * scale


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def test_fingerprint_of_a_card_tensor(dev):
    from repro_torch.compile.fingerprint import fingerprint_params

    for dtype in (torch.float32, torch.bfloat16):
        t = torch.arange(24, dtype=torch.float32).reshape(4, 6).to(dtype)
        assert (fingerprint_params("lm", {"w": t.to(dev)})
                == fingerprint_params("lm", {"w": t}))


def _blobs():
    from repro_torch.models import synthetic_blobs

    x, y, c = synthetic_blobs(1200, n_features=12, n_classes=3, seed=1)
    return x[:900], y[:900], x[900:], c


def test_train_logistic_on_card_matches_host(dev):
    """The same trainer on the card and on the host: coefficients within
    1e-5 of the largest (tests/test_torch_train.py's tolerance against the
    reference)."""
    from repro_torch.models import train_logistic

    xtr, ytr, _, c = _blobs()
    card = train_logistic(xtr, ytr, c, epochs=15, batch_size=128, seed=3)
    host = train_logistic(xtr, ytr, c, epochs=15, batch_size=128, seed=3,
                          device="cpu")
    for got, want in ((card.coef, host.coef),
                      (card.intercept, host.intercept)):
        assert got.dtype == want.dtype == np.float32
        scale = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= 1e-5 * scale


@pytest.mark.parametrize("number_format", ["fxp16", "auto8"])
def test_trained_archive_on_card_roundtrip(dev, tmp_path, number_format):
    from repro_torch.models import train_mlp

    xtr, ytr, xte, c = _blobs()
    model = train_mlp(xtr, ytr, c, hidden=(16,), epochs=5)
    art = tc.compile(model, tc.Target(number_format=number_format,
                                      backend="cuda"), calibration=xtr[:256])
    path = str(tmp_path / "mlp.embml")
    art.save(path, include_c=True)
    again = tc.load(path)
    assert again.device.type == "cuda" and again.target == art.target
    before = fxp_model.fxp_mlp_model_cuda.launches
    np.testing.assert_array_equal(again.predict(xte), art.predict(xte))
    assert fxp_model.fxp_mlp_model_cuda.launches == before + 2


def test_http_request_on_card(dev):
    import asyncio
    import json

    from repro_torch.serve import InferenceService

    xtr, ytr, xte, c = _blobs()
    svc = InferenceService()
    try:
        ep = svc.register("tree", train_decision_tree(xtr, ytr, c,
                                                      max_depth=6),
                          tc.Target(number_format="fxp16", backend="cuda"))
        want = ep.artifact.predict(xte[:5]).tolist()

        async def go():
            server = svc.serve_http(port=0)
            await server.start()
            try:
                reader, writer = await asyncio.open_connection(
                    server.host, server.port)
                body = json.dumps({"rows": xte[:5].tolist()}).encode()
                writer.write(b"POST /v1/predict/tree HTTP/1.1\r\n"
                             + f"Content-Length: {len(body)}\r\n\r\n".encode()
                             + body)
                await writer.drain()
                head = await reader.readuntil(b"\r\n\r\n")
                length = int(head.lower().split(b"content-length: ")[1]
                             .split(b"\r\n")[0])
                payload = json.loads(await reader.readexactly(length))
                writer.close()
                return head.split()[1], payload
            finally:
                await server.stop()

        before = tree_ensemble.tree_ensemble_cuda.launches
        status, payload = asyncio.run(go())
        assert status == b"200" and payload["predictions"] == want
        assert tree_ensemble.tree_ensemble_cuda.launches > before
    finally:
        svc.close()
