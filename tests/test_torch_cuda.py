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


@pytest.fixture(autouse=True)
def tune_cache(tmp_path, monkeypatch):
    """The block-size tuner's file under the test's own directory: the
    wrappers on the card sweep and persist their blockings."""
    from repro_torch.kernels import tune

    path = str(tmp_path / "tune_cache.json")
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", path)
    tune.clear_memory_cache()
    yield path
    tune.clear_memory_cache()


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
        fa.flash_attention_cuda(*(torch.zeros(1, 8, fa.HEAD_DIMS[-1] + 1,
                                              device=dev)
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


@pytest.mark.parametrize("dtype,atol,row_rtol", [(torch.float32, 2e-5, None),
                                                 (torch.bfloat16, 3e-2, 4e-2)])
def test_flash_attention_window_matches_plain(dev, dtype, atol, row_rtol):
    """A sliding window in the kernel (scores masked where q - k >= window,
    the key tiles before a query tile's window skipped), causal and not:
    windows 1, 63, 64, 65, S - 1, S and S + 1 at ragged and tile-aligned S,
    grouped (G 7, dh 64) and at zamba2's dh 112 (padded to 128), within
    the kernel's bounds of the plain version."""
    from repro_torch.compile.lowerings.common import require_full_float32
    from repro_torch.kernels import flash_attention as fa

    require_full_float32(dev)
    g = torch.Generator(device=dev).manual_seed(2)
    for causal in (True, False):
        for s in (65, 300, 2048):
            for window in (1, 63, 64, 65, s - 1, s, s + 1):
                for dh, bh, group in ((64, 56, 7), (112, 32, 1)):
                    q = torch.randn(bh, s, dh, generator=g, device=dev)
                    k, v = (torch.randn(bh // group, s, dh, generator=g,
                                        device=dev) for _ in range(2))
                    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
                    before = fa.flash_attention_cuda.launches
                    got = ops.flash_attention(q, k, v, causal, window=window)
                    assert fa.flash_attention_cuda.launches == before + 1
                    want = fa.flash_attention_plain(q, k, v, causal,
                                                    window=window)
                    assert bool(torch.isfinite(got).all())
                    diff = (got.float() - want.float()).abs()
                    what = (causal, s, window, dh, group)
                    assert float(diff.max()) <= atol, what
                    if row_rtol is not None:
                        rel = float((diff.amax(-1) / want.float().abs()
                                     .amax(-1).clamp_min(1e-30)).max())
                        assert rel <= row_rtol, what


def _wgmma_case(dev, bh, group, s, causal, window=None):
    """One bf16 dh-128 launch on the warpgroup-MMA design against the
    plain version, at the bf16 bounds (atol 3e-2, each row within 4e-2 of
    its largest value)."""
    from repro_torch.compile.lowerings.common import require_full_float32
    from repro_torch.kernels import flash_attention as fa

    require_full_float32(dev)
    g = torch.Generator(device=dev).manual_seed(s + 7 * (window or 0))
    q = torch.randn(bh, s, 128, generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(bh // group, s, 128, generator=g, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    before = fa.flash_attention_cuda.wgmma_launches
    got = ops.flash_attention(q, k, v, causal, window=window)
    assert fa.flash_attention_cuda.wgmma_launches == before + 1
    want = fa.flash_attention_plain(q, k, v, causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    diff = (got.float() - want.float()).abs()
    what = (bh, group, s, causal, window)
    assert float(diff.max()) <= 3e-2, what
    rel = float((diff.amax(-1) / want.float().abs().amax(-1)
                 .clamp_min(1e-30)).max())
    assert rel <= 4e-2, what


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("bh,group,s", [(32, 4, 127), (32, 4, 128),
                                        (32, 4, 129), (32, 4, 2170),
                                        (32, 4, 8229), (4, 4, 24960)])
def test_flash_attention_wgmma_matches_plain(dev, bh, group, s, causal):
    """LLaVA's heads (32 query heads over 8 KV heads, G 4) at S around the
    128-row tiles, vqa's shortest and a long document; longdoc's longest
    (24960) on one KV head's 4 query heads, where the plain version's
    float32 scores still fit."""
    _wgmma_case(dev, bh, group, s, causal)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("window", [1, 127, 128, 129, 4096])
def test_flash_attention_wgmma_window_matches_plain(dev, window, causal):
    """Windows about the 128-key tiles and zamba2's 4096, grouped (G 4), at
    a ragged S and one past the widest window."""
    for s in (2170, 8229):
        _wgmma_case(dev, 32, 4, s, causal, window)


def test_zamba2_prefill_launches_the_windowed_kernel(dev):
    """A reduced zamba2 forward on the card: one flash_attention launch per
    shared-block call (window 64 at S 192), logits within 1e-4 of the same
    forward through the oracle's attention, and of the host's."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.lm import model as M

    cfg = get_config("zamba2-7b").reduced()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    tok = torch.from_numpy(np.random.RandomState(0).randint(
        1, cfg.vocab_size, (2, 192)).astype(np.int32)).to(dev)
    n_groups = cfg.n_layers // cfg.ssm.shared_attn_every
    before = fa.flash_attention_cuda.launches
    logits = M.forward(params, {"tokens": tok}, cfg)
    assert fa.flash_attention_cuda.launches == before + n_groups
    plain = M.forward(params, {"tokens": tok}, cfg, attn_impl="ref")
    assert fa.flash_attention_cuda.launches == before + n_groups
    scale = float(plain.abs().max())
    assert float((logits - plain).abs().max()) <= 1e-4 * scale
    host = M.forward(_to_cpu(params), {"tokens": tok.cpu()}, cfg)
    assert float((logits.cpu() - host).abs().max()) <= 1e-4 * scale


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


@pytest.mark.parametrize("s", [1, 255, 256, 4095, 4096])
def test_flash_attention_dh224_matches_plain(dev, s):
    """The dh-224 instance (Zamba2's shared block: 32 heads, causal, the
    published scale (224 / 2)^-1/2) against the plain version at the bf16
    bounds (atol 3e-2, each row within 4e-2 of its largest value), S about
    the 48-key tiles and the 128-row query tiles up to the context's 4096;
    one launch, counted as wgmma and dh-224."""
    from repro_torch.compile.lowerings.common import require_full_float32
    from repro_torch.kernels import flash_attention as fa

    require_full_float32(dev)
    g = torch.Generator(device=dev).manual_seed(s)
    q, k, v = (torch.randn(32, s, 224, generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    scale = (224 / 2) ** -0.5
    counts = (fa.flash_attention_cuda.launches,
              fa.flash_attention_cuda.wgmma_launches,
              fa.flash_attention_cuda.dh224_launches)
    got = ops.flash_attention(q, k, v, True, scale=scale)
    assert (fa.flash_attention_cuda.launches,
            fa.flash_attention_cuda.wgmma_launches,
            fa.flash_attention_cuda.dh224_launches) == tuple(
                c + 1 for c in counts)
    want = fa.flash_attention_plain(q, k, v, True, scale)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    diff = (got.float() - want.float()).abs()
    assert float(diff.max()) <= 3e-2
    rel = float((diff.amax(-1) / want.float().abs().amax(-1)
                 .clamp_min(1e-30)).max())
    assert rel <= 4e-2
    # the scale is the caller's: the default 1/sqrt(224) gives another answer
    other = ops.flash_attention(q, k, v, True)
    assert float((other.float() - want.float()).abs().max()) > 3e-2 or s == 1


def _zamba2_published(dev, layers):
    """The published Zamba2-7B's configuration file cut to its first
    ``layers`` Mamba2 layers (the hybrid calls among them kept), the
    port's configuration for it and weights drawn as the benchmark draws
    them, in bf16 on the card."""
    import json
    from pathlib import Path

    from bench.programs import hybrid as prog

    cfg = json.loads((Path(__file__).resolve().parents[1] / "bench"
                      / "configs" / "zamba2-7b.json").read_text())
    cfg["num_hidden_layers"] = layers
    cfg["layers_block_type"] = cfg["layers_block_type"][:layers]
    cfg["hybrid_layer_ids"] = [i for i in cfg["hybrid_layer_ids"]
                               if i < layers]
    a = prog.arch(cfg)
    g = torch.Generator(device=dev).manual_seed(layers)
    return cfg, a, prog.draw_params(a, g, dev), g


def test_zamba2_published_route_prefill_and_decode(dev):
    """Zamba2-7B at its published widths cut to layers 0-11 (hybrid calls
    at 6 and 11: both shared blocks), bf16, on a ragged 1000-token prompt:
    ``prefill`` (the forward, filling the decode cache) and 8
    ``serve_step`` decode steps against the plain float32 reference's full
    forward over the 1008 tokens (``bench/reference/hybrid.py``), each row's
    ``|p - r| / |r|`` within 0.05 (bf16 weights and activations over 12
    layers read 0.030-0.037 on an H100); one flash_attention launch a
    call, on the dh-224 instance."""
    from bench.reference import hybrid as ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.lm import model as M

    cfg, a, params, g = _zamba2_published(dev, 12)
    tok = torch.randint(0, a.vocab_size, (1008,), generator=g, device=dev)
    before = fa.flash_attention_cuda.dh224_launches
    logits, cache = M.prefill(params, {"tokens": tok[None, :1000]}, a, 1008)
    assert fa.flash_attention_cuda.dh224_launches == before + 2
    dec = []
    for i in range(1000, 1008):
        step, cache = M.serve_step(params, cache, {"token": tok[None, i]}, a)
        dec.append(step[0])
    rows = torch.cat([torch.arange(0, 1000, 37, device=dev),
                      torch.arange(992, 1008, device=dev)])
    want = ref.forward_rows(cfg, params, tok, None, rows)
    got = torch.cat([logits[0, rows[rows < 1000]], torch.stack(dec)])
    err = (got - want).norm(dim=-1) / want.norm(dim=-1)
    print("zamba2 12-layer logit_err: prefill", float(err[:-8].max()),
          "decode", float(err[-8:].max()))
    assert float(err.max()) <= 0.05, err


def test_zamba2_published_forward_launches_13_calls(dev):
    """The whole published model (81 Mamba2 layers, 13 shared-block
    calls) through ``lm.model.forward`` with its default route: one
    flash_attention launch a call, each on the dh-224 instance; ragged
    (1000 positions: the last 256-position SSD chunk partial)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.lm import mamba2
    from repro_torch.lm import model as M

    _, a, params, g = _zamba2_published(dev, 81)
    tok = torch.randint(0, a.vocab_size, (1, 1000), generator=g, device=dev)
    counts = (fa.flash_attention_cuda.launches,
              fa.flash_attention_cuda.dh224_launches,
              mamba2.ssd_scan.padded_positions)
    logits = M.forward(params, {"tokens": tok}, a)
    assert (fa.flash_attention_cuda.launches,
            fa.flash_attention_cuda.dh224_launches,
            mamba2.ssd_scan.padded_positions) == (
                counts[0] + 13, counts[1] + 13, counts[2] + 81 * 24)
    assert logits.shape == (1, 1000, 32000)
    assert bool(torch.isfinite(logits).all())


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


def test_checkpoint_restores_onto_the_card(dev, tmp_path):
    """A host-written train state restores onto the card, bit for bit,
    with the structure (OptState, None) of ``like``."""
    from repro_torch.train import optim
    from repro_torch.train.checkpoint import restore_pytree, save_pytree

    g = torch.Generator("cpu").manual_seed(0)
    params = {"w": torch.randn(64, 32, generator=g).to(torch.bfloat16),
              "b": torch.randn(32, generator=g)}
    opt = optim.adamw(1e-3)
    state = {"params": params, "opt": opt.init(params)}
    p = str(tmp_path / "s.ckpt")
    save_pytree(p, state)
    like = {"params": {k: v.to(dev) for k, v in params.items()},
            "opt": opt.init({k: v.to(dev) for k, v in params.items()})}
    got, _ = restore_pytree(p, like=like)
    assert got["params"]["w"].device.type == "cuda"
    assert got["opt"].step.device.type == "cuda"
    assert torch.equal(got["params"]["w"].cpu().view(torch.int16),
                       params["w"].view(torch.int16))
    assert torch.equal(got["params"]["b"].cpu(), params["b"])
    sgd_state = optim.sgd(1e-2).init(like["params"])
    save_pytree(p, {"params": params, "opt": sgd_state})
    back, _ = restore_pytree(p, like={"params": like["params"],
                                      "opt": sgd_state})
    assert back["opt"].nu is None and back["opt"].mu is None


@pytest.mark.parametrize("wrapper", ["flash_attention", "pwl_activation"])
def test_kernel_wrappers_raise_under_grad(dev, wrapper):
    """Neither float kernel has a backward: on the card an input that
    requires grad raises instead of returning a cut gradient, and the
    launch counter does not move; under no_grad it launches."""
    from repro_torch.kernels import flash_attention, pwl_activation

    x = torch.randn(4, 64, 64, device=dev, requires_grad=True)
    if wrapper == "flash_attention":
        launcher = flash_attention.flash_attention_cuda
        call = lambda: ops.flash_attention(x, x, x, True)
    else:
        launcher = pwl_activation.pwl_activation_cuda
        call = lambda: ops.pwl_activation(x, "silu_pwl4")
    before = launcher.launches
    with pytest.raises(RuntimeError, match="no backward"):
        call()
    assert launcher.launches == before
    with torch.no_grad():
        out = call()
    assert launcher.launches == before + 1 and not out.requires_grad


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 3e-2)])
def test_mla_attention_launches_the_dh192_instance(dev, dtype, atol):
    """MLA's prefill on the card: one flash_attention launch on the dh-192
    instance (q/k 128 + 64, v zero-padded to 192 and sliced back), within
    the kernel's bounds of the materialized-scores oracle route."""
    from repro_torch.compile.lowerings.common import require_full_float32
    from repro_torch.configs.base import MLAConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.lm import mla

    require_full_float32(dev)
    m = MLAConfig(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128)
    g = torch.Generator(device=dev).manual_seed(0)
    p = mla.mla_params(g, 64, 4, m, dtype)
    x = torch.randn(2, 77, 64, generator=g, device=dev).to(dtype)
    before = fa.flash_attention_cuda.launches
    got = mla.mla_attention(p, x, n_heads=4, m=m, rope_theta=1e4)
    assert fa.flash_attention_cuda.launches == before + 1
    want = mla.mla_attention(p, x, n_heads=4, m=m, rope_theta=1e4,
                             impl="ref")
    assert fa.flash_attention_cuda.launches == before + 1
    scale = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= atol * max(
        scale, 1.0)


def test_moe_routing_tables_on_the_card_equal_the_host(dev):
    """The top-k selection and the dispatch on the card, from the same
    float32 scores, equal the host's bit for bit, with experts that
    overflow (the tables are built from unique indices only)."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.lm import moe

    cfg = MoEConfig(n_experts=64, top_k=6, d_ff_expert=8, n_shared=1,
                    router_aux_free=True, capacity_factor=1.0)
    g = torch.Generator(device=dev).manual_seed(1)
    p = moe.moe_params(g, 32, cfg, "glu", torch.float32)
    p["router"]["bias"] = torch.randn(64, generator=g, device=dev) * 0.1
    s = moe.scores(p, torch.randn(4096, 32, generator=g, device=dev), cfg)
    cap = moe.capacity(4096, cfg)
    host = {k: v.cpu() for k, v in p["router"].items()}
    w_d, e_d = moe.select(p, s, cfg)
    w_h, e_h = moe.select({"router": host}, s.cpu(), cfg)
    assert torch.equal(e_d.cpu(), e_h) and torch.equal(w_d.cpu(), w_h)
    tables_d = moe.dispatch(w_d, e_d, 64, cap)
    tables_h = moe.dispatch(w_h, e_h, 64, cap)
    for d, h in zip(tables_d, tables_h):
        assert torch.equal(d.cpu(), h)
    assert int(torch.bincount(e_h.reshape(-1), minlength=64).max()) > cap


def test_spmd_mesh_over_every_card_matches_single_device(dev, monkeypatch):
    """spmd over make_serving_mesh() (every visible card): labels and stats
    bit for bit the single-device artifact's, one launch per replica a
    predict, each replica's launch on its own card."""
    from repro_torch.sharding import make_serving_mesh

    n_cards = torch.cuda.device_count()
    seen = []

    def spy(name):
        launcher = getattr(ops, name)

        def run(x, *args, **kw):
            seen.append(x.device)
            return launcher(x, *args, **kw)

        monkeypatch.setattr(ops, name, run)

    for name in ("fxp_mlp_model_cuda", "fxp_layer_cuda"):
        spy(name)
    rng = np.random.RandomState(6)
    x = (rng.randn(3089, 561) * 2).astype(np.float32)
    mesh = make_serving_mesh()
    models = (init_mlp([561, 64, 6], seed=0),
              LogisticModel((rng.randn(561, 6) * 0.1).astype(np.float32),
                            np.zeros(6, np.float32)))
    for model in models:
        for number_format in ("fxp16", "auto8"):
            art = tc.compile(model, tc.Target(number_format=number_format,
                                              backend="cuda"),
                             calibration=x[:64])
            sharded = art.specialize_mesh(mesh)
            assert sharded.mesh_strategy == "spmd"
            assert sharded.replicas == n_cards
            sharded.predict(x[:3])  # the pad-row probe runs once
            for rows in (1, 3, 64, 3089):
                want = art.predict_with_stats(x[:rows])
                seen.clear()
                got = sharded.predict_with_stats(x[:rows])
                np.testing.assert_array_equal(got[0], want[0])
                assert got[1] == want[1], (rows, got[1], want[1])
                assert seen == [torch.device("cuda", i)
                                for i in range(n_cards)], seen


def test_fused_host_mesh_over_cuda_artifact_survives_replica_fault(dev):
    """fused over make_host_mesh(4) with a CUDA artifact: one launch a call
    while untracked; replica 0 faulting past evict_after, then succeeding,
    leaves every label bit for bit, with an eviction, a probe and a
    re-admission."""
    from repro_torch.serve import FaultPlan, FaultRule, faults
    from repro_torch.sharding import make_host_mesh

    rng = np.random.RandomState(7)
    x = (rng.randn(64, 561) * 2).astype(np.float32)
    art = tc.compile(init_mlp([561, 64, 6], seed=0),
                     tc.Target(number_format="fxp16", backend="cuda"))
    sharded = art.specialize_mesh(make_host_mesh(4))
    assert sharded.mesh_strategy == "fused" and sharded.device == art.device
    golden = art.predict(x)
    before = fxp_model.fxp_mlp_model_cuda.launches
    np.testing.assert_array_equal(sharded.predict(x), golden)
    assert fxp_model.fxp_mlp_model_cuda.launches == before + 1
    plan = FaultPlan([FaultRule(site="mesh.replica", match="0",
                                transient=True, count=3)])
    with faults.inject(plan):
        for _ in range(12):
            before = fxp_model.fxp_mlp_model_cuda.launches
            np.testing.assert_array_equal(sharded.predict(x), golden)
            assert fxp_model.fxp_mlp_model_cuda.launches == before + 4
    snap = sharded.replica_health.snapshot()
    assert snap["evictions"] >= 1 and snap["probes"] >= 1
    assert snap["readmissions"] >= 1 and snap["healthy"] == [0, 1, 2, 3]


def _mesh_cfg():
    """``tests/test_elastic.py``'s reduced qwen2 (float32)."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(
        get_config("qwen2-0.5b").reduced(), n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab_size=256,
        remat=False, dtype="float32")


def _card_mesh_of_one():
    from repro_torch.sharding import Mesh

    return Mesh(np.array([[torch.device("cuda", 0)]], dtype=object),
                ("data", "model"))


def test_world_of_one_nccl_train_step_equals_single_device(dev):
    """A train step under a ('data' 1, 'model' 1) NCCL mesh, in this
    process, equals the single-device step from the same weights."""
    from repro_torch import sharding as S
    from repro_torch.launch.mesh import run_on_mesh
    from repro_torch.lm import model as M
    from repro_torch.train import trainer as TT

    cfg, mesh = _mesh_cfg(), _card_mesh_of_one()
    tcfg = TT.TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    init = M.init_params(cfg, torch.Generator(dev).manual_seed(0))
    batch = next(TT.synthetic_token_stream(cfg, 8, 32, 0, device=dev))
    want = TT.make_train_step(cfg, tcfg)(
        init, TT.make_optimizer(tcfg).init(init), batch)

    def sharded():
        rules = S.Rules(mesh)
        placed = S.device_put_tree(init, M.param_specs(cfg, rules), mesh)
        params, _, m = TT.make_train_step(cfg, tcfg, rules=rules)(
            placed, TT.make_optimizer(tcfg).init(placed), batch)
        return ({k: float(v) for k, v in m.items()},
                {k: v.full_tensor() for k, v in params["layers"]["attn"][
                    "wq"].items()})

    (metrics, wq), = run_on_mesh(sharded, mesh)
    for k in ("loss", "grad_norm"):
        assert abs(metrics[k] - float(want[2][k])) <= 1e-5 * abs(
            float(want[2][k])), k
    torch.testing.assert_close(wq["w"], want[0]["layers"]["attn"]["wq"]["w"],
                               rtol=0, atol=1e-6)


def test_local_map_flash_attention_equals_the_unsharded_kernel(dev):
    """Under rules the prefill's attention runs flash_attention on each
    rank's local heads through local_map: one launch a layer, the logits
    equal to the unsharded kernel route's."""
    from repro_torch import sharding as S
    from repro_torch.kernels import flash_attention
    from repro_torch.launch.mesh import run_on_mesh
    from repro_torch.lm import model as M

    cfg, mesh = _mesh_cfg(), _card_mesh_of_one()
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0))
    tok = torch.randint(0, 256, (4, 96), device=dev,
                        generator=torch.Generator(dev).manual_seed(1))
    want = M.forward(params, {"tokens": tok}, cfg)

    def sharded():
        rules = S.Rules(mesh)
        placed = S.device_put_tree(params, M.param_specs(cfg, rules), mesh)
        before = flash_attention.flash_attention_cuda.launches
        out = M.forward(placed, {"tokens": tok}, cfg, "cuda", rules)
        return (out.full_tensor(),
                flash_attention.flash_attention_cuda.launches - before)

    (got, launches), = run_on_mesh(sharded, mesh)
    assert launches == cfg.n_layers
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def _moe_mesh_cfg(expert_sharding):
    """A MoE layer at widths of 512: 4 experts (8 for ep2d), top 2, the
    pwl4 gate."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config("deepseek-v3-671b").reduced()
    return dataclasses.replace(cfg.moe, n_experts=8 if expert_sharding ==
                               "ep2d" else 4, top_k=2, d_ff_expert=512,
                               n_shared=1, expert_sharding=expert_sharding)


@pytest.mark.parametrize("expert_sharding", ["ep", "ep2d", "tp"])
def test_moe_layer_on_a_card_mesh_of_one_equals_single_device(
        dev, expert_sharding):
    """``apply_moe(rules=)`` under a ('data' 1, 'model' 1) NCCL mesh equals
    the single-device layer bit for bit, its routing tables too, with one
    pwl_activation launch per expert stack (and one for the shared expert)
    at the pwl4 gate."""
    from repro_torch import sharding as S
    from repro_torch.kernels import pwl_activation
    from repro_torch.launch.mesh import run_on_mesh
    from repro_torch.lm import moe as moe_mod

    mo, mesh = _moe_mesh_cfg(expert_sharding), _card_mesh_of_one()
    gen = torch.Generator(dev).manual_seed(0)
    p = moe_mod.moe_params(gen, 512, mo, "glu", torch.float32)
    x = torch.randn(8, 64, 512, device=dev, generator=gen)
    want = moe_mod.apply_moe(p, x, mo, "glu", "silu", gate_sigmoid="pwl4")
    cap = moe_mod.capacity(8 * 64, mo)
    tables = moe_mod.dispatch(*moe_mod.route(p, x.reshape(-1, 512), mo),
                              mo.n_experts, cap)

    def sharded():
        rules = S.Rules(mesh)
        placed = S.device_put_tree(p, _specs(p), mesh)
        xd = S.device_put(x, rules.sharding(("batch", None, None), x.shape))
        before = pwl_activation.pwl_activation_cuda.launches
        out = moe_mod.apply_moe(placed, xd, mo, "glu", "silu",
                                gate_sigmoid="pwl4", rules=rules)
        launches = pwl_activation.pwl_activation_cuda.launches - before
        _, *got = moe_mod.routing_on_mesh(placed, xd.reshape(-1, 512), mo,
                                          cap)
        return out.full_tensor(), launches, [t.to_local() for t in got]

    (got, launches, got_tables), = run_on_mesh(sharded, mesh)
    assert launches == 2  # the expert stack and the shared expert
    assert torch.equal(got, want)
    for a, b in zip(got_tables, tables):
        assert torch.equal(a, b)


def _specs(tree):
    """Every leaf of a dict tree replicated (a mesh of one)."""
    return {k: _specs(v) if isinstance(v, dict) else (None,) * v.dim()
            for k, v in tree.items()}


def test_mla_on_a_card_mesh_launches_the_dh192_instance_once_a_layer(dev):
    """deepseek-v3's MLA attention at its published head widths (q/k 192,
    v 128) under a (1, 1) NCCL mesh: one flash_attention launch a layer at
    dh 192 on the rank's local heads, the logits equal to the single
    device's kernel route."""
    import dataclasses

    from repro_torch import sharding as S
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MLAConfig
    from repro_torch.kernels import flash_attention
    from repro_torch.launch.mesh import run_on_mesh
    from repro_torch.lm import model as M

    cfg = dataclasses.replace(
        get_config("deepseek-v3-671b").reduced(), n_layers=2, d_model=512,
        n_heads=8, vocab_size=512, d_ff=1024, dtype="bfloat16",
        mla=MLAConfig(q_lora_rank=256, kv_lora_rank=128,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, d_ff_dense=1024))
    mesh = _card_mesh_of_one()
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0))
    tok = torch.randint(0, 512, (2, 256), device=dev,
                        generator=torch.Generator(dev).manual_seed(1))
    want = M.forward(params, {"tokens": tok}, cfg)
    seen = []
    real = flash_attention.flash_attention_cuda

    def sharded():
        rules = S.Rules(mesh)
        placed = S.device_put_tree(params, M.param_specs(cfg, rules), mesh)
        before = real.launches
        out = M.forward(placed, {"tokens": tok}, cfg, "cuda", rules)
        return out.full_tensor(), real.launches - before

    def spy(q, k, v, causal=True, window=None):
        seen.append(q.shape[-1])
        return real(q, k, v, causal, window)

    ops.flash_attention_cuda = spy
    try:
        (got, launches), = run_on_mesh(sharded, mesh)
    finally:
        ops.flash_attention_cuda = real
    assert launches == cfg.n_layers and seen == [192] * cfg.n_layers
    assert torch.equal(got, want)


def _drop_lead(specs, n):
    """A stacked layer's specs without its ``n`` leading dims."""
    if isinstance(specs, dict):
        return {k: _drop_lead(v, n) for k, v in specs.items()}
    return specs[n:]


def _recurrent_layer(arch, dev):
    """(config, one layer's parameters, its specs under a mesh of one, the
    layer's forward and decode) of zamba2's Mamba2 or RWKV-6 at widths of
    512, bf16, the pwl4 gate."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.lm import mamba2, rwkv6
    from repro_torch.lm import model as M
    from repro_torch.sharding import Rules

    cfg = dataclasses.replace(get_config(arch).reduced(), d_model=512,
                              n_heads=8, n_kv_heads=2, d_head=64,
                              dtype="bfloat16", gate_sigmoid="pwl4")
    gen = torch.Generator(dev).manual_seed(0)
    specs = M.param_specs(cfg, Rules(_card_mesh_of_one()))
    if arch == "rwkv6-1.6b":
        p = rwkv6.rwkv6_params(gen, 512, cfg.d_ff, 8, torch.bfloat16)
        M.cast_params_({"layers": p}, torch.bfloat16)  # float32 leaves stay

        def fwd(p, x, rules=None):
            return rwkv6.rwkv6_forward(p, x, 8, "pwl4", rules=rules)

        def dec(p, x, cache, rules=None):
            return rwkv6.rwkv6_decode(p, x, cache, 8, "pwl4", rules)

        def cache(b):
            return rwkv6.init_rwkv_cache(b, 512, 8, torch.bfloat16, dev)
        return cfg, p, _drop_lead(specs["layers"], 1), fwd, dec, cache
    p = mamba2.mamba2_params(gen, 512, cfg.ssm, torch.bfloat16)

    def fwd(p, x, rules=None):
        return mamba2.mamba2_forward(p, x, 512, cfg.ssm, "pwl4", rules=rules)

    def dec(p, x, cache, rules=None):
        return mamba2.mamba2_decode(p, x, cache, 512, cfg.ssm, "pwl4", rules)

    def cache(b):
        return mamba2.init_mamba_cache(b, 512, cfg.ssm, torch.bfloat16, dev)
    return cfg, p, _drop_lead(specs["groups"]["mamba"], 2), fwd, dec, cache


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-1.6b"])
def test_recurrent_layer_on_a_card_mesh_of_one_equals_single_device(dev,
                                                                    arch):
    """One Mamba2 layer (zamba2's SSM: 32 heads in 2 groups) or RWKV-6
    layer (8 heads) at widths of 512 in bf16 under a ('data' 1, 'model' 1)
    NCCL mesh: the forward (4 x 64) and three decode steps equal the single
    device's bit for bit, the decode state too, with two pwl_activation
    launches (the layer's two gates) a forward and a step."""
    from repro_torch import sharding as S
    from repro_torch.kernels import pwl_activation
    from repro_torch.launch.mesh import run_on_mesh

    cfg, p, specs, fwd, dec, new_cache = _recurrent_layer(arch, dev)
    mesh = _card_mesh_of_one()
    gen = torch.Generator(dev).manual_seed(1)
    x = torch.randn(4, 64, 512, device=dev, generator=gen).bfloat16()
    steps = torch.randn(3, 4, 1, 512, device=dev,
                        generator=gen).bfloat16()
    want = fwd(p, x)
    cache = new_cache(4)
    want_dec = [dec(p, t, cache)[0] for t in steps]
    launches = pwl_activation.pwl_activation_cuda

    def sharded():
        rules = S.Rules(mesh)
        placed = S.device_put_tree(p, specs, mesh)

        def put(t, axes):
            return S.device_put(t, rules.sharding(axes, t.shape))

        before = launches.launches
        out = fwd(placed, put(x, ("batch", None, None)), rules)
        n_fwd = launches.launches - before
        c = {k: put(v, ("batch",) + (None,) * (v.dim() - 1))
             for k, v in new_cache(4).items()}
        before = launches.launches
        got = [dec(placed, put(t, ("batch", None, None)), c, rules)[0]
               .full_tensor() for t in steps]
        return (out.full_tensor(), n_fwd, got, launches.launches - before,
                {k: v.full_tensor() for k, v in c.items()})

    (got, n_fwd, got_dec, n_dec, got_cache), = run_on_mesh(sharded, mesh)
    assert n_fwd == 2 and n_dec == 2 * len(steps)
    assert torch.equal(got, want)
    for a, b in zip(got_dec, want_dec):
        assert torch.equal(a, b)
    for k, v in cache.items():
        assert torch.equal(got_cache[k], v), k


def test_zamba2_shared_block_on_a_card_mesh_launches_the_window_once(dev):
    """zamba2's shared attention block (8 heads over 2 KV heads, window
    64) at S 192 under a (1, 1) NCCL mesh: one windowed flash_attention
    launch on the rank's local heads, the block's output equal to the
    single device's."""
    import dataclasses

    from repro_torch import sharding as S
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention
    from repro_torch.launch.mesh import run_on_mesh
    from repro_torch.lm import model as M

    cfg = dataclasses.replace(get_config("zamba2-7b").reduced(), d_model=512,
                              n_heads=8, n_kv_heads=2, d_head=64,
                              dtype="bfloat16")
    mesh = _card_mesh_of_one()
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0))
    block = params["shared_attn"]
    x = torch.randn(2, 192, 512, device=dev,
                    generator=torch.Generator(dev).manual_seed(1)).bfloat16()
    want = M._dense_block(cfg, block, x, "cuda")
    real = flash_attention.flash_attention_cuda
    seen = []

    def spy(q, k, v, causal=True, window=None):
        seen.append((tuple(q.shape), tuple(k.shape), window))
        return real(q, k, v, causal, window)

    def sharded():
        rules = S.Rules(mesh)
        specs = M.param_specs(cfg, rules)["shared_attn"]
        placed = S.device_put_tree(block, specs, mesh)
        xd = S.device_put(x, rules.sharding(("batch", None, None), x.shape))
        return M._dense_block(cfg, placed, xd, "cuda", rules).full_tensor()

    ops.flash_attention_cuda = spy
    try:
        got, = run_on_mesh(sharded, mesh)
    finally:
        ops.flash_attention_cuda = real
    assert seen == [((2 * 8, 192, 64), (2 * 2, 192, 64), 64)]
    assert torch.equal(got, want)


# --------------------------------------------------------------------------
# the block-size tuner's instances
# --------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [8, 16, 32])
def test_every_tuned_instance_matches_plain(dev, bits):
    """Each compiled blocking of each tuned kernel, bit for bit against the
    plain version, at ragged and bucket-edge batches."""
    from repro_torch.kernels import tune

    rng = np.random.RandomState(bits)
    fmt = FxpFormat(bits, bits - 6)
    for m in (1, 31, 33, 64, 65, 127, 129, 3089):
        a = _ints(rng, (m, 561), bits, True).to(dev)
        b = _ints(rng, (561, 70), bits, True).to(dev)
        bias = _ints(rng, (70,), bits, True).to(dev)
        want_q = fxp_qmatmul.fxp_qmatmul_plain(a, b, fmt)
        want_l = fxp_layer.fxp_layer_plain(a, b, bias, fmt, "pwl4", 7)
        for blk in tune.candidates("qmatmul", m, 561, 70, bits):
            assert torch.equal(ops.fxp_qmatmul(a, b, fmt, blocks=blk),
                               want_q), (m, blk)
            assert torch.equal(ops.fxp_layer(a, b, bias, fmt, "pwl4", 7,
                                             blocks=blk), want_l), (m, blk)
        b6, bias6 = b[:, :6].contiguous(), bias[:6].contiguous()
        occ = fxp_layer.narrow_occupancy(561, 6, bits, dev)
        want = fxp_layer.fxp_layer_plain(a, b6, bias6, fmt, "none", 7)
        for blk in tune.candidates("layer", m, 561, 6, bits, occ) + [
                (4, 1, 128), (4, 7, 128)]:
            assert torch.equal(ops.fxp_layer(a, b6, bias6, fmt, "none", 7,
                                             blocks=blk), want), (m, blk)
        ws = [_ints(rng, s, bits, False).to(dev) for s in ((561, 64), (64, 6))]
        bs = [_ints(rng, (n,), bits, True).to(dev) for n in (64, 6)]
        sched = ((7, fmt, "exact"), (3, fmt, "none"))
        x = a // 64
        want = fxp_model.fxp_mlp_model_plain(x, ws, bs, sched)
        for bm in tune.model_candidates("mlp", (561, 64, 6), bits):
            assert torch.equal(ops.fxp_mlp_model(x, ws, bs, sched, bm=bm),
                               want), (m, bm)
        xe = torch.stack([x, x.flip(0)])
        wse = [torch.stack([w, w.flip(0)]) for w in ws]
        bse = [torch.stack([v, v]) for v in bs]
        want = fxp_model.fxp_mlp_fleet_plain(xe, wse, bse, (sched, sched))
        for bm in tune.model_candidates("mlp", (561, 64, 6), bits):
            assert torch.equal(ops.fxp_mlp_fleet(xe, wse, bse,
                                                 (sched, sched), bm=bm),
                               want), (m, bm)
        sv = _ints(rng, (300, 561), bits, False).to(dev)
        dual = _ints(rng, (300, 6), bits, False).to(dev)
        args = (a // 64, sv, dual, bias6, "rbf", fmt, fmt, 3, 1, 2, 7)
        want = fxp_model.fxp_svm_model_plain(*args)
        for bm in tune.MODEL_BMS:
            assert torch.equal(ops.fxp_svm_model(*args, bm=bm), want), (m, bm)
        p = ((fmt, fmt, 3, 1, 2, 7), (fmt, fmt, 5, 0, 3, 6))
        qe, sve = torch.stack([args[0]] * 2), torch.stack([sv, sv.flip(0)])
        de, ie = torch.stack([dual] * 2), torch.stack([bias6] * 2)
        want = fxp_model.fxp_svm_fleet_plain(qe, sve, de, ie, "poly", p)
        for bm in tune.MODEL_BMS:
            assert torch.equal(ops.fxp_svm_fleet(qe, sve, de, ie, "poly", p,
                                                 bm=bm), want), (m, bm)
    with pytest.raises(ValueError, match="no compiled"):
        ops.fxp_qmatmul(a, b, fmt, blocks=(16, 64, 128 * 8 // bits))
    with pytest.raises(ValueError, match="be = 1"):
        ops.fxp_svm_fleet(qe, sve, de, ie, "poly", p, be=2)


def test_a_sweep_counts_only_in_sweep_launches(dev, tune_cache):
    from repro_torch.kernels import tune

    rng = np.random.RandomState(0)
    fmt = FxpFormat(16, 10)
    a = _ints(rng, (3089, 561), 16, False).to(dev)
    b = _ints(rng, (561, 300), 16, False).to(dev)
    launches = fxp_qmatmul.fxp_qmatmul_cuda.launches
    sweeps = tune.sweep_launches
    with ops.count_dispatches() as c:
        got = ops.fxp_qmatmul(a, b, fmt)
    assert c.count == 1
    assert fxp_qmatmul.fxp_qmatmul_cuda.launches == launches + 1
    n_cands = len(tune.candidates("qmatmul", 3089, 561, 300, 16))
    assert tune.sweep_launches == sweeps + 4 * n_cands
    assert torch.equal(got, fxp_qmatmul.fxp_qmatmul_plain(a, b, fmt))
    blk = tune.cache_snapshot()[
        f"qmatmul|4096x561x300|w16|{tune.device_key(dev)}"]
    assert blk in tune.candidates("qmatmul", 3089, 561, 300, 16)
    sweeps = tune.sweep_launches
    ops.fxp_qmatmul(a[:2100], b, fmt)  # the same bucket: a dict hit
    assert tune.sweep_launches == sweeps
    tune.clear_memory_cache()
    ops.fxp_qmatmul(a[:2049], b, fmt)  # from the file
    assert tune.sweep_launches == sweeps
    with open(tune_cache) as f:
        assert len(__import__("json").load(f)) == 1


def test_pretune_leaves_no_sweep_for_live_requests(dev, tune_cache):
    from repro_torch.kernels import tune

    rng = np.random.RandomState(0)
    x = (rng.randn(300, 561) * 2).astype(np.float32)
    mlp = init_mlp([561, 64, 6], seed=0)
    logistic = LogisticModel((rng.randn(561, 6) * 0.1).astype(np.float32),
                             np.zeros(6, np.float32))
    ladder = (1, 2, 4, 8, 16, 32, 64)
    for model, kind in ((mlp, "model-mlp"), (logistic, "layer")):
        art = tc.compile(model, tc.Target(backend="cuda",
                                          number_format="fxp16"))
        before = set(tune.cache_snapshot())
        art.pretune(x[:1], batches=ladder)
        keys = set(tune.cache_snapshot()) - before
        assert len(keys) == len(ladder), keys
        assert all(k.startswith(kind + "|") for k in keys)
        sweeps = tune.sweep_launches
        for m in (1, 3, 7, 13, 33, 64):
            host = tc.compile(model, tc.Target(backend="cuda",
                                               number_format="fxp16"),
                              device="cpu").predict(x[:m])
            assert (art.predict(x[:m]) == host).all()
        assert tune.sweep_launches == sweeps
