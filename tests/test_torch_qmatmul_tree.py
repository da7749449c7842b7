"""The int8 tensor-core tile of ``fxp_qmatmul`` and ``fxp_layer``'s wide
route, and the ``tree_ensemble`` kernel on integer containers, on the host.

* A numpy model of the tile's data path (``csrc/fxp_tile.cuh``): each value
  split into byte planes (the top plane signed), the B planes' rows stored
  in ``tile_b_row`` order, the fragments as ``ldmatrix`` and
  ``ldmatrix.trans`` hand them to each lane, the PRMTs that split the B
  byte pairs into even and odd columns, ``mma.sync.m16n8k32`` on the
  pairs of planes with i + j <= 3 (one MMA a product at 8 bits, four at 16,
  ten at 32) into one s32 accumulator a shift, wrapping, and the uint32
  recombination, with K and N zero-padded to the stage and the tile (what A
  holds past K is garbage, as on the card).  Held at wrapping sums against
  the exact dot mod 2^32, ``fxp_qmatmul_plain`` and JAX's
  ``fxp_qmatmul_pallas(..., interpret=True)`` on shapes padded to its
  blocks.
* The tile's shared-memory layout, compiled for the host: two blocks an SM.
* ``tree_ensemble_plain`` on int8, int16 and int32 containers against
  ``tree_ensemble_pallas(..., interpret=True)`` on the same integers (it
  casts inside), int32 values in [2^24, 2^31) included; the packed node
  table; quantized tree artifacts on a CPU device against the reference's
  ``ref`` artifact, their kernel wrapper handed the container itself.
* The routing counts, pinned: ``svm_fits_smem`` at 1696 and 1697 support
  vectors, ``mlp_fits_smem`` at its edges, the tree's table route.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables jax x64, as the reference runs)
from repro import compile as jcompile
from repro import models as jmodels
from repro.core import fixedpoint as jfx
from repro.core import trees as jtrees
from repro.kernels.fxp_qmatmul import fxp_qmatmul_pallas
from repro.kernels.tree_ensemble import pack_tree, tree_ensemble_pallas
from repro_torch import compile as tcompile
from repro_torch.convert import model_from_params
from repro_torch.core import fixedpoint as tfx
from repro_torch.core import trees as ttrees
from repro_torch.kernels import fxp_model, fxp_qmatmul, ops, tree_ensemble

from _torch_port_cases import QUANT_TAGS
from test_torch_epilogue import _host_build

NP = {8: np.int8, 16: np.int16, 32: np.int32}
# csrc/fxp_tile.cuh
TILE_BM, TILE_BN, ROW_BYTES = 64, 64, 128

LANE = np.arange(32)
G, T = LANE >> 2, LANE & 3


def _ints(rng, shape, bits, regime):
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    if regime == "edge":
        return rng.choice([lo, hi, 0, -1], size=shape).astype(NP[bits])
    mag = {"mid": {8: 3, 16: 7, 32: 12}[bits], "full": bits - 1}[regime]
    v = rng.randint(-(2 ** mag), 2 ** mag, size=shape, dtype=np.int64)
    return np.clip(v, lo, hi).astype(NP[bits])


def _planes(v, p):
    """The p byte planes of p-byte values as int64: plane 0 the low byte,
    plane p - 1 the high byte, signed; v = sum 2^(8i) plane_i."""
    u = v.astype(np.int64) & ((1 << (8 * p)) - 1)
    planes = [(u >> (8 * i)) & 0xFF for i in range(p)]
    planes[-1] = np.where(planes[-1] >= 128, planes[-1] - 256, planes[-1])
    return planes


def _byte_perm(x, y, sel):
    """__byte_perm on (32, 4) byte arrays (byte n of each word in column n)."""
    cat = np.concatenate([x, y], axis=1)
    return cat[:, [(sel >> (4 * n)) & 7 for n in range(4)]]


def _split(v4, p):
    """tile_split: 16 realigned bytes (four words) into p plane words, with
    its byte permutations; returns plane j's bytes, in order."""
    w = [v4[:, 4 * i:4 * i + 4] for i in range(4)]
    if p == 1:
        return [v4]
    if p == 2:  # lo_bytes / hi_bytes of (x, y) and of (z, w)
        lo = np.concatenate([_byte_perm(w[0], w[1], 0x6420),
                             _byte_perm(w[2], w[3], 0x6420)], axis=1)
        hi = np.concatenate([_byte_perm(w[0], w[1], 0x7531),
                             _byte_perm(w[2], w[3], 0x7531)], axis=1)
        return [lo, hi]
    lo01 = _byte_perm(w[0], w[1], 0x5140)
    lo23 = _byte_perm(w[2], w[3], 0x5140)
    hi01 = _byte_perm(w[0], w[1], 0x7362)
    hi23 = _byte_perm(w[2], w[3], 0x7362)
    return [_byte_perm(lo01, lo23, 0x5410), _byte_perm(lo01, lo23, 0x7632),
            _byte_perm(hi01, hi23, 0x5410), _byte_perm(hi01, hi23, 0x7632)]


def _b_row(k):
    """tile_b_row: where a B plane keeps row k."""
    return ((k & ~15) | (((k >> 1) & 1) << 3) | (((k >> 2) & 3) << 1)
            | (k & 1))


def _ldsm(rows, trans):
    """ldmatrix.x4 (.trans): rows (32, 16) bytes, row r of matrix q given
    by lane 8q + r -> (4, 32, 4): register q of each lane, bytes."""
    m = rows.reshape(4, 8, 16)
    if trans:
        r = np.stack([2 * T, 2 * T, 2 * T + 1, 2 * T + 1], 1)
        c = np.stack([2 * G, 2 * G + 1, 2 * G, 2 * G + 1], 1)
    else:
        r = np.repeat(G[:, None], 4, 1)
        c = 4 * T[:, None] + np.arange(4)[None, :]
    return m[:, r, c]


def _mma(a, b, signed_a, signed_b):
    """mma.sync.m16n8k32 on lane fragments: a (4, 32, 4), b (2, 32, 4) bytes
    -> D (16, 8) int64."""
    def val(x, signed):
        x = x.astype(np.int64)
        return np.where(x >= 128, x - 256, x) if signed else x
    A, B = np.zeros((16, 32), np.int64), np.zeros((32, 8), np.int64)
    for reg in range(4):
        rows = (G + 8 * (reg & 1))[:, None]
        cols = 4 * T[:, None] + 16 * (reg >> 1) + np.arange(4)[None, :]
        A[rows, cols] = val(a[reg], signed_a)
    for reg in range(2):
        ks = 4 * T[:, None] + 16 * reg + np.arange(4)[None, :]
        B[ks, np.repeat(G[:, None], 4, 1)] = val(b[reg], signed_b)
    return A @ B


def _tile_model(a, b, p):
    """fxp_tile.cuh's C = A @ B mod 2^32 (uint32 as int64) for a (M, K),
    b (K, N) of p-byte values: the data path lane by lane."""
    m, k = a.shape
    n = b.shape[1]
    bk = ROW_BYTES // p
    stages = -(-k // bk)
    rng = np.random.RandomState(1)
    # the stage-padded operands as the copy leaves them: A's k >= K hold
    # other rows' values (garbage), B's k >= K are zero, rows >= M zero
    kp = stages * bk
    rows_p = -(-m // TILE_BM) * TILE_BM
    cols_p = -(-n // TILE_BN) * TILE_BN
    ap = np.zeros((rows_p, kp), np.int64)
    ap[:m, :k] = a
    ap[:m, k:] = rng.randint(-(2 ** (8 * p - 1)), 2 ** (8 * p - 1),
                             (m, kp - k))
    bp = rng.randint(-(2 ** (8 * p - 1)), 2 ** (8 * p - 1), (kp, cols_p))
    bp[:k, :n] = b
    bp[k:] = 0
    out = np.zeros((rows_p, cols_p), np.int64)
    pairs = [(i, j) for i in range(p) for j in range(p) if i + j <= 3]
    n_shift = min(2 * p - 1, 4)
    for row0 in range(0, rows_p, TILE_BM):
        for col0 in range(0, cols_p, TILE_BN):
            acc = np.zeros((n_shift, 8, 2, 2, 16, 8), np.int64)
            for s in range(stages):
                k0 = s * bk
                # the tile buffer: A planes (64, bk) bytes, B planes with
                # rows in tile_b_row order, through tile_split's PRMTs
                av = ap[row0:row0 + TILE_BM, k0:k0 + bk]
                bv = bp[k0:k0 + bk, col0:col0 + TILE_BN]
                abytes = av.astype(f"<i{p}").view(np.uint8).reshape(
                    TILE_BM * ROW_BYTES // 16, 16)
                bbytes = bv.astype(f"<i{p}").view(np.uint8).reshape(
                    bk * TILE_BN * p // 16, 16)
                apl = [x.reshape(TILE_BM, bk) for x in _split(abytes, p)]
                bpl_logical = [x.reshape(bk, TILE_BN)
                               for x in _split(bbytes, p)]
                bpl = [np.zeros_like(x) for x in bpl_logical]
                for j in range(p):
                    bpl[j][[_b_row(r) for r in range(bk)]] = bpl_logical[j]
                left = k - k0
                ksteps = bk // 32 if left >= bk else -(-left // 32)
                for warp in range(8):
                    wm, wn = warp >> 2, warp & 3
                    for ks in range(ksteps):
                        be, bo = [], []
                        for j in range(p):
                            t = _ldsm(bpl[j][ks * 32 + LANE,
                                             wn * 16:wn * 16 + 16], True)
                            be.append([_byte_perm(t[0], t[1], 0x6420),
                                       _byte_perm(t[2], t[3], 0x6420)])
                            bo.append([_byte_perm(t[0], t[1], 0x7531),
                                       _byte_perm(t[2], t[3], 0x7531)])
                        q = LANE >> 3
                        for i in range(p):
                            fa = []
                            for mt in range(2):
                                rows = wm * 32 + (LANE & 7) + 8 * (q & 1) \
                                    + 16 * mt
                                cols = ks * 32 + 16 * (q >> 1)
                                fa.append(_ldsm(np.stack([
                                    apl[i][r, c:c + 16]
                                    for r, c in zip(rows, cols)]), False))
                            for i2, j in pairs:
                                if i2 != i:
                                    continue
                                for mt in range(2):
                                    for nt, bfrag in enumerate((be[j], bo[j])):
                                        acc[i + j, warp, mt, nt] += _mma(
                                            fa[mt], bfrag, i == p - 1,
                                            j == p - 1)
            # recombination and the C fragment's place in the tile
            for warp in range(8):
                wm, wn = warp >> 2, warp & 3
                for mt in range(2):
                    for nt in range(2):
                        v = sum((acc[sh, warp, mt, nt] % 2 ** 32) << (8 * sh)
                                for sh in range(n_shift)) % 2 ** 32
                        for i in range(4):
                            r = wm * 32 + mt * 16 + G + 8 * (i >> 1)
                            c = wn * 16 + 4 * T + 2 * (i & 1) + nt
                            out[row0 + r, col0 + c] = v[
                                G + 8 * (i >> 1), 2 * T + (i & 1)]
    return out[:m, :n]


def _exact_mod32(a, b):
    """The exact dot mod 2^32 (uint64 arithmetic wraps mod 2^64)."""
    au = a.astype(np.int64).astype(np.uint64)
    bu = b.astype(np.int64).astype(np.uint64)
    return (au @ bu % np.uint64(2 ** 32)).astype(np.int64)


def _as_int32(u):
    return np.where(u >= 2 ** 31, u - 2 ** 32, u).astype(np.int32)


@pytest.mark.parametrize("m,k,n", [(7, 8, 6), (70, 33, 70), (64, 161, 65)],
                         ids=["d5", "ragged", "stages"])
@pytest.mark.parametrize("regime", ["mid", "full", "edge"])
@pytest.mark.parametrize("bits", [8, 16, 32])
def test_tile_model_is_the_wrapping_int32_dot(bits, regime, m, k, n):
    rng = np.random.RandomState(bits * 7 + k)
    a, b = _ints(rng, (m, k), bits, regime), _ints(rng, (k, n), bits, regime)
    got = _tile_model(a, b, bits // 8)
    want = _exact_mod32(a, b)
    np.testing.assert_array_equal(got, want)
    frac = {"mid": bits - 6, "full": bits - 2, "edge": bits - 1}[regime]
    tf, jf = tfx.FxpFormat(bits, frac), jfx.FxpFormat(bits, frac)
    plain = fxp_qmatmul.fxp_qmatmul_plain(torch.from_numpy(a),
                                          torch.from_numpy(b), tf)
    np.testing.assert_array_equal(
        plain.numpy(),
        tfx.rshift_round_saturate(torch.from_numpy(_as_int32(got)),
                                  tf).numpy())
    # the Pallas kernel on zero-padded shapes (zeros add nothing)
    ap = np.zeros((-(-m // 8) * 8, -(-k // 8) * 8), a.dtype)
    bp = np.zeros((ap.shape[1], -(-n // 8) * 8), b.dtype)
    ap[:m, :k], bp[:k, :n] = a, b
    jgot = fxp_qmatmul_pallas(jnp.asarray(ap), jnp.asarray(bp), jf,
                              bm=ap.shape[0], bn=bp.shape[1], bk=8,
                              interpret=True)
    np.testing.assert_array_equal(np.asarray(jgot)[:m, :n], plain.numpy())
    if regime == "full" and bits > 8:
        assert (np.abs(a.astype(np.float64) @ b.astype(np.float64))
                >= 2 ** 31).any(), "no dot wrapped"


@pytest.mark.parametrize("bits", [8, 16, 32])
def test_plane_split_pairs_and_shifts(bits):
    """x . w = sum over plane pairs of 2^(8(i+j)) x_i . w_j mod 2^32, with
    only the pairs i + j <= 3: 1, 4 and 10 products a multiply-add."""
    p = bits // 8
    rng = np.random.RandomState(bits)
    x, w = _ints(rng, (500,), bits, "full"), _ints(rng, (500,), bits, "full")
    xs, ws = _planes(x, p), _planes(w, p)
    pairs = [(i, j) for i in range(p) for j in range(p) if i + j <= 3]
    assert len(pairs) == {1: 1, 2: 4, 4: 10}[p]
    for i, v in enumerate(xs):  # the planes rebuild the value
        assert (v >= (-128 if i == p - 1 else 0)).all()
        assert (v <= (127 if i == p - 1 else 255)).all()
    assert (sum(v << (8 * i) for i, v in enumerate(xs)) == x).all()
    total = sum(int((xs[i] * ws[j]).sum()) << (8 * (i + j))
                for i, j in pairs) % 2 ** 32
    assert total == int(_exact_mod32(x[None, :], w[:, None])[0, 0])


TILE_HARNESS = r"""
#include "fxp_tile.cuh"
template <int P> static void fill(int* o) {
  using L = fxp::TileLayout<P>;
  const int f[] = {L::kBK, L::kARaw, L::kBRaw, L::kRawBytes, L::kAS, L::kBS,
                   L::kAPlane, L::kBPlane, L::kBufBytes, L::kRawOff, L::kSmem};
  for (int i = 0; i < 11; ++i) o[i] = f[i];
}
extern "C" void layout(int p, int* o) {
  if (p == 1) fill<1>(o); else if (p == 2) fill<2>(o); else fill<4>(o);
}
extern "C" long long blocks(int m, int n) { return fxp::tile_blocks(m, n); }
template <int P, int BM> static void fill_bm(int* o) {
  using L = fxp::TileLayout<P, BM>;
  const int f[] = {L::kMT, L::kARows, L::kRawBytes, L::kAPlane, L::kBufBytes,
                   L::kSmem, L::kMinBlocks, L::kBK};
  for (int i = 0; i < 8; ++i) o[i] = f[i];
}
template <int P> static void fill_p(int bm, int* o) {
  if (bm == 32) fill_bm<P, 32>(o);
  else if (bm == 64) fill_bm<P, 64>(o);
  else fill_bm<P, 128>(o);
}
extern "C" void layout_bm(int p, int bm, int* o) {
  if (p == 1) fill_p<1>(bm, o); else if (p == 2) fill_p<2>(bm, o);
  else fill_p<4>(bm, o);
}
extern "C" long long blocks_bm(int m, int n, int bm) {
  return fxp::tile_blocks(m, n, bm);
}
"""


@pytest.fixture(scope="module")
def host_tile(tmp_path_factory):
    lib = _host_build(tmp_path_factory, "tile", TILE_HARNESS)
    lib.layout.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.layout.restype = None
    lib.blocks.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.blocks.restype = ctypes.c_longlong
    lib.layout_bm.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.layout_bm.restype = None
    lib.blocks_bm.argtypes = [ctypes.c_int] * 3
    lib.blocks_bm.restype = ctypes.c_longlong
    return lib


@pytest.mark.parametrize("p", [1, 2, 4])
def test_tile_layout_fits_two_blocks_an_sm(host_tile, p):
    o = np.zeros(11, np.int32)
    host_tile.layout(p, o.ctypes.data)
    bk, a_raw, b_raw, raw, a_s, b_s, a_plane, b_plane, buf, raw_off, smem = o
    assert bk == ROW_BYTES // p and bk % 32 == 0
    assert (a_raw, b_raw) == (ROW_BYTES + 16, TILE_BN * p + 16)
    for stride in (a_s, b_s):  # odd multiples of 16: conflict-free phases
        assert stride % 16 == 0 and (stride // 16) % 2 == 1
    assert a_s >= bk and b_s >= TILE_BN
    assert buf == p * (a_plane + b_plane) and raw_off == 2 * buf
    assert smem == raw_off + 3 * raw
    assert TILE_BM * (TILE_BN + 1) * 4 <= buf  # the epilogue's scratch
    # two blocks an SM (228 KB, 1 KB reserved a block)
    assert 2 * (smem + 1024) <= 233_472


def test_tile_grid(host_tile):
    assert host_tile.blocks(3089, 300) == 49 * 5
    assert host_tile.blocks(65536, 64) == 1024
    assert host_tile.blocks(1, 1) == 1


def test_b_rows_make_conflict_free_phases():
    """tile_b_row is a permutation of each 16 rows, and each ldmatrix.trans
    phase (8 lanes) reads eight consecutive rows: matrix q's row r holds
    k = 16 (q >> 1) + 2 (q & 1) + 4 (r >> 1) + (r & 1)."""
    rows = [_b_row(k) for k in range(64)]
    assert sorted(rows) == list(range(64))
    for q in range(4):
        for r in range(8):
            k = 16 * (q >> 1) + 2 * (q & 1) + 4 * (r >> 1) + (r & 1)
            assert _b_row(k) == 8 * q + r


# --------------------------------------------------------------------------
# tree_ensemble on the integer container
# --------------------------------------------------------------------------
def _random_tree(seed, n_features, depth=6, scale=1.5):
    rng = np.random.RandomState(seed)
    feature, threshold, left, right, leaf = [], [], [], [], []

    def grow(d):
        node = len(feature)
        for arr in (feature, threshold, left, right, leaf):
            arr.append(0)
        if d == depth or (d > 0 and rng.rand() < 0.2):
            feature[node], left[node], right[node] = -1, node, node
            leaf[node] = rng.randint(4)
            return node
        feature[node] = rng.randint(n_features)
        threshold[node] = np.float32(rng.randn() * scale)
        leaf[node] = -1
        left[node] = grow(d + 1)
        right[node] = grow(d + 1)
        return node

    grow(0)
    arrays = dict(feature=np.asarray(feature, np.int32),
                  threshold=np.asarray(threshold, np.float32),
                  left=np.asarray(left, np.int32),
                  right=np.asarray(right, np.int32),
                  leaf_class=np.asarray(leaf, np.int32))
    meta = dict(max_depth=depth, n_classes=4, n_features=n_features)
    return (jtrees.TreeArrays(**arrays, **meta),
            ttrees.TreeArrays(**{k: v.copy() for k, v in arrays.items()},
                              **meta))


def _pallas(jt, x):
    packed = tuple(jnp.asarray(a) for a in pack_tree(jt))
    return np.asarray(tree_ensemble_pallas(jnp.asarray(x), *packed,
                                           block_batch=64, interpret=True))


@pytest.mark.parametrize("bits,frac", [(8, 4), (16, 8), (32, 10), (32, 28)])
def test_plain_on_containers_matches_pallas(bits, frac):
    """The container itself, not a float32 copy: the Pallas body casts
    inside, and so does the plain version.  At Q3.28 the int32 rows and
    thresholds lie in [2^24, 2^31), where the cast rounds to nearest
    even."""
    jt, tt = _random_tree(bits + frac, 9)
    jf, tf = jfx.FxpFormat(bits, frac), tfx.FxpFormat(bits, frac)
    jt, tt = jt.quantized(jf), tt.quantized(tf)
    x = np.random.RandomState(frac).randn(150, 9).astype(np.float32) * 2
    qx = tfx.quantize(torch.from_numpy(x), tf)
    assert qx.dtype == {8: torch.int8, 16: torch.int16, 32: torch.int32}[bits]
    np.testing.assert_array_equal(
        qx.numpy(), np.asarray(jfx.quantize(jnp.asarray(x), jf)))
    want = _pallas(jt, qx.numpy())
    got = tree_ensemble.tree_ensemble_plain(tt, qx)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the container agrees with its float32 cast (the first version's input)
    np.testing.assert_array_equal(
        tree_ensemble.tree_ensemble_plain(tt, qx.to(torch.float32)).numpy(),
        want)
    if frac == 28:
        big = np.abs(qx.numpy().astype(np.int64))
        assert ((big >= 2 ** 24) & (big < 2 ** 31)).mean() > 0.5


def test_plain_on_wide_int32_rows_matches_pallas():
    """int32 rows with magnitudes in [2^24, 2^31) and every low bit set at
    random, against thresholds there too: the cast rounds them to nearest
    even, and the rounding decides some compares."""
    jt, tt = _random_tree(11, 6, scale=2 ** 30)
    rng = np.random.RandomState(12)
    x = (rng.randint(2 ** 24, 2 ** 31 - 1, (200, 6))
         * rng.choice([-1, 1], (200, 6))).astype(np.int32)
    x[:6] = tt.threshold[tt.feature >= 0][:1].astype(np.int64).clip(
        -2 ** 31, 2 ** 31 - 1) + np.arange(-3, 3)[:, None]
    assert (x.astype(np.float32).astype(np.int64) != x).mean() > 0.5
    np.testing.assert_array_equal(
        tree_ensemble.tree_ensemble_plain(tt, torch.from_numpy(x)).numpy(),
        _pallas(jt, x))


def test_packed_table_and_route():
    """One 16-byte record a node: feature, threshold bits (a leaf's class
    in their place), left, right; the shared-memory route by the node count
    alone."""
    _, tt = _random_tree(3, 5)
    table = tree_ensemble.packed_operands(tt, torch.device("cpu"))
    assert table.dtype == torch.int32 and table.shape == (tt.n_nodes, 4)
    assert table.is_contiguous()
    t = table.numpy()
    inner = tt.feature >= 0
    np.testing.assert_array_equal(t[:, 0], tt.feature)
    np.testing.assert_array_equal(
        t[inner, 1].view(np.float32), tt.threshold[inner].astype(np.float32))
    np.testing.assert_array_equal(t[~inner, 1], tt.leaf_class[~inner])
    np.testing.assert_array_equal(t[:, 2], tt.left)
    np.testing.assert_array_equal(t[:, 3], tt.right)
    assert tree_ensemble.packed_operands(tt, torch.device("cpu")) is table
    limit = tree_ensemble.TABLE_SMEM_NODES
    assert tree_ensemble.table_in_smem(limit)
    assert not tree_ensemble.table_in_smem(limit + 1)
    assert limit * 16 <= 227 * 1024
    assert set(tree_ensemble.ROW_DTYPES) == {torch.float32, torch.int8,
                                             torch.int16, torch.int32}


@pytest.fixture(scope="module")
def tree_pair(blobs):
    x_train, y_train, x_test, _, _ = blobs
    model = jmodels.train_decision_tree(x_train, y_train, 3, max_depth=6)
    params = jcompile.get_lowering("tree").extract_params(model)
    return model, params, x_train[:256], x_test


@pytest.mark.parametrize("tag", list(QUANT_TAGS))
def test_quantized_tree_artifact_hands_the_container_to_the_kernel(
        tree_pair, tag, monkeypatch):
    model, params, cal, x = tree_pair
    kw = QUANT_TAGS[tag]
    cal = cal if kw["number_format"].startswith("auto") else None
    jart = jcompile.compile(model, jcompile.Target(backend="ref", **kw),
                            calibration=cal)
    tart = tcompile.compile(model_from_params("tree", params),
                            tcompile.Target(backend="cuda", **kw),
                            calibration=cal, device="cpu")
    seen = []
    plain = ops.tree_ensemble_plain

    def spy(tree, rows):
        seen.append(rows.dtype)
        return plain(tree, rows)

    monkeypatch.setattr(ops, "tree_ensemble_plain", spy)
    with ops.count_dispatches() as c:
        got = tart.predict(x)
    assert c.count == 1
    fmt = tart.extras["emit_spec"]["in_fmt"]
    assert seen == [tfx.FxpFormat(fmt.total_bits, fmt.frac_bits).dtype]
    np.testing.assert_array_equal(got, jart.predict(x))
    assert len(np.unique(got)) > 1


# --------------------------------------------------------------------------
# routing counts
# --------------------------------------------------------------------------
def test_routing_counts_are_pinned():
    """The fit predicates keep the counts of the kernels' first versions:
    the SVM's frozen 32 x 33 operand tiles and the MLP's two activation
    buffers, whatever tile the kernels run now."""
    assert fxp_model.SVM_ROUTING_OPERAND_TILE == 32
    assert fxp_model.svm_smem_bytes(1) == 4 * (32 + 1 + 32) + 8448
    assert fxp_model.svm_fits_smem(1696)
    assert not fxp_model.svm_fits_smem(1697)
    for bits, k in ((8, 3632), (16, 1816), (32, 908)):
        assert fxp_model.mlp_fits_smem([k, 6], bits)
        assert not fxp_model.mlp_fits_smem([k + 1, 6], bits)
        assert fxp_model.mlp_fits_smem([561, k, 6], bits)
        assert not fxp_model.mlp_fits_smem([561, k + 1, 6], bits)


@pytest.mark.parametrize("p", [1, 2, 4])
def test_tile_heights_the_tuner_chooses_between(host_tile, p):
    """The tile's instances of 32, 64 and 128 rows (the tuner's ``(bm, 64,
    128 // P)``): BM / 32 m16 tiles a warp over 2 x 4 warps, A rows copied in
    passes of 64, the epilogue's scratch over the two tile buffers, and the
    blocks an SM that ``__launch_bounds__`` asks for within 228 KB."""
    from repro_torch.kernels import tune

    ref = np.zeros(11, np.int32)
    host_tile.layout(p, ref.ctypes.data)
    assert tune.TILE_BMS == (32, 64, 128)
    for bm in tune.TILE_BMS:
        o = np.zeros(8, np.int32)
        host_tile.layout_bm(p, bm, o.ctypes.data)
        mt, a_rows, raw, a_plane, buf, smem, min_blocks, bk = o
        assert (mt, a_rows) == (bm // 32, max(1, bm // 64))
        assert tune.candidates("qmatmul", 1, 8, 8, 8 * p)[0][2] == bk
        assert raw == bm * (ROW_BYTES + 16) + bk * (TILE_BN * p + 16)
        assert a_plane == bm * ref[4] and smem == 2 * buf + 3 * raw
        assert bm * (TILE_BN + 1) * 4 <= 2 * buf
        assert min_blocks == (1 if bm == 128 else 2)
        assert min_blocks * (smem + 1024) <= 233_472
        if bm == 64:  # the default instance is today's layout
            assert (raw, a_plane, buf, smem) == (ref[3], ref[6], ref[8],
                                                 ref[10])
        for m, n in ((1, 6), (3089, 300), (65536, 64)):
            assert host_tile.blocks_bm(m, n, bm) == -(-m // bm) * -(-n // 64)
