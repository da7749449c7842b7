"""The narrow-N route of the CUDA ``fxp_layer`` kernel, on the host.

``csrc/fxp_layer_narrow.cuh`` runs a layer of N <= 32 outputs whose
weights fit one block's shared memory: persistent blocks stage W once, a
warp's 32 lanes split K (lane l takes k = l, l + 32, ...) for a group of R
rows, each lane keeps R x NB uint32 partials, and a reduce-scatter
butterfly of shuffles leaves each full sum on a lane that runs the
epilogue.  These tests

* compile the kernel's launch plan for the host with the system C++
  compiler: the narrow route admits exactly the (K, N) whose staged W fits
  its shared memory (and the Python mirror ``fxp_layer.narrow_plan`` agrees),
  W and the warps' rings of row chunks fit one block at every width,
  W's row stride puts the lanes of each load phase on distinct banks, and
  the persistent grid's row groups cover every row once;
* model the kernel's reduction in plain torch (the lanes' uint32 partials,
  the butterfly as the kernel runs it, then ``epilogue_plain``) and hold it
  to ``fxp_layer_plain`` and to the reference's ``fxp_layer_pallas`` in
  interpret mode, with full-range operands whose int32 sums wrap.

The kernel itself is held to ``fxp_layer_plain`` on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3).
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables jax x64, as the reference runs)
from repro.core import fixedpoint as jfx
from repro.kernels.fxp_layer import fxp_layer_pallas
from repro_torch.core import fixedpoint as tfx
from repro_torch.kernels import fxp_layer
from repro_torch.kernels.tune import SMEM_PER_BLOCK

from test_torch_epilogue import _host_build

HARNESS = r"""
#include "fxp_layer_narrow.cuh"
extern "C" int plan(int K, int N, int* out) {
  fxp::NarrowPlan p;
  if (!fxp::narrow_plan(K, N, &p)) return 0;
  out[0] = p.nb; out[1] = p.rows; out[2] = p.stride; out[3] = p.k_pad;
  out[4] = p.smem;
  return 1;
}
extern "C" int vec(int nb) { return fxp::narrow_vec(nb); }
extern "C" int blocks(int groups, int sms, int slots) {
  return fxp::narrow_blocks(groups, sms, slots);
}
extern "C" int first_group(int block, int warp, int grid) {
  return fxp::narrow_first_group(block, warp, grid);
}
extern "C" int group_step(int grid) { return fxp::narrow_group_step(grid); }
extern "C" int fold_count(int v) { return fxp::narrow_fold_count(v); }
extern "C" int fold_reps(int v) { return fxp::narrow_fold_reps(v); }
extern "C" int warps() { return fxp::kNarrowWarps; }
extern "C" int block_smem(int K, int N, int elem_bytes) {
  fxp::NarrowPlan p;
  return fxp::narrow_plan(K, N, &p) ? fxp::narrow_block_smem(p, elem_bytes)
                                    : -1;
}
"""
NP = {8: np.int8, 16: np.int16, 32: np.int32}
ACTS = fxp_layer.LAYER_ACTIVATIONS
MASK = (1 << 32) - 1


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    lib = _host_build(tmp_path_factory, "narrow_plan", HARNESS)
    lib.plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.vec, lib.group_step, lib.fold_count, lib.fold_reps):
        fn.argtypes = [ctypes.c_int]
    for fn in (lib.blocks, lib.first_group, lib.block_smem):
        fn.argtypes = [ctypes.c_int] * 3

    def plan(k, n):
        out = (ctypes.c_int * 5)()
        return tuple(out) if lib.plan(k, n, out) else None

    return plan, lib


def _staged_bytes(k, nb, stride):
    """One block's shared memory for W (K padded to whole 128-k chunks, NB
    columns padded to ``stride`` words, int32) and NB bias words."""
    k_pad = -(-k // 128) * 128
    return 4 * (k_pad * stride + nb)


def test_narrow_route_admits_the_layers_whose_weights_fit(host):
    plan, lib = host
    ks = sorted({1, 2, 8, 31, 32, 33, 64, 127, 128, 129, 300, 561, 640, 641,
                 1000, 2048, 3840, 3841, 3968, 3969, 4096, 8000})
    admitted = 0
    for n in range(0, 41):
        for k in ks:
            got = plan(k, n)
            assert got == fxp_layer.narrow_plan(k, n), (k, n)
            if got is None:
                continue
            admitted += 1
            nb, rows, stride, k_pad, smem = got
            assert 1 <= n <= 32 and n <= nb <= 32
            assert k_pad % 128 == 0 and k <= k_pad < k + 128
            assert smem == _staged_bytes(k, nb, stride)
            assert smem <= fxp_layer.NARROW_SMEM
            assert rows * nb <= 40 and rows >= 1
            for nbytes in (1, 2, 4):  # W, then each warp's ring of chunks
                total = lib.block_smem(k, n, nbytes)
                ring = lib.warps() * 4 * rows * (128 * nbytes + 16)
                assert total == -(-smem // 16) * 16 + ring
                assert total <= SMEM_PER_BLOCK, (k, n, nbytes)
        for k in ks:  # every N <= 32 whose W fits is admitted
            if 1 <= n <= 32:
                nb = next(b for b in (1, 2, 4, 6, 8, 10, 16, 32) if b >= n)
                stride = plan(1, n)[2]
                fits = _staged_bytes(k, nb, stride) <= fxp_layer.NARROW_SMEM
                assert (plan(k, n) is not None) == fits, (k, n)
    assert admitted > 400
    # the main paths' layers take the narrow route; the per-layer MLP's
    # hidden layer and a K past the budget take the tile loop
    for k, n in ((561, 6), (300, 6), (300, 10), (64, 6)):
        assert plan(k, n) is not None, (k, n)
    assert plan(561, 64) is None and plan(3969, 6) is None
    assert plan(3968, 6) is not None


@pytest.mark.parametrize("nb", [1, 2, 4, 6, 8, 10, 16, 32])
def test_weight_row_stride_is_bank_conflict_free(host, nb):
    """Lanes of one load phase read consecutive rows of W (k = l + 32 j):
    8 lanes of 16 bytes, 16 of 8 or 32 of 4 must cover distinct banks."""
    plan, lib = host
    stride = plan(1, nb)[2]
    vw = lib.vec(nb)
    assert stride >= nb and stride % vw == 0 and nb % vw == 0
    lanes = 32 // vw
    banks = [(lane * stride + w) % 32 for lane in range(lanes)
             for w in range(vw)]
    assert len(set(banks)) == len(banks) == 32


@pytest.mark.parametrize("m", [1, 3, 7, 31, 3089, 65536])
def test_row_groups_cover_every_row_once(host, m):
    plan, lib = host
    n_warps = lib.warps()
    for n in (1, 6, 10, 32):
        rows = plan(561, n)[1]
        groups = -(-m // rows)
        for sms, slots in ((132, 264), (132, 396), (4, 4), (1, 1)):
            grid = lib.blocks(groups, sms, slots)
            assert 1 <= grid <= slots
            assert grid >= min(groups, sms, slots)
            seen = np.zeros(m, np.int64)
            per_warp = []
            for block in range(grid):
                for warp in range(n_warps):
                    g, count = lib.first_group(block, warp, grid), 0
                    while g < groups:
                        seen[g * rows:(g + 1) * rows] += 1
                        g += lib.group_step(grid)
                        count += 1
                    per_warp.append(count)
            assert (seen == 1).all(), (m, n, sms, slots)
            assert max(per_warp) - min(per_warp) <= 1  # balanced


def _butterfly(vals):
    """The kernel's reduce-scatter on (32 lanes, V) uint32 partials: at each
    xor offset 16 .. 1, while the count is even each lane keeps the lower
    (lane bit clear) or upper half of its window and adds its partner's copy
    of that half; else it adds its partner's whole window.  Returns each
    lane's window values, the index of its first value, and the replicas."""
    v = [list(row) for row in vals]
    base = [0] * 32
    count, reps = len(v[0]), 32
    for o in (16, 8, 4, 2, 1):
        new = []
        if count % 2 == 0:
            h = count // 2
            for lane in range(32):
                up = bool(lane & o)
                partner = v[lane ^ o]
                keep = v[lane][h:] if up else v[lane][:h]
                got = partner[h:] if up else partner[:h]  # partner sends it
                new.append([(a + b) & MASK for a, b in zip(keep, got)])
                base[lane] += h if up else 0
            count, reps = h, reps // 2
        else:
            for lane in range(32):
                new.append([(a + b) & MASK
                            for a, b in zip(v[lane], v[lane ^ o])])
        v = new
    return v, base, reps


def _narrow_model(a, b, nb, rows):
    """The kernel's int32 dot for every (row, n < N): per row group, lane l
    sums a[r, k] * w[k, n] over k = l mod 32 (W zero-padded to NB columns)
    mod 2^32, then the butterfly; every output must come out exactly once."""
    m, k = a.shape
    n = b.shape[1]
    w = np.zeros((k, nb), np.int64)
    w[:, :n] = b
    acc = np.full((m, n), -1, np.int64)
    for g in range(-(-m // rows)):
        r0 = g * rows
        blk = np.zeros((rows, k), np.int64)
        blk[:min(rows, m - r0)] = a[r0:r0 + rows]
        vals = []
        for lane in range(32):
            part = (blk[:, lane::32] @ w[lane::32]) & MASK  # (rows, nb)
            vals.append([int(x) for x in part.reshape(-1)])
        v, base, reps = _butterfly(vals)
        for lane in range(32):
            for i, x in enumerate(v[lane]):
                if i % reps != lane & (reps - 1):
                    continue
                r, c = divmod(base[lane] + i, nb)
                if r0 + r < m and c < n:
                    assert acc[r0 + r, c] == -1, "an output stored twice"
                    acc[r0 + r, c] = x
    assert (acc >= 0).all(), "an output never stored"
    return torch.from_numpy(np.where(acc >= 2 ** 31, acc - 2 ** 32, acc)
                            .astype(np.int32))


def test_fold_shape_matches_the_kernel(host):
    _, lib = host
    for v in range(1, 41):
        vals, _, reps = _butterfly([[0] * v for _ in range(32)])
        assert (lib.fold_count(v), lib.fold_reps(v)) == (len(vals[0]), reps)


@pytest.mark.parametrize("n", [1, 6, 10, 32])
@pytest.mark.parametrize("bits", [8, 16, 32])
def test_narrow_reduction_matches_plain_and_pallas(host, bits, n):
    """Full-range operands (sums wrap at 16 and 32 bits), 9 rows (a ragged
    last row group), each K with its own activation and shift."""
    plan, _ = host
    rng = np.random.RandomState(bits * 41 + n)
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    wrapped = 0
    for i, k in enumerate((1, 8, 300, 561)):
        nb, rows = plan(k, n)[:2]
        a = rng.randint(lo, hi + 1, (9, k)).astype(NP[bits])
        b = rng.randint(lo, hi + 1, (k, n)).astype(NP[bits])
        a[0], b[:, 0] = hi, hi  # the largest products
        bias = rng.randint(lo, hi + 1, (n,)).astype(NP[bits])
        act, shift = ACTS[(i + n) % len(ACTS)], (bits - 1, 0, bits // 2, 7)[i]
        frac = bits - 1 - i % 2
        exact = a.astype(np.int64) @ b.astype(np.int64)
        wrapped += int(np.abs(exact).max() >= 2 ** 31)
        fmt = tfx.FxpFormat(bits, frac)
        ta, tb, tbias = (torch.from_numpy(x) for x in (a, b, bias))
        acc = _narrow_model(a.astype(np.int64), b.astype(np.int64), nb, rows)
        got = fxp_layer.epilogue_plain(acc, tbias[None, :], fmt, act, shift)
        plain = fxp_layer.fxp_layer_plain(ta, tb, tbias, fmt, act, shift)
        assert torch.equal(got, plain), (k, act, shift)
        want = fxp_layer_pallas(jnp.asarray(a), jnp.asarray(b),
                                jnp.asarray(bias), jfx.FxpFormat(bits, frac),
                                act, shift=shift, bm=9, bn=n, bk=k,
                                interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if bits > 8:
        assert wrapped, "no case wrapped the int32 dot"


def test_narrow_grid_mirrors_narrow_blocks(host):
    """``fxp_layer.narrow_grid`` (the tuner's today-blocking of the narrow
    route) computes ``narrow_blocks`` of ``csrc/fxp_layer_narrow.cuh``."""
    _, lib = host
    for groups in (1, 2, 7, 8, 9, 97, 132, 773, 1024, 16384):
        for sms in (1, 8, 132):
            for slots in (1, 132, 264, 396, 2000):
                assert fxp_layer.narrow_grid(groups, sms, slots) == \
                    lib.blocks(groups, sms, slots), (groups, sms, slots)
