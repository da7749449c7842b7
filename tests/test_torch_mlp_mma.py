"""The MLP megakernels' tensor-core arithmetic and layout, on the host.

``csrc/fxp_mlp_body.cuh`` runs the 8- and 16-bit MLP layers on int8 MMAs.
A 16-bit value splits into a signed high byte and an unsigned low byte,
``x = 256 hi + lo``, and the kernel sums four int8 products in four s32
accumulators (hi.hi, hi.lo, lo.hi, lo.lo), then recombines them in uint32
as ``(hh << 16) + ((hl + lh) << 8) + ll``.  These tests hold that algebra to the
exact int64 dot modulo 2^32 (the Pallas kernel's wrapping int32 dot, and
the port's plain ``imatmul``), sums that wrap included, and check that no
partial sum can overflow its s32 accumulator at the widest K the routing
predicate admits.  The kernel's shared-memory plan (``mlp_plan``) and its
grid (``mlp_blocks_per_model``) compile for the host with the system C++
compiler: every model that ``mlp_fits_smem`` admits must fit one block.
"""

import ctypes

import numpy as np
import pytest
import torch

from repro_torch.core import fixedpoint as tfx
from repro_torch.kernels import fxp_model
from repro_torch.kernels.tune import SMEM_PER_BLOCK

from test_torch_epilogue import _host_build

HARNESS = r"""
#include "fxp_mlp_body.cuh"
extern "C" int plan(const int* dims, int n_layers, int bytes, int* out) {
  fxp::MlpShape s;
  if (!fxp::mlp_shape_from(dims, n_layers, &s)) return -1;
  fxp::MlpPlan p;
  if (!fxp::mlp_plan(s, bytes, &p)) return 0;
  const int fields[] = {p.total, p.resident, p.groups, p.kc, p.x_stride[0],
                        p.x_stride[1], p.x_off[0], p.x_off[1], p.raw_off,
                        p.scr_off, p.bias_off, p.wc_off, p.wc_stride,
                        p.group_off, p.group_bytes, p.w_base, p.epi_off,
                        (int)sizeof(fxp::Epilogue)};
  for (int i = 0; i < 18; ++i) out[i] = fields[i];
  for (int l = 0; l < n_layers; ++l) {
    out[18 + l] = p.w_off[l];
    out[26 + l] = p.w_stride[l];
  }
  return 1;
}
extern "C" int blocks(int tiles, int blocks, int groups, int models) {
  return fxp::mlp_blocks_per_model(tiles, blocks, groups, models);
}
extern "C" int plan_cap(const int* dims, int n_layers, int bytes, int cap,
                        int* out) {
  fxp::MlpShape s;
  if (!fxp::mlp_shape_from(dims, n_layers, &s)) return -1;
  fxp::MlpPlan p;
  if (!fxp::mlp_plan(s, bytes, &p, cap)) return 0;
  out[0] = p.groups; out[1] = p.resident; out[2] = p.total;
  return 1;
}
"""
FIELDS = ("total", "resident", "groups", "kc", "x_stride0", "x_stride1",
          "x_off0", "x_off1", "raw_off", "scr_off", "bias_off", "wc_off",
          "wc_stride", "group_off", "group_bytes", "w_base", "epi_off",
          "epilogue_bytes")
MMA_BM, MMA_NC = 16, 64


def _split(v: np.ndarray, bits: int):
    """(hi, lo) bytes of a container value: hi signed, lo unsigned; for 8
    bits the value is its own signed byte."""
    v = v.astype(np.int64)
    if bits == 8:
        return v, None
    return v >> 8, v & 0xFF


def _wrap32(v: np.ndarray) -> np.ndarray:
    return ((v.astype(np.int64) + 2 ** 31) % 2 ** 32 - 2 ** 31)


def _mma_dot(a: np.ndarray, b: np.ndarray, bits: int) -> np.ndarray:
    """The kernel's dot: int8 products summed in wrapping s32 accumulators,
    recombined in uint32, returned as the int32 it reinterprets."""
    ahi, alo = _split(a, bits)
    bhi, blo = _split(b, bits)
    hh = _wrap32(ahi @ bhi)
    if bits == 8:
        return hh
    hl, lh, ll = _wrap32(ahi @ blo), _wrap32(alo @ bhi), _wrap32(alo @ blo)
    mid = (hl + lh) % 2 ** 32
    u = ((hh % 2 ** 32) << 16) + (mid << 8) + (ll % 2 ** 32)
    return _wrap32(u % 2 ** 32)


def _operands(rng, shape, bits, regime):
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    if regime == "edge":
        return np.choose(rng.randint(0, 6, shape),
                         [lo, lo + 1, -1, 0, hi - 1, hi]).astype(np.int64)
    if regime == "bytes":  # every low byte 0x00 / 0x80 / 0xFF pattern
        v = rng.randint(lo, hi + 1, shape).astype(np.int64)
        if bits == 16:
            v = (v & ~0xFF) | np.choose(rng.randint(0, 3, shape),
                                        [0x00, 0x80, 0xFF])
        return ((v - lo) % 2 ** bits) + lo
    return rng.randint(lo, hi + 1, shape).astype(np.int64)


@pytest.mark.parametrize("regime", ["random", "edge", "bytes"])
@pytest.mark.parametrize("bits", [8, 16])
def test_split_byte_dot_is_the_wrapping_int32_dot(bits, regime):
    rng = np.random.RandomState(bits * 7 + len(regime))
    dt = {8: torch.int8, 16: torch.int16}[bits]
    wrapped = 0
    for m, k, n in ((5, 561, 6), (16, 64, 8), (3, 1, 1), (4, 33, 10),
                    (2, 1816, 3)):
        a = _operands(rng, (m, k), bits, regime)
        b = _operands(rng, (k, n), bits, regime)
        exact = a @ b  # int64, exact at these sizes
        wrapped += int((np.abs(exact) >= 2 ** 31).any())
        want = _wrap32(exact)
        got = _mma_dot(a, b, bits)
        np.testing.assert_array_equal(got, want)
        plain = tfx.imatmul(torch.from_numpy(a).to(dt),
                            torch.from_numpy(b).to(dt), torch.int32)
        np.testing.assert_array_equal(got, plain.numpy().astype(np.int64))
    if bits == 16 and regime != "random":
        assert wrapped, "no 16-bit case wrapped the int32 dot"


@pytest.mark.parametrize("bits", [8, 16])
def test_split_byte_partials_never_overflow_s32(bits):
    """At the widest K the predicate admits, the largest |partial sum| of
    each accumulator set stays inside int32, so the s32 MMAs never wrap and
    only the uint32 recombination does."""
    k = SMEM_PER_BLOCK // (2 * 32 * (bits // 8))  # the predicate's limit
    assert fxp_model.mlp_fits_smem([k, 6], bits)
    assert not fxp_model.mlp_fits_smem([k + 1, 6], bits)
    if bits == 8:
        worst = {"hh": 128 * 128}
    else:
        worst = {"hh": 128 * 128, "hl": 128 * 255, "lh": 255 * 128,
                 "ll": 255 * 255}
    for name, per_product in worst.items():
        assert per_product * k < 2 ** 31, (name, k)


@pytest.fixture(scope="module")
def host_plan(tmp_path_factory):
    lib = _host_build(tmp_path_factory, "mlp_plan", HARNESS)
    lib.plan.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p]
    lib.plan.restype = ctypes.c_int
    lib.blocks.argtypes = [ctypes.c_int] * 4
    lib.blocks.restype = ctypes.c_int

    def plan(dims, bits):
        c_dims = (ctypes.c_int * len(dims))(*dims)
        out = (ctypes.c_int * 34)()
        ok = lib.plan(c_dims, len(dims) - 1, bits // 8, out)
        if ok != 1:
            return None
        n = len(dims) - 1
        p = dict(zip(FIELDS, out[:18]))
        p["w_off"], p["w_stride"] = list(out[18:18 + n]), list(out[26:26 + n])
        return p

    return plan, lib.blocks


def _widths(limit):
    return sorted({1, 2, 6, 8, 31, 32, 33, 64, 561, 1000, limit // 2,
                   limit - 1, limit})


def _round_up(v, m):
    return -(-v // m) * m


def _weight_block(k, n, nb):
    """(rows, elements a row) of a K x N weight block in shared memory: as
    it is at 16 bits (K padded to 32 rows of N padded to 8), transposed at 8
    bits (N padded to 8 rows of K padded to 32)."""
    if nb == 2:
        return _round_up(k, 32), _round_up(n, 8)
    return _round_up(n, 8), _round_up(k, 32)


def _check_layout(p, dims, nb):
    """Every region of the plan inside one block's shared memory, 16-byte
    aligned, large enough, and disjoint; strides conflict-free."""
    assert p["total"] <= SMEM_PER_BLOCK, (dims, p)
    assert p["total"] == p["group_off"] + p["groups"] * p["group_bytes"]
    assert 1 <= p["groups"] <= 3 and (p["resident"] or p["groups"] == 1)
    for key in ("x_off1", "raw_off", "scr_off", "bias_off", "wc_off",
                "group_off", "group_bytes", "w_base", "total"):
        assert p[key] % 16 == 0, (key, dims, p)
    assert p["w_base"] >= p["epi_off"] + 8 * p["epilogue_bytes"]
    for b in (0, 1):  # even and odd layers' inputs
        wide = max([dims[l] for l in range(b, len(dims) - 1, 2)] or [1])
        assert p[f"x_stride{b}"] % 32 == 16, (dims, p)
        assert p[f"x_stride{b}"] >= _round_up(wide, 32), (dims, p)
    # the activations: one byte plane a container byte (16 bits: high, low)
    assert p["x_off0"] == 0
    assert p["x_off1"] >= nb * MMA_BM * p["x_stride0"]
    assert p["raw_off"] >= p["x_off1"] + nb * MMA_BM * p["x_stride1"]
    # a tile's rows, the 15-byte head and what the unpack reads past them
    assert (p["scr_off"] - p["raw_off"]
            >= MMA_BM * dims[0] * nb + 15 + 32 * nb + 8)
    assert p["bias_off"] - p["scr_off"] == MMA_BM * MMA_NC * 4
    assert p["wc_off"] - p["bias_off"] == MMA_NC * 4
    if p["resident"]:
        assert p["kc"] == 0 and p["group_bytes"] == p["wc_off"]
        end = 0
        for l, (k, n) in enumerate(zip(dims, dims[1:])):
            rows, cols = _weight_block(k, n, nb)
            assert p["w_stride"][l] % 32 == 16
            assert p["w_stride"][l] >= cols * nb
            assert p["w_off"][l] >= end
            end = p["w_off"][l] + rows * p["w_stride"][l]
        assert p["w_base"] + end <= p["group_off"]
    else:
        assert p["kc"] in (256, 128, 64, 32)
        rows, cols = _weight_block(p["kc"], MMA_NC, nb)
        assert p["wc_stride"] % 32 == 16
        assert p["wc_stride"] >= cols * nb
        assert p["group_bytes"] - p["wc_off"] == rows * p["wc_stride"]


@pytest.mark.parametrize("bits", [8, 16])
def test_plan_fits_every_model_the_predicate_admits(host_plan, bits,
                                                    monkeypatch):
    monkeypatch.delenv("REPRO_MEGAKERNEL_VMEM", raising=False)
    plan, _ = host_plan
    limit = SMEM_PER_BLOCK // (2 * 32 * (bits // 8))
    nb = bits // 8
    checked = 0
    for w in _widths(limit):
        for dims in ([w, 64, 6], [561, w, 6], [w, 6], [w] * 9,
                     [w, w, 10], [8, w, w, w, 6]):
            admitted = fxp_model.mlp_fits_smem(dims, bits)
            assert admitted == (max(dims) <= limit and len(dims) <= 9)
            if not admitted:
                continue
            p = plan(dims, bits)
            assert p is not None, dims
            checked += 1
            _check_layout(p, dims, nb)
    assert checked > 30
    # the D6 MLP keeps its weights resident, with three warp groups a block
    for dims in ([561, 64, 6], [561, 6]):
        p = plan(dims, bits)
        assert (p["resident"], p["groups"]) == (1, 3), (dims, p)


def test_blocks_per_model_fill_the_card(host_plan):
    _, blocks = host_plan
    # 3089 rows = 194 tiles; 132 blocks of 3 groups fit: one round, spread
    # over every SM (62 blocks run a second group)
    assert blocks(194, 132, 3, 1) == 132
    assert blocks(194, 132, 1, 1) == 97  # one group a block: two rounds
    # 8 models share 132 blocks: 16 each, 5 rounds of 48 groups
    assert blocks(194, 132, 3, 8) == 16
    assert blocks(4096, 132, 3, 1) == 132
    assert blocks(1, 132, 3, 1) == 1
    assert blocks(3, 132, 3, 200) == 1  # more models than blocks: one each
    for tiles in (1, 7, 97, 194, 4096):
        for card in (1, 132, 264):
            for groups in (1, 2, 3):
                for models in (1, 2, 8):
                    b = blocks(tiles, card, groups, models)
                    per_model = max(1, card // models)
                    assert 1 <= b <= per_model
                    rounds = -(-tiles // (per_model * groups))
                    assert b * groups * rounds >= tiles
                    assert b == per_model or b * rounds >= tiles


@pytest.fixture(scope="module")
def host_plan_cap(tmp_path_factory):
    """(groups, resident, total) of ``mlp_plan`` under a cap of ``cap`` warp
    groups, compiled for the host."""
    lib = _host_build(tmp_path_factory, "mlp_plan_cap", HARNESS)
    lib.plan_cap.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, ctypes.c_void_p]
    lib.plan_cap.restype = ctypes.c_int

    def plan(dims, bits, cap):
        c_dims = (ctypes.c_int * len(dims))(*dims)
        out = (ctypes.c_int * 3)()
        ok = lib.plan_cap(c_dims, len(dims) - 1, bits // 8, cap, out)
        return tuple(out) if ok == 1 else None

    return plan


@pytest.mark.parametrize("bits", [8, 16])
def test_tuned_warp_groups_are_what_the_plan_lays_out(host_plan_cap, bits,
                                                      monkeypatch):
    """The tuner's 8- and 16-bit MLP blocks (``bm = 16 x groups``) are the
    caps under which ``mlp_plan`` lays out exactly that many groups, today's
    the most that fit; ``fxp_model.mlp_mma_smem_bytes`` is the plan's own
    count of a resident layout."""
    from repro_torch.kernels import tune

    monkeypatch.delenv("REPRO_MEGAKERNEL_VMEM", raising=False)
    limit = SMEM_PER_BLOCK // (2 * 32 * (bits // 8))
    checked = 0
    for w in _widths(limit):
        for dims in ([w, 64, 6], [561, w, 6], [w, 6], [w] * 9, [8, w, w, 6]):
            if not fxp_model.mlp_fits_smem(dims, bits):
                continue
            today = host_plan_cap(dims, bits, 3)
            laid = [g for g in (1, 2, 3)
                    if host_plan_cap(dims, bits, g)[:2] == (g, 1)]
            for g in laid:
                assert host_plan_cap(dims, bits, g)[2] == \
                    fxp_model.mlp_mma_smem_bytes(dims, bits, g), (dims, g)
            cands = tune.model_candidates("mlp", dims, bits)
            assert cands[0] == 16 * today[0], (dims, cands, today)
            assert sorted(cands) == [16 * g for g in (laid or [1])], dims
            checked += 1
    assert checked > 30
