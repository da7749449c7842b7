"""The port's block-size tuner (``repro_torch.kernels.tune``) against the
reference's (``repro.kernels.tune``), on the host.

The bucketing helpers and the cache keys must match the reference's letter
for letter (the device part aside); the selection, the two cache layers, the
cross-process union of the JSON file and the override checks are the port's
own.  Every test points ``REPRO_TORCH_TUNE_CACHE`` (and the reference's
``REPRO_TUNE_CACHE``) at ``tmp_path``.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from repro.kernels import tune as ref_tune
from repro_torch.core.fixedpoint import FxpFormat
from repro_torch.kernels import fxp_model, ops, tune

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
N_THREADS = 8
H100 = (132, 396)  # (SMs, narrow slots) of a card, for the narrow grid


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = str(tmp_path / "tune_cache.json")
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", path)
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "ref_cache.json"))
    tune.clear_memory_cache()
    ref_tune.clear_memory_cache()
    yield path
    tune.clear_memory_cache()
    ref_tune.clear_memory_cache()


def _device_free(key):
    return key.rsplit("|", 1)[0]


def _race(fn):
    barrier = threading.Barrier(N_THREADS)
    results, errors = [None] * N_THREADS, [None] * N_THREADS

    def run(i):
        barrier.wait()
        try:
            results[i] = fn(i)
        except Exception as e:  # noqa: BLE001 - reported below
            errors[i] = e

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(N_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results, errors


def test_bucketing_matches_reference():
    for n in range(1, 5001):
        assert tune.pow2ceil(n) == ref_tune.pow2ceil(n)
        assert tune.batch_bucket(n) == ref_tune.batch_bucket(n)
        assert (tune.batch_bucket(n, cap=1 << 30)
                == ref_tune.batch_bucket(n, cap=1 << 30))


def test_cache_keys_match_reference_but_the_device(cache):
    calls = [("matmul_blocks", ("qmatmul", 3089, 561, 300, 16), {}),
             ("matmul_blocks", ("layer", 7, 561, 64, 8), {}),
             ("matmul_blocks", ("layer", 3089, 561, 6, 16),
              {"occupancy": H100}),
             ("model_block_m", ("mlp", 3089, (561, 64, 6), 16), {}),
             ("model_block_m", ("svm-rbf", 65536, (561, 300, 6), 32), {}),
             ("fleet_blocks", ("mlp", 8, 64, (561, 64, 6), 16),
              {"uniform": False}),
             ("fleet_blocks", ("svm-poly", 4, 3298, (8, 300, 10), 32), {})]
    for name, args, kw in calls:
        getattr(tune, name)(*args, **kw)
        kw.pop("occupancy", None)
        getattr(ref_tune, name)(*args, **kw)
    mine = sorted(tune.cache_snapshot())
    theirs = sorted(ref_tune.cache_snapshot())
    assert [_device_free(k) for k in mine] == [_device_free(k)
                                               for k in theirs]
    assert all(k.endswith("|cpu:cpu") for k in mine)
    assert "qmatmul|4096x561x300|w16" in [_device_free(k) for k in mine]
    assert tune.device_key("cpu") == "cpu:cpu"


def test_fastest_candidate_wins_and_a_raising_one_is_skipped(cache):
    cands = tune.candidates("qmatmul", 100, 561, 300, 16)
    times = {cands[0]: 3.0, cands[1]: 2.0, cands[2]: 1.0}
    seen = []

    def runner(blk):
        seen.append(blk)
        if blk == cands[2]:
            raise RuntimeError("refused")
        return times[blk]

    before = tune.sweep_seconds
    assert tune.matmul_blocks("qmatmul", 100, 561, 300, 16, runner) == cands[1]
    assert seen == cands and tune.sweep_seconds > before

    def refuse(blk):
        raise RuntimeError(f"no {blk}")

    with pytest.raises(RuntimeError, match="no "):
        tune.matmul_blocks("qmatmul", 100, 561, 301, 16, refuse)
    assert not any("561x301" in k for k in tune.cache_snapshot())
    assert tune.model_block_m("mlp", 50, (561, 64, 6), 16,
                              runner=lambda bm: abs(bm - 32)) == 32
    assert tune.fleet_blocks("svm-rbf", 4, 64, (8, 300, 10), 32,
                             runner=lambda c: c[1]) == (1, 16)


def test_without_runner_today_blocking(cache):
    for bits, bk in ((8, 128), (16, 64), (32, 32)):
        assert tune.matmul_blocks("qmatmul", 3089, 561, 300, bits) == (
            64, 64, bk)
        assert tune.matmul_blocks("layer", 3089, 561, 64, bits) == (
            64, 64, bk)
    # the narrow route: today's narrow_blocks at the bucketed batch
    assert tune.matmul_blocks("layer", 3089, 561, 6, 16,
                              occupancy=H100) == (4, 132, 128)
    assert tune.matmul_blocks("layer", 1, 561, 6, 16,
                              occupancy=H100) == (4, 1, 128)
    assert tune.matmul_blocks("layer", 65536, 300, 32, 8,
                              occupancy=H100)[:2] == (1, 396)
    with pytest.raises(ValueError, match="occupancy"):
        tune.matmul_blocks("layer", 5, 64, 6, 16)
    # megakernels: as many warp groups as fit at 8/16 bits, else 32 rows
    assert tune.model_block_m("mlp", 3089, (561, 64, 6), 16) == 48
    assert tune.model_block_m("mlp", 3089, (3632, 6), 16) == 16  # streamed
    assert tune.model_block_m("mlp", 3089, (561, 64, 6), 32) == 32
    assert tune.model_block_m("svm-rbf", 3089, (561, 300, 6), 16) == 32
    assert tune.fleet_blocks("mlp", 8, 3089, (561, 64, 6), 8) == (1, 48)
    assert tune.fleet_blocks("svm-poly", 2, 3089, (561, 300, 6), 16,
                             uniform=False) == (1, 32)


def test_narrow_grid_candidates():
    cands = tune.candidates("layer", 4096, 561, 6, 16, occupancy=H100)
    assert cands == [(4, 132, 128), (4, 264, 128), (4, 396, 128)]
    cands = tune.candidates("layer", 1, 561, 10, 16, occupancy=(132, 264))
    assert cands == [(4, 1, 128), (4, 132, 128), (4, 264, 128)]
    assert tune.candidates("layer", 64, 40000, 6, 16)[0] == (64, 64, 64)


def test_pow2_bucket_shares_one_entry_and_survives_through_the_file(cache):
    calls = []

    def runner(blk):
        calls.append(blk)
        return float(blk[0])

    got = {tune.matmul_blocks("qmatmul", m, 33, 70, 8, runner)
           for m in (65, 100, 128)}
    assert got == {(32, 64, 128)} and len(calls) == 3
    assert len(tune.cache_snapshot()) == 1
    with open(cache) as f:
        assert list(json.load(f).values()) == [[32, 64, 128]]
    tune.clear_memory_cache()
    assert tune.cache_snapshot() == {}
    assert tune.matmul_blocks("qmatmul", 99, 33, 70, 8, runner) == (
        32, 64, 128)
    assert len(calls) == 3  # from the file: no sweep


def test_corrupt_or_foreign_file_is_ignored(cache):
    for text in ("{not json", json.dumps([1, 2, 3]),
                 json.dumps({"qmatmul|8x8x8|w8|cpu:cpu": [0, 1, 2],
                             "qmatmul|16x8x8|w8|cpu:cpu": [1, 2]})):
        with open(cache, "w") as f:
            f.write(text)
        tune.clear_memory_cache()
        assert tune.matmul_blocks("qmatmul", 8, 8, 8, 8) == (64, 64, 128)
        with open(cache) as f:
            raw = json.load(f)  # rewritten whole and valid
        assert raw["qmatmul|8x8x8|w8|cpu:cpu"] == [64, 64, 128]


def test_read_only_cache_is_not_an_error(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE",
                       str(tmp_path / "file" / "sub" / "cache.json"))
    (tmp_path / "file").write_text("a file where a directory should be")
    tune.clear_memory_cache()
    try:
        assert tune.matmul_blocks("qmatmul", 8, 8, 8, 16) == (64, 64, 64)
    finally:
        tune.clear_memory_cache()


def test_concurrent_tuning_unions_with_a_sibling_writer(cache):
    foreign = {f"layer|8x{k}x40|w16|sibling:device": [32, 64, 64]
               for k in (17, 19, 23)}

    def tune_i(i):
        if i == 0:  # a sibling persisting its own keys under the same lock
            with tune._save_lock(cache):
                with open(cache) as f:
                    raw = json.load(f)
                raw.update(foreign)
                tmp = cache + ".tmp.sibling"
                with open(tmp, "w") as f:
                    json.dump(raw, f)
                os.replace(tmp, cache)
            return None
        return tune.matmul_blocks("qmatmul", 2 ** i, 64 + i, 32, 16)

    tune.matmul_blocks("qmatmul", 1, 64, 32, 16)  # seed the file
    results, errors = _race(tune_i)
    assert errors == [None] * N_THREADS
    tune.matmul_blocks("layer", 4, 8, 40, 16)  # one more save re-merges
    with open(cache) as f:
        raw = json.load(f)
    for key in foreign:
        assert key in raw, "a sibling's entries were clobbered"
    assert len([k for k in raw if k.startswith("qmatmul|")]) == N_THREADS
    for val in raw.values():
        assert len(val) == 3 and all(int(v) > 0 for v in val)


def test_second_process_unions_into_one_file(cache):
    script = ("from repro_torch.kernels import tune\n"
              "for k in (11, 12, 13):\n"
              "    tune.matmul_blocks('qmatmul', 64, k, 40, 8,\n"
              "                       runner=lambda b: float(b[0]))\n")
    env = dict(os.environ, PYTHONPATH=SRC, REPRO_TORCH_TUNE_CACHE=cache)
    proc = subprocess.Popen([sys.executable, "-c", script], env=env)
    for k in (21, 22, 23):
        tune.matmul_blocks("qmatmul", 64, k, 40, 8)
    assert proc.wait(timeout=120) == 0
    tune.matmul_blocks("qmatmul", 64, 24, 40, 8)  # re-merges the child's
    with open(cache) as f:
        raw = json.load(f)
    for k in (11, 12, 13):
        assert raw[f"qmatmul|64x{k}x40|w8|cpu:cpu"] == [32, 64, 128]
    for k in (21, 22, 23, 24):
        assert raw[f"qmatmul|64x{k}x40|w8|cpu:cpu"] == [64, 64, 128]


def test_same_key_races_agree(cache):
    results, errors = _race(lambda i: tune.matmul_blocks(
        "layer", 64, 256, 40, 16, runner=lambda b: float(b[0] == 128)))
    assert errors == [None] * N_THREADS
    assert len(set(results)) == 1
    with open(cache) as f:
        assert len(json.load(f)) == 1
    results, errors = _race(lambda i: tune.model_block_m(
        "svm-rbf", 100, (8, 300, 10), 32, runner=lambda bm: float(i + bm)))
    assert errors == [None] * N_THREADS and len(set(results)) == 1


def test_fit_filtered_candidates(monkeypatch):
    monkeypatch.delenv("REPRO_MEGAKERNEL_VMEM", raising=False)
    # 16 bits: the warp groups mlp_plan lays out, today's (the most) first
    assert tune.model_candidates("mlp", (561, 64, 6), 16) == [48, 16, 32]
    assert tune.model_candidates("mlp", (561, 100, 6), 16) == [32, 16]
    assert tune.model_candidates("mlp", (561, 128, 6), 16) == [16]
    assert tune.model_candidates("mlp", (3632, 6), 16) == [16]
    # 32 bits and the SVMs: the routing counts at each bm
    assert tune.model_candidates("mlp", (561, 64, 6), 32) == [32, 16]
    assert tune.model_candidates("mlp", (200, 64, 6), 32) == [32, 16, 64]
    assert tune.model_candidates("svm-rbf", (561, 300, 6), 16) == [32, 16, 64]
    assert tune.model_candidates("svm-rbf", (561, 1696, 6), 8) == [32, 16]
    assert fxp_model.svm_fits_smem(1696) and not fxp_model.svm_fits_smem(
        1696, 64)
    # a caller's count and budget
    assert tune.model_candidates("svm-poly", (8, 300, 10), 32,
                                 smem_bytes=lambda bm: bm,
                                 budget=16) == [32, 16]
    monkeypatch.setenv("REPRO_MEGAKERNEL_VMEM", str(2 * 16 * 561 * 4))
    assert tune.model_candidates("mlp", (561, 64, 6), 32) == [32, 16]


def test_fleet_be_is_pinned_to_one(cache):
    for uniform in (True, False):
        be, _ = tune.fleet_blocks("mlp", 8, 3089, (561, 64, 6), 16,
                                  uniform=uniform,
                                  runner=lambda c: 1.0 / c[0] + c[1])
        assert be == 1
    tune.check_fleet_blocks("mlp", (561, 64, 6), 16, 1, 32)
    tune.check_fleet_blocks("mlp", (561, 64, 6), 16, None, None)
    for be in (2, 4, 0, True):
        with pytest.raises(ValueError, match="be = 1"):
            tune.check_fleet_blocks("mlp", (561, 64, 6), 16, be, None)


def _mlp(rng, dims, bits):
    fmt = FxpFormat(bits, bits - 6)
    x = torch.from_numpy(rng.randint(-20, 20, (5, dims[0]))).to(fmt.dtype)
    ws = [torch.from_numpy(rng.randint(-20, 20, (k, n))).to(fmt.dtype)
          for k, n in zip(dims, dims[1:])]
    bs = [torch.from_numpy(rng.randint(-20, 20, (n,))).to(fmt.dtype)
          for n in dims[1:]]
    sched = tuple((6, fmt, "none") for _ in ws)
    return x, ws, bs, sched


@pytest.mark.parametrize("impl", ["cuda", "ref"])
def test_overrides_check_and_ignore_off_the_card(cache, impl):
    rng = np.random.RandomState(0)
    fmt = FxpFormat(16, 10)
    a = torch.from_numpy(rng.randint(-50, 50, (7, 40))).to(torch.int16)
    w = torch.from_numpy(rng.randint(-50, 50, (40, 70))).to(torch.int16)
    w6, bias6 = w[:, :6].contiguous(), torch.zeros(6, dtype=torch.int16)
    bias = torch.zeros(70, dtype=torch.int16)
    want = ops.fxp_qmatmul(a, w, fmt, impl)
    for blk in ((32, 64, 64), (128, 64, 64)):
        assert torch.equal(ops.fxp_qmatmul(a, w, fmt, impl, blocks=blk), want)
        ops.fxp_layer(a, w, bias, fmt, impl=impl, blocks=blk)
    ops.fxp_layer(a, w6, bias6, fmt, impl=impl, blocks=(4, 3, 128))
    for blk in ((16, 64, 64), (64, 32, 64), (64, 64, 32), (64, 64), "x"):
        with pytest.raises(ValueError, match="no compiled blocking"):
            ops.fxp_qmatmul(a, w, fmt, impl, blocks=blk)
        with pytest.raises(ValueError, match="no compiled blocking"):
            ops.fxp_layer(a, w, bias, fmt, impl=impl, blocks=blk)
    for blk in ((64, 64, 64), (8, 3, 128), (4, 0, 128), (4, 3, 64)):
        with pytest.raises(ValueError, match="no compiled blocking"):
            ops.fxp_layer(a, w6, bias6, fmt, impl=impl, blocks=blk)

    x, ws, bs, sched = _mlp(rng, (40, 16, 6), 16)
    want = ops.fxp_mlp_model(x, ws, bs, sched, impl)
    for bm in (16, 32, 48):
        assert torch.equal(ops.fxp_mlp_model(x, ws, bs, sched, impl, bm=bm),
                           want)
    for bm in (64, 24, 0, 48.0):
        with pytest.raises(ValueError, match="no compiled block"):
            ops.fxp_mlp_model(x, ws, bs, sched, impl, bm=bm)
    x, ws, bs, sched = _mlp(rng, (3632, 6), 16)  # streamed: one group
    with pytest.raises(ValueError, match="no compiled block"):
        ops.fxp_mlp_model(x, ws, bs, sched, impl, bm=32)
    x, ws, bs, sched = _mlp(rng, (40, 16, 6), 32)
    ops.fxp_mlp_model(x, ws, bs, sched, impl, bm=64)
    with pytest.raises(ValueError, match="no compiled block"):
        ops.fxp_mlp_model(x, ws, bs, sched, impl, bm=48)

    xe = torch.stack([x, x])
    wse = [torch.stack([t, t]) for t in ws]
    bse = [torch.stack([t, t]) for t in bs]
    ops.fxp_mlp_fleet(xe, wse, bse, (sched, sched), impl, be=1, bm=16)
    with pytest.raises(ValueError, match="be = 1"):
        ops.fxp_mlp_fleet(xe, wse, bse, (sched, sched), impl, be=2)
    with pytest.raises(ValueError, match="no compiled block"):
        ops.fxp_mlp_fleet(xe, wse, bse, (sched, sched), impl, bm=128)

    f32 = FxpFormat(32, 16)
    qx = torch.from_numpy(rng.randint(-9, 9, (5, 8))).to(torch.int32)
    sv = torch.from_numpy(rng.randint(-9, 9, (33, 8))).to(torch.int32)
    dual = torch.from_numpy(rng.randint(-9, 9, (33, 3))).to(torch.int32)
    icept = torch.zeros(3, dtype=torch.int32)
    args = (qx, sv, dual, icept, "rbf", f32, f32, 3, 0, 0, 16)
    want = ops.fxp_svm_model(*args, impl=impl)
    for bm in (16, 32, 64):
        assert torch.equal(ops.fxp_svm_model(*args, impl=impl, bm=bm), want)
    with pytest.raises(ValueError, match="no compiled block"):
        ops.fxp_svm_model(*args, impl=impl, bm=128)
    p = ((f32, f32, 3, 0, 0, 16),)
    ops.fxp_svm_fleet(qx[None], sv[None], dual[None], icept[None], "rbf", p,
                      impl, be=1, bm=64)
    with pytest.raises(ValueError, match="be = 1"):
        ops.fxp_svm_fleet(qx[None], sv[None], dual[None], icept[None], "rbf",
                          p, impl, be=8)
    with pytest.raises(ValueError, match="no compiled block"):
        ops.fxp_svm_fleet(qx[None], sv[None], dual[None], icept[None], "rbf",
                          p, impl, bm=8)
    # off the card nothing consults the tuner, so nothing is written
    assert tune.cache_snapshot() == {} and not os.path.exists(cache)
