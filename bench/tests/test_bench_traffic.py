"""The schedule is fixed by the mix: every seed runs the same multiset of
shapes; the seed moves only the order, the offsets and the ids."""

from __future__ import annotations

import collections
import json
from pathlib import Path

import pytest
import torch

from conftest import CONFIG, ROOT, small_cfg

from bench import traffic
from bench.programs import dense as program

MIXES = sorted((ROOT / "bench" / "traffic").glob("*.json"))
SEEDS = (0, 1, 2**31 + 77, 2**40 + 3)
CFG = json.loads(CONFIG.read_text())


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_every_seed_runs_the_same_shapes(path):
    mix = json.loads(path.read_text())
    n = len(traffic.shapes(mix, CFG))
    multisets, orders = set(), set()
    for seed in SEEDS:
        s = traffic.Schedule(mix, CFG, seed, 1 << 20, 8192)
        reqs = [s[i] for i in range(3 * n + 5)]
        for c in range(3):  # each cycle holds each shape once
            cycle = reqs[c * n:(c + 1) * n]
            assert (sorted((r.n_image, r.n_text) for r in cycle)
                    == sorted(traffic.shapes(mix, CFG)))
        multisets.add(tuple(sorted(collections.Counter(
            (r.n_image, r.n_text) for r in reqs[:3 * n]).items())))
        orders.add(tuple((r.n_image, r.n_text, r.text_offset)
                         for r in reqs))
        again = traffic.Schedule(mix, CFG, seed, 1 << 20, 8192)
        assert [again[i] for i in range(len(reqs))] == reqs
    assert len(multisets) == 1
    assert len(orders) == len(SEEDS)


def test_cycles_go_in_balanced_pairs():
    mix = json.loads((ROOT / "bench" / "traffic" / "longdoc.json")
                     .read_text())
    by_size = sorted(r[0] + r[1] for r in traffic.shapes(mix, CFG))
    n = len(by_size)
    s = traffic.Schedule(mix, CFG, 5, 1 << 20, 8192)
    cycle = [s[i].positions for i in range(n)]
    pairs = {tuple(sorted(cycle[i:i + 2])) for i in range(0, n, 2)}
    assert pairs == {(by_size[i], by_size[n - 1 - i]) for i in range(n // 2)}


def test_stratified_lengths():
    assert traffic.stratified_lengths(32, 1216, 8) == [
        41, 64, 100, 158, 248, 391, 615, 969]
    got = traffic.stratified_lengths(8192, 32768, 8, 128)
    assert all(x % 128 == 0 and 8192 <= x <= 32768 for x in got)
    assert got == sorted(got) and len(set(got)) == 8
    with pytest.raises(ValueError):
        traffic.stratified_lengths(10, 5, 2)


def test_two_seeds_draw_different_ids_and_activations():
    cfg = small_cfg()
    a = program.arch(cfg)
    pools = []
    for seed in (11, 12):
        gen = torch.Generator().manual_seed(seed)
        pools.append(program.draw_pools(a, 4096, 512, gen,
                                        torch.device("cpu"),
                                        cfg["image_token_index"]))
    assert not torch.equal(pools[0]["tokens"], pools[1]["tokens"])
    assert not torch.equal(pools[0]["image"], pools[1]["image"])
    same = program.draw_pools(a, 4096, 512, torch.Generator().manual_seed(11),
                              torch.device("cpu"), cfg["image_token_index"])
    assert torch.equal(same["tokens"], pools[0]["tokens"])
    # text ids stay below the image token; the head is the whole vocabulary
    assert int(pools[0]["tokens"].max()) < cfg["image_token_index"] \
        < a.vocab_size


@pytest.mark.parametrize("size,positions", [
    ((672, 672), 576 + 48 * 48 + 48),  # the full 2 x 2 grid, nothing cut
    ((336, 336), 576 + 24 * 24 + 24),  # a 1 x 2 grid, half its columns pad
    ((640, 480), 2340), ((480, 640), 2352), ((640, 427), 2144),
    ((640, 300), 1654)])
def test_anyres_positions_follow_the_pinpoints(size, positions):
    assert traffic.anyres_positions(*size, CFG) == positions


def test_the_vqa_mix_spans_the_photos_positions():
    mix = json.loads((ROOT / "bench" / "traffic" / "vqa.json").read_text())
    images = sorted({i for i, _ in traffic.shapes(mix, CFG)})
    assert images == [2144, 2160, 2340, 2352, 2928]


def test_a_request_longer_than_its_pool_is_refused():
    mix = json.loads((ROOT / "bench" / "traffic" / "longdoc.json")
                     .read_text())
    with pytest.raises(ValueError):
        traffic.Schedule(mix, CFG, 0, 1000, 8192)
