"""On the card: one short run of each cell through the harness, traced,
with the check.  Marked ``cuda``; skips without a card.  On the GPU host:
``python3 -m pytest -q -m cuda bench/tests/test_bench_cuda.py``."""

from __future__ import annotations

import json

import pytest

from conftest import ROOT

from bench import harness

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_traced_run_on_the_card(cuda_device, name):
    cell = harness.load_cell(name)
    # the traced requests, then one cycle untraced
    n = cell.mix["trace_requests"] + len(harness.traffic.shapes(cell.mix,
                                                                cell.cfg))
    res = harness.run(cell, 2**31 + 5, 0.0, True, cuda_device, stop_after=n)
    assert res["correct"], res["checks"]
    dev = res["device"]
    assert dev["platform"] == "gpu" and 0 < dev["busy_s"] <= dev["window_s"]
    for m in cell.per_layer:
        assert m in res["metrics"], m
    assert res["metrics"]["forward_mfu"]["value"] < 105
    assert res["metrics"]["flash_attention_roofline"]["value"] < 105
    assert res["tracing"]["overhead_pct"] < 50
    assert res["breakdown"]["idle_gaps"]
