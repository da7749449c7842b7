"""The trace reduction and the per-layer readers on synthetic events, and
the manifest against the contract's shape."""

from __future__ import annotations

import json
import re

import pytest

from conftest import ROOT, small_cfg

from bench import metrics, tracing
from bench.flops import dense as flops

E = tracing.Event
WIN = tracing.WINDOW


def _events():
    ms = 1_000_000
    return [
        E(WIN, 0, 100 * ms, False, True),
        E("outside", -50 * ms, -10 * ms, True),
        E("gemm", 5 * ms, 30 * ms, True),
        E("flash_attention_kernel<128>", 20 * ms, 40 * ms, True),  # overlaps
        E("Memcpy HtoD", 50 * ms, 55 * ms, True),
        E("gemm", 90 * ms, 120 * ms, True),  # clipped at the window's end
        E("aten::linear", 0, 60 * ms, False),
        E("cudaLaunchKernel", 41 * ms, 49 * ms, False),  # inside the linear
        E("aten::cat", 60 * ms, 95 * ms, False),
    ]


def test_reduce_busy_launches_and_gaps():
    t = tracing.reduce(_events())
    assert t.window_s == pytest.approx(0.1)
    # busy: 5-40, 50-55, 90-100 ms
    assert t.busy_s == pytest.approx(0.050)
    assert t.launches == 3  # the copy is not a launch; "outside" is out
    assert t.device_s_by_name["gemm"] == pytest.approx(0.035)
    # gaps 0-5 (mid 2.5: linear), 40-50 (mid 45: the launch inside the
    # linear), 55-90 (mid 72.5: cat)
    assert t.idle_by_host_op == pytest.approx(
        {"aten::linear": 0.005, "cudaLaunchKernel": 0.010, "aten::cat": 0.035})
    assert t.top(t.device_s_by_name)[0][0] == "gemm"
    assert [n for n, _ in t.top(t.idle_by_host_op)] == [
        "aten::cat", "cudaLaunchKernel", "aten::linear"]


def test_no_window_no_trace():
    assert tracing.reduce([E("gemm", 0, 5, True)]) is None


def test_a_trace_of_the_card_alone_takes_the_hosts_window():
    ms = 1_000_000
    dev = [E("gemm", 5 * ms, 30 * ms, True),
           E("flash_attention_kernel<128>", 20 * ms, 40 * ms, True),
           E("Memset", 50 * ms, 55 * ms, True)]
    t = tracing.reduce(dev, window_s=0.2)
    assert t.window_s == 0.2 and t.busy_s == pytest.approx(0.040)
    assert t.launches == 2 and t.idle_by_host_op == {}
    assert t.device_s_by_name["gemm"] == pytest.approx(0.025)


def _ctx(trace, requests=((16, 20), (32, 8)), untraced=((16, 20),) * 3,
         untraced_s=0.5):
    return metrics.Context(trace=trace, requests=list(requests),
                           untraced_requests=list(untraced),
                           untraced_s=untraced_s, cfg=small_cfg(),
                           flops=flops,
                           peak={"bf16_flops_per_s": 1e12,
                                 "hbm_bytes_per_s": 1e11})


def test_readers_on_a_trace():
    t = tracing.reduce(_events())
    ctx = _ctx(t)
    want = sum(flops.request_flops(ctx.cfg, i, n)
               for i, n in ctx.untraced_requests)
    assert metrics.read("forward_mfu", ctx) == pytest.approx(
        100 * want / (0.5 * 1e12))
    assert metrics.read("launches_per_request", ctx) == 1.5
    assert metrics.read("device_idle_share", ctx) == pytest.approx(50.0)
    bound = sum(max(f / 1e12, b / 1e11) for i, n in ctx.requests
                for f, b in flops.attention_calls(ctx.cfg, i, n))
    assert metrics.read("flash_attention_roofline", ctx) == pytest.approx(
        100 * bound / 0.020)


@pytest.mark.parametrize("name", ["forward_mfu", "launches_per_request",
                                  "flash_attention_roofline",
                                  "device_idle_share"])
def test_readers_read_nothing_from_nothing(name):
    nothing = dict(untraced=(), untraced_s=None) \
        if name == "forward_mfu" else {}
    assert metrics.read(name, _ctx(None, **nothing)) is None
    assert metrics.read(name, _ctx(tracing.reduce([
        E(WIN, 0, 10, False, True)]), **nothing)) is None  # no device work
    if name != "device_idle_share":
        assert metrics.read(name, _ctx(tracing.reduce(_events()),
                                       requests=(), **nothing)) is None


def test_no_flash_kernel_no_roofline():
    t = tracing.reduce([e for e in _events() if "flash" not in e.name])
    assert metrics.read("flash_attention_roofline", _ctx(t)) is None


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_the_manifest_has_the_contracts_shape():
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["bench"] and 1 <= m["run_seconds"] <= 51
    configs = {c["name"]: c for c in m["configs"]}
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])
    cells = {w["name"] for w in m["workloads"]}
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "bench" / "cells" / f"{w['name']}.json").exists()
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    e2e = {e["name"] for e in m["end_to_end"]}
    assert "setup_s" in e2e
    for e in m["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert set(e.get("workloads", cells)) <= cells
    for p in m["per_layer"]:
        assert (ROOT / "bench" / "metrics" / f"{p['name']}.py").exists()
        assert p["moves"] in e2e and UNIT.match(p["unit"])
    names = [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in
                                                 names + sorted(cells))


def test_a_traced_run_on_the_cpu_reads_no_card():
    """The traced run's whole path (the traced requests, the untraced rest,
    the attribution's requests, the check) on the CPU: every reader finds
    no card and reads nothing; the rates beside the trace are there."""
    from conftest import small_cell

    from bench import harness, traffic

    cell = small_cell()
    n = cell.mix["trace_requests"] + len(traffic.shapes(cell.mix, cell.cfg))
    res = harness.run(cell, 2**31 + 9, 0.0, True, "cpu", stop_after=n)
    assert res["correct"] and list(res)[-1] == "checks"
    assert res["metrics"] == {}  # no device events, no peak for "cpu"
    rates = res["tracing"]
    assert rates["traced_tokens_per_s"] > 0
    assert rates["untraced_tokens_per_s"] > 0
    assert rates["host_ops_traced_tokens_per_s"] > 0
    assert res["device"]["busy_s"] == 0.0
