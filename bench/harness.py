"""One run of one cell: set-up, the measured window (part of it traced in
a traced run) and the output check.

:func:`load_cell` finds everything a cell needs by the names in
``BENCHMARK.json``; :func:`run` runs it and returns the result line as a
dict.  ``bench/run.py`` is the command; ``bench/calibrate.py`` reads the
check's numbers over many seeds, with the control beside them.

The window is a closed loop: the mix's ``in_flight`` requests are kept
issued (the next is dispatched while the last runs), for ``seconds``; then
no more is issued and the ones in flight are drained.  A request is timed
from its issue (the host's clock as the call into the program starts) to
the card finishing it (an event recorded after it, read on the same clock
through an event recorded at the window's start).  The window closes when
the last request finishes, so the rate is all the work over all the time.
"""

from __future__ import annotations

import collections
import dataclasses
import importlib
import json
import os
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

import numpy as np

from bench import check, traffic, tracing
from bench import metrics as metric_readers

__all__ = ["Cell", "load_cell", "run", "forbidden_modules", "ROOT",
           "TEXT_POOL", "IMAGE_POOL"]

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the input pools requests are cut from (token ids; image activations)
TEXT_POOL = 1 << 20
IMAGE_POOL = 8192


@dataclasses.dataclass
class Cell:
    name: str
    cfg: Dict
    mix: Dict
    checks: Dict
    end_to_end: List[str]
    per_layer: List[str]
    units: Dict[str, str]
    program: ModuleType
    reference: ModuleType
    flops: ModuleType


def _read(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _metrics_of(entries: List[Dict], cell: str) -> List[str]:
    return [m["name"] for m in entries
            if "workloads" not in m or cell in m["workloads"]]


def load_cell(name: str, root: Path = ROOT,
              manifest: Optional[Dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files and modules."""
    manifest = manifest or _read(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    entry = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    cfg = _read(root / entry["file"])
    return Cell(
        name=name, cfg=cfg,
        mix=_read(root / "bench" / "traffic" / f"{w['traffic']}.json"),
        checks=_read(root / "bench" / "cells" / f"{name}.json"),
        end_to_end=_metrics_of(manifest["end_to_end"], name),
        per_layer=_metrics_of(manifest["per_layer"], name),
        units={m["name"]: m["unit"]
               for m in manifest["end_to_end"] + manifest["per_layer"]},
        program=importlib.import_module(f"bench.programs.{cfg['program']}"),
        reference=importlib.import_module(
            f"bench.reference.{cfg['reference']}"),
        flops=importlib.import_module(f"bench.flops.{cfg['flops']}"))


def process_age_s() -> Optional[float]:
    """Seconds since this process started (Linux's /proc), else None."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class _Clock:
    """Request completion times on the host's clock, in seconds since
    :meth:`start`: on the card through CUDA events (one recorded at the
    start, one after each request), on the host at the call's return."""

    def __init__(self, torch, device):
        self.torch = torch
        self.cuda = device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def start(self) -> None:
        self.sync()
        self.t0 = time.perf_counter()
        if self.cuda:
            self.ev0 = self.torch.cuda.Event(enable_timing=True)
            self.ev0.record()

    def now(self) -> float:
        return time.perf_counter() - self.t0

    def mark(self):
        if not self.cuda:
            return self.now()
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def wait(self, mark) -> float:
        if not self.cuda:
            return mark
        mark.synchronize()
        return self.ev0.elapsed_time(mark) / 1e3


def _peak_row(name: str) -> Optional[Dict]:
    for row in _read(ROOT / "bench" / "peaks.json")["cards"]:
        if row["match"] in name:
            return row
    return None


def _say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def _profile(torch, dev, host_ops: bool):
    """A profiler of the card's activity alone, or with ``host_ops`` (or
    where there is no card) of the host's operations too."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if dev.type == "cuda" else []
    if host_ops or not acts:
        acts.append(ProfilerActivity.CPU)
    return profile(activities=acts)


def _rate(records) -> Optional[float]:
    """Positions a second over ``(request, t_issue, t_end)`` records that
    began at the first one's issue."""
    if not records:
        return None
    t0 = min(t for _, t, _ in records)
    t1 = max(t for _, _, t in records)
    return sum(r.positions for r, _, _ in records) / (t1 - t0) \
        if t1 > t0 else None


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
        stop_after: Optional[int] = None, control: bool = False) -> Dict:
    """One run; returns the result line as a dict (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, with ``trace``
    ``breakdown`` and ``tracing``, and last ``checks``, which holds each
    number the check compared).  ``stop_after``: issue that many requests
    and no more, whatever ``seconds`` says.  ``control``: also compare the
    control (the reference in float8) with the reference on the checked
    rows, under ``control`` (calibration).

    With ``trace`` the window's first ``trace_requests`` requests run under
    a profiler of the card alone (the per-layer metrics' trace); the rest
    of the window runs untraced (``forward_mfu`` and the rate the tracing
    overhead is read against); after the window ``attribution_requests``
    run under a profiler of the host's operations too, whose trace puts
    the card's idle gaps down to what the host was doing."""
    import torch

    t_enter = process_age_s()
    dev = torch.device(device)
    prog = cell.program
    a = prog.arch(cell.cfg)
    if dev.type == "cuda":
        torch.cuda.init()
        t = time.perf_counter()
        torch.empty(1, device=dev)  # the context
        _say(f"set-up: process at {t_enter} s when the run began; CUDA "
             f"context {time.perf_counter() - t:.3f} s")
        from repro_torch.kernels import build

        t = time.perf_counter()
        built = build.build_all(prog.KERNELS)
        _say(f"kernels {sorted(built)} ready in "
             f"{time.perf_counter() - t:.3f} s (nvcc seconds {built})")
    t = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % 2**64)
    params = prog.draw_params(a, gen, dev)
    pools = prog.draw_pools(a, TEXT_POOL, IMAGE_POOL, gen, dev,
                            cell.cfg.get("image_token_index"))
    _say(f"set-up: weights and pools drawn in {time.perf_counter() - t:.3f}"
         f" s")
    sched = traffic.Schedule(cell.mix, cell.cfg, seed, TEXT_POOL, IMAGE_POOL)
    cycle = sched.first_cycle()
    spec = cell.checks["check"]
    sampled = check.sample(cycle, spec["requests"], spec["rows"], seed, dev)

    def call(r):
        return prog.run(params, prog.batch(pools, r.n_image, r.n_text,
                                           r.image_offset, r.text_offset), a)

    clock = _Clock(torch, dev)
    t = time.perf_counter()
    for r in cycle:  # warm-up: each of the mix's shapes once
        call(r)
    clock.sync()
    setup_s = process_age_s()
    _say(f"set-up: warm-up of {len(cycle)} requests "
         f"{time.perf_counter() - t:.3f} s; setup_s {setup_s}")

    in_flight = sched.in_flight
    n_trace = cell.mix["trace_requests"] if trace else 0
    records, pending, kept = [], collections.deque(), {}
    prof = None
    traced: List = []
    traced_s = t_untraced = None

    def finish():
        r, t_issue, mark = pending.popleft()
        records.append((r, t_issue, clock.wait(mark)))

    def close_trace():
        nonlocal traced_s, t_untraced
        while pending:
            finish()
        clock.sync()
        traced_s = clock.now() - t_traced
        prof.__exit__(None, None, None)
        traced.extend(records)
        t_untraced = clock.now()  # the untraced rest starts here

    clock.start()
    if n_trace:
        prof = _profile(torch, dev, host_ops=False)
        prof.__enter__()
        clock.sync()
        t_traced = clock.now()
    i = 0
    while (i < stop_after) if stop_after is not None else (
            clock.now() < seconds):
        r = sched[i]
        t_issue = clock.now()
        logits = call(r)
        if r.index in sampled:
            kept[r.index] = logits[0].index_select(0, sampled[r.index])
        del logits
        pending.append((r, t_issue, clock.mark()))
        i += 1
        while len(pending) >= in_flight:
            finish()
        if n_trace and i == n_trace:
            close_trace()
            n_trace = 0
    while pending:
        finish()
    if n_trace:
        close_trace()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    window_s = max(t for _, _, t in records)
    lat_ms = [1e3 * (t_end - t_issue) for _, t_issue, t_end in records]
    e2e = {
        "prefill_tokens_per_s": (sum(r.positions for r, _, _ in records)
                                 / window_s, "tokens/s"),
        "request_p95_ms": (float(np.percentile(lat_ms, 95)), "ms"),
        "peak_mem_gib": (peak / 2**30, "GiB"),
        "setup_s": (setup_s, "s"),
    }
    _say(f"window {window_s:.4f} s, {len(records)} requests, "
         f"{sum(r.positions for r, _, _ in records)} positions, latency "
         f"p50 {np.percentile(lat_ms, 50):.3f} ms, max {max(lat_ms):.3f} ms")

    result: Dict = {"correct": False, "attempted": len(records), "failed": 0}
    tr = None
    if trace:
        tr = tracing.from_profiler(prof, window_s=traced_s)
        prof = None  # the raw trace is read: free it
        untraced = records[len(traced):]
        ctx = metric_readers.Context(
            trace=tr, requests=[(r.n_image, r.n_text) for r, _, _ in traced],
            untraced_requests=[(r.n_image, r.n_text) for r, _, _ in untraced],
            untraced_s=(window_s - t_untraced) if untraced else None,
            cfg=cell.cfg, flops=cell.flops, peak=_peak_row(_card(torch, dev)))
        values = {m: metric_readers.read(m, ctx) for m in cell.per_layer}
        result["metrics"] = {m: {"value": v, "unit": cell.units[m]}
                             for m, v in values.items() if v is not None}
    else:
        result["metrics"] = {m: {"value": e2e[m][0], "unit": e2e[m][1]}
                             for m in cell.end_to_end
                             if e2e[m][0] is not None}
    result["device"] = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                        "kind": _card(torch, dev), "count": 1,
                        "memory_peak_bytes": int(peak)}
    if trace:
        result["device"]["busy_s"] = tr.busy_s if tr else None
        result["device"]["window_s"] = tr.window_s if tr else None
        attr, host_rate = _attribute_idle(torch, dev, clock, call, sched, i,
                                          cell.mix.get(
                                              "attribution_requests", 0))
        if tr is not None:
            result["breakdown"] = {
                "device_ops": tr.top(tr.device_s_by_name),
                "idle_gaps": attr.top(attr.idle_by_host_op) if attr else []}
            _say(f"traced {len(traced)} requests: window {tr.window_s:.4f} "
                 f"s, busy {tr.busy_s:.4f} s, {tr.launches} launches")
        rates = {"traced_tokens_per_s": _rate(traced),
                 "untraced_tokens_per_s": _rate(records[len(traced):]),
                 "host_ops_traced_tokens_per_s": host_rate}
        if rates["traced_tokens_per_s"] and rates["untraced_tokens_per_s"]:
            rates["overhead_pct"] = 100.0 * (
                1.0 - rates["traced_tokens_per_s"]
                / rates["untraced_tokens_per_s"])
        result["tracing"] = rates
        _say(f"tracing overhead: {rates}")

    # the check: the program's state is gone (its logits were dropped as
    # each request was issued, but the kept rows); the weights and inputs
    # are the benchmark's own, which the reference reads
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    got, ctl = [], []
    t = time.perf_counter()
    for idx, rows in sampled.items():
        if idx not in kept:
            continue  # not issued in this window: nothing due
        r = sched[idx]
        b = prog.batch(pools, r.n_image, r.n_text, r.image_offset,
                       r.text_offset)
        image = b["image_embeds"][0] if "image_embeds" in b else None
        ref = cell.reference.forward_rows(cell.cfg, params, b["tokens"][0],
                                          image, rows)
        got.append(check.numbers(kept.pop(idx), ref))
        if control:
            low = cell.reference.forward_rows(cell.cfg, params,
                                              b["tokens"][0], image, rows,
                                              precision="fp8")
            ctl.append(check.numbers(low, ref))
        del ref
    _say(f"reference over {len(got)} requests in "
         f"{time.perf_counter() - t:.3f} s")
    values = check.worst(got) if got else None
    correct, checks = check.judge(values, cell.checks["limits"])
    result["correct"] = correct
    if control:
        result["control"] = check.worst(ctl) if ctl else None
    result["checks"] = checks
    return result


def _attribute_idle(torch, dev, clock, call, sched, first: int, n: int):
    """Runs ``n`` more requests (from ``first``) in the closed loop under a
    profiler of the host's operations and the card; returns the reduced
    trace, whose idle gaps are put down to host operations, and the rate
    they ran at (None, None for ``n`` 0)."""
    if not n:
        return None, None
    from torch.profiler import record_function

    pending: collections.deque = collections.deque()
    ends = []
    prof = _profile(torch, dev, host_ops=True)
    with prof:
        with record_function(tracing.WINDOW):
            clock.sync()
            t0 = clock.now()
            for j in range(first, first + n):
                call(sched[j])
                pending.append(clock.mark())
                while len(pending) >= sched.in_flight:
                    ends.append(clock.wait(pending.popleft()))
            while pending:
                ends.append(clock.wait(pending.popleft()))
            clock.sync()
    positions = sum(sched[j].positions for j in range(first, first + n))
    return tracing.from_profiler(prof), positions / (max(ends) - t0)


def _card(torch, dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
