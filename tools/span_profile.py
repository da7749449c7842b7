#!/usr/bin/env python3
"""Where a benchmark cell's requests spend the card's time, by the LM
forward's own spans (``repro_torch.spans``), and what the spans cost.

    python3 tools/span_profile.py --workload <cell> --seed <n>
        [--rounds 4] [--device cuda] [--out build/spans.json]

Sets the cell of ``BENCHMARK.json`` up as ``bench/run.py`` does (weights,
pools and traffic from the seed, one request of each shape to warm up, the
closed loop of the mix's ``in_flight``), then runs ``--rounds`` rounds, each
of three windows of the mix's ``trace_requests`` requests, in an order
that turns each round, each window after a full garbage collection:

* ``on``: under a profiler of the card alone, the spans on; its trace is
  put down to the spans (``bench/span_trace.py``) over the window's
  bounds, read on the spans' clock;
* ``off``: under the same profiler, the spans off;
* ``untraced``: no profiler, the spans off.

Then ``attribution_requests`` more run under a profiler of the host's
operations too, spans off (the idle gaps by host operation, as the
benchmark's breakdown has them).  Prints, and writes to ``--out`` as
JSON: each window kind's rates (positions a second, the host's clock) and
seconds of garbage collection inside the timed loop; the spans' cost
(``1 - on / off`` in each round); the ``on`` windows' table summed (device
seconds and launches by span, through the trace's launch calls; idle
seconds by span; the device time outside every forward or without a
launch record); the six span metrics of each ``on`` window; and the
host-ops window's idle by host operation.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402
from torch.profiler import record_function  # noqa: E402

from bench import harness, span_trace, tracing, traffic  # noqa: E402
from bench.run import _environment  # noqa: E402
from repro_torch import spans  # noqa: E402

KINDS = ("on", "off", "untraced")


def _card(dev) -> str:
    if dev.type != "cuda":
        return "cpu"
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.split("\n")[0].strip()
    except OSError:
        limit = "unknown"
    return f"{torch.cuda.get_device_name(dev)}, power limit {limit}"


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _loop(call, sched, first: int, n: int, in_flight: int, dev) -> float:
    """Requests ``first`` .. ``first + n - 1`` in the closed loop; returns
    the seconds from the first call to the card finishing the last."""
    pending: collections.deque = collections.deque()
    _sync(dev)
    t0 = time.perf_counter()
    for j in range(first, first + n):
        call(sched[j])
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
            while len(pending) >= in_flight:
                pending.popleft().synchronize()
    _sync(dev)
    return time.perf_counter() - t0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)
    _environment()  # the benchmark's cache paths, under build/bench

    dev = torch.device(args.device)
    cell = harness.load_cell(args.workload)
    prog = cell.program
    a = prog.arch(cell.cfg)
    if dev.type == "cuda":
        from repro_torch.kernels import build

        build.build_all(prog.KERNELS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed % 2**64)
    params = prog.draw_params(a, gen, dev)
    pools = prog.draw_pools(a, harness.TEXT_POOL, harness.IMAGE_POOL, gen,
                            dev, cell.cfg.get("image_token_index"))
    sched = traffic.Schedule(cell.mix, cell.cfg, args.seed,
                             harness.TEXT_POOL, harness.IMAGE_POOL)

    def call(r):
        return prog.run(params, prog.batch(pools, r.n_image, r.n_text,
                                           r.image_offset, r.text_offset), a)

    for r in sched.first_cycle():  # warm-up: each of the mix's shapes once
        call(r)
    _sync(dev)

    gc_s, t_gc = [0.0], [0.0]

    def collecting(phase, info):
        if phase == "start":
            t_gc[0] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - t_gc[0]

    gc.callbacks.append(collecting)
    n, in_flight = cell.mix["trace_requests"], sched.in_flight
    rates = {k: [] for k in KINDS}
    collected = {k: [] for k in KINDS}
    table, metrics = None, {m: [] for m in span_trace.METRICS}
    first = 0
    for rnd in range(args.rounds):
        for kind in KINDS[rnd % 3:] + KINDS[:rnd % 3]:
            positions = sum(sched[j].positions
                            for j in range(first, first + n))
            # the last window's reduction leaves garbage: collect it here,
            # not inside the next window
            gc.collect()
            if kind == "untraced":
                gc_s[0] = 0.0
                rates[kind].append(positions / _loop(
                    call, sched, first, n, in_flight, dev))
                collected[kind].append(gc_s[0])
                first += n
                continue
            prof = harness._profile(torch, dev, host_ops=False)
            with prof:
                _sync(dev)
                w0 = time.time_ns()
                if kind == "on":
                    spans.enable()
                gc_s[0] = 0.0
                seconds = _loop(call, sched, first, n, in_flight, dev)
                collected[kind].append(gc_s[0])
                w1 = time.time_ns()
                spans.disable()
                records = spans.take()
            rates[kind].append(positions / seconds)
            first += n
            if kind == "on":
                t = span_trace.by_span(span_trace.events_of(prof), records,
                                       (w0, w1))
                for m, read in span_trace.METRICS.items():
                    metrics[m].append(read(t))
                table = t if table is None else span_trace.add(table, t)

    # the host-ops window: idle by host operation
    n_attr = cell.mix.get("attribution_requests", 0)
    host_ops = {}
    if n_attr:
        prof = harness._profile(torch, dev, host_ops=True)
        with prof:
            with record_function(tracing.WINDOW):
                seconds = _loop(call, sched, first, n_attr, in_flight, dev)
        reduced = tracing.from_profiler(prof)
        host_ops = {
            "tokens_per_s": sum(sched[j].positions for j in range(
                first, first + n_attr)) / seconds,
            "idle_gaps": reduced.top(reduced.idle_by_host_op) if reduced
            else []}

    lost = sum(table.device_s(k) for k in (span_trace.OUTSIDE,
                                           span_trace.UNLAUNCHED))
    total = sum(s for s, _ in table.device.values())
    def cost(kind):
        return [100.0 * (1.0 - x / off)
                for x, off in zip(rates[kind], rates["off"])]

    out = {
        "workload": args.workload, "seed": args.seed, "card": _card(dev),
        "requests_a_window": n, "rates": rates,
        "median_rates": {k: statistics.median(v) for k, v in rates.items()},
        "gc_s": collected, "spans_on_cost_pct": cost("on"),
        "device_by_span": sorted(([k, s, c] for k, (s, c) in
                                  table.device.items()),
                                 key=lambda row: -row[1]),
        "device_s": total, "device_s_outside_forwards": lost,
        "busy_s": table.busy_s, "window_s": table.window_s,
        "idle_by_span": sorted(table.idle.items(), key=lambda kv: -kv[1]),
        "idle_s": sum(table.idle.values()),
        "idle_s_inside_forwards": table.dispatch_idle_s,
        "metrics": metrics, "host_ops": host_ops,
    }
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
