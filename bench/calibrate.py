#!/usr/bin/env python3
"""Reads the output check's numbers on many seeds, with the control's
beside them, in one process, to set a cell's limits from::

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--requests N]

For each seed: the cell's set-up and a window of the first N requests of
its schedule (default: one cycle, which holds every checked request) at
the cell's own load, then the check; for a control seed also the control
(the reference with float8 products) against the reference on the same
rows.  Prints one JSON line a seed and a summary line: the largest
program reading (the limit's lower reading) and the smallest control
reading (its upper one).  Runs on the card; not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path[:0] = [str(HERE.parent / "src"), str(HERE.parent)]

from bench import run as bench_run  # noqa: E402  (the run's environment)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--requests", type=int, default=0)
    args = p.parse_args(argv)
    bench_run._environment()
    import torch

    from bench import check, harness

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    n = args.requests or len(harness.traffic.shapes(cell.mix, cell.cfg))
    program, control = [], []
    for seed in seeds + sorted(controls - set(seeds)):
        res = harness.run(cell, seed, 0.0, False, "cuda", stop_after=n,
                          control=seed in controls)
        readings = {k: t["value"] for k, t in res["checks"].items()}
        row = {"seed": seed, "program": readings,
               "control": res.get("control")}
        print(json.dumps(row), flush=True)
        if seed in seeds:
            program.append(readings)
        if seed in controls:
            control.append(res["control"])
        torch.cuda.empty_cache()
    summary = {k: {"program_max": max(r[k] for r in program),
                   "control_min": (min(r[k] for r in control)
                                   if control else None)}
               for k in check.NUMBERS}
    print(json.dumps({"summary": summary, "seeds": len(program),
                      "control_seeds": len(control)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
