#!/usr/bin/env python3
"""Runs one cell of ``BENCHMARK.json`` once on this machine's card and
prints the result as the last line of standard output::

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout; ``src/`` (the port, ``repro_torch``) is put
on the path here.  Every build and kernel cache the program writes goes
under ``build/`` inside the checkout, at fixed paths.  Exits non-zero
with no result line when no card (or too few) is present, and when JAX or
the JAX package was loaded by the time the window closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
CACHE = ROOT / "build" / "bench"


def _environment() -> None:
    for var, sub in (("REPRO_TORCH_TUNE_CACHE", "tune_cache.json"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(CACHE / sub)
    # bench/ itself off the path: its folders are not top-level modules
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    _environment()
    import torch

    from bench import harness

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in manifest["workloads"]}.get(
        args.workload)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, manifest=manifest)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda")
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, t in result["checks"].items():
        print(f"check {name} {t['value']} limit {t['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
