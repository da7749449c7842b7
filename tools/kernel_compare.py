#!/usr/bin/env python3
"""Two or more versions of the fxp_layer and SVM kernels on one card, on the
same inputs, in turns: torch.profiler device ms, and whether their outputs
are bit-equal (to each other and to the plain version for fxp_layer).

    python3 tools/kernel_compare.py parent=path/to/old/csrc [other=...]

Each ``name=dir`` is a copy of ``src/repro_torch/kernels/csrc`` (for example
the parent commit's, unpacked with ``git archive`` into the git-ignored
``build/``); the repository's own sources are ``new``.  The libraries build
under ``build/kernel_compare/<name>/``.  Each shape is timed in the order
v1, v2, ..., new, new, ..., v2, v1 (two readings a version), so a drift of
the card's clock during the run shows as a spread, not as a difference.
Shapes: the logistic head (561 x 6) at 3089 and 65536 rows and every
container width, the SVM decision stage (300 x 6, 300 x 10), an MLP's last
layer (64 x 6), a serving round's 64 rows and one row, the exact sigmoid,
and a 561 x 64 layer (the wide route); the SVM fleet of path D (4 D5 rbf
SVMs at fxp32) at 64, 3298 and 65536 rows, 2 D6 rbf SVMs at fxp16, and the
single-model kernel at the D6 (fxp16) and D5 (fxp32) rbf shapes.  Inputs are
seeded random integers.  Exits non-zero if any two versions differ.  Needs
one NVIDIA GPU and ``nvcc``; the last line is the card's name and power
limit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tools"))

OUT = os.path.join(ROOT, "build", "kernel_compare")
LIBS = ("fxp_layer", "fxp_svm_fleet", "fxp_svm_model")
# (bits, rows, K, N, activation)
LAYERS = ((16, 3089, 561, 6, "none"), (16, 65536, 561, 6, "none"),
          (8, 3089, 561, 6, "none"), (8, 65536, 561, 6, "none"),
          (32, 3089, 561, 6, "none"), (32, 65536, 561, 6, "none"),
          (16, 3089, 300, 6, "none"), (16, 65536, 300, 6, "none"),
          (16, 3089, 300, 10, "none"), (16, 3089, 64, 6, "none"),
          (16, 64, 561, 6, "none"), (16, 1, 561, 6, "none"),
          (16, 3089, 561, 6, "exact"), (16, 3089, 561, 64, "exact"))
# (what, library, bits, E, F, S, C, batches)
SVMS = (("fleet D5 rbf fxp32 E=4", "fxp_svm_fleet", 32, 4, 8, 300, 10,
         (64, 3298, 65536)),
        ("fleet D6 rbf fxp16 E=2", "fxp_svm_fleet", 16, 2, 561, 300, 6,
         (64, 3089)),
        ("model D6 rbf fxp16", "fxp_svm_model", 16, 1, 561, 300, 6,
         (3089, 65536)),
        ("model D5 rbf fxp32", "fxp_svm_model", 32, 1, 8, 300, 10, (3298,)))


def _build(versions, nvcc):
    procs = []
    for name, csrc in versions.items():
        os.makedirs(os.path.join(OUT, name), exist_ok=True)
        for lib in LIBS:
            so = os.path.join(OUT, name, f"lib{lib}.so")
            cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-o", so, os.path.join(csrc, f"{lib}.cu")]
            procs.append((name, lib, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    fns = {}
    for name, lib, so, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name} {lib}:\n{out}")
        if lib == "fxp_layer":
            fn = ctypes.CDLL(so).fxp_layer_launch
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                           + [ctypes.c_void_p] * 2)
            fn.restype = ctypes.c_int
        else:
            import svm_ablation
            fn = svm_ablation._bind(so, lib)
        fns[(name, lib)] = fn
    return fns


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_compare: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import fixedpoint as fxp
    from repro_torch.kernels import build, fxp_layer, fxp_model
    from repro_torch.kernels.fxp_layer import epilogue_params

    versions = dict(arg.split("=", 1) for arg in sys.argv[1:])
    versions["new"] = os.path.join(ROOT, "src", "repro_torch", "kernels",
                                   "csrc")
    names = tuple(versions)
    order = names + names[::-1]
    fns = _build(versions, build.nvcc_path())
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.RandomState(0)

    def report(what, calls, outs, want=None):
        times = {n: [] for n in names}
        for n in order:
            calls[n]()
            torch.cuda.synchronize()
            times[n].append(cs.device_ms(torch, calls[n], 20))
        ok = all(torch.equal(outs[names[0]], outs[n]) for n in names)
        ok = ok and (want is None or torch.equal(outs["new"], want))
        first, new = np.mean(times[names[0]]), np.mean(times["new"])
        print(f"{what:40s} " + "  ".join(
            f"{n} {times[n][0]:.4f}/{times[n][1]:.4f}" for n in names)
            + f"  {names[0]}/new x{first / new:.2f}  "
            + ("bit-equal" if ok else "DIFFER"), flush=True)
        return ok

    bad = 0
    for bits, m, k, n, act in LAYERS:
        fmt = fxp.FxpFormat(bits, bits - 6)
        shift = cs._mid_shift(bits, k)
        a, b = (torch.from_numpy(cs._ints(rng, s, bits, "mid")).cuda()
                for s in ((m, k), (k, n)))
        bias = torch.from_numpy(cs._ints(rng, (n,), bits, "full")).cuda()
        epi = epilogue_params(shift, fmt, act)
        outs = {v: torch.empty((m, n), dtype=a.dtype, device="cuda")
                for v in names}
        calls = {v: (lambda v=v: fns[(v, "fxp_layer")](
            a.data_ptr(), b.data_ptr(), bias.data_ptr(), outs[v].data_ptr(),
            m, k, n, bits, epi.ctypes.data, stream)) for v in names}
        want = fxp_layer.fxp_layer_plain(a, b, bias, fmt, act, shift)
        bad += not report(f"fxp_layer w{bits} {m}x{k}x{n} {act}", calls, outs,
                          want)
    for what, lib, bits, e, f, s, c, batches in SVMS:
        for m in batches:
            x, sv, dual, icept = (
                torch.from_numpy(cs._ints(rng, shape, bits, "mid")).cuda()
                for shape in ((e, m, f), (e, s, f), (e, s, c), (e, c)))
            params = tuple(
                (fxp.FxpFormat(bits, bits - 6), fxp.FxpFormat(bits, bits - 7),
                 int(rng.randint(1, 2 ** ((bits - 6) // 2))),
                 int(rng.randint(-(2 ** (bits - 6)), 2 ** (bits - 6))),
                 1 + i % 3, bits // 2) for i in range(e))
            table = fxp_model.svm_fleet_table(params, x.device)
            fmt, out_fmt, qg, qc, degree, dec = params[0]
            epi_k = epilogue_params(fmt.frac_bits, fmt, "none")
            epi_o = epilogue_params(dec, out_fmt, "none")
            outs = {v: torch.empty((e, m, c), dtype=x.dtype, device="cuda")
                    for v in names}

            def launcher(v):
                fn, o = fns[(v, lib)], outs[v]
                if lib == "fxp_svm_fleet":
                    return lambda: fn(x.data_ptr(), sv.data_ptr(),
                                      dual.data_ptr(), icept.data_ptr(),
                                      o.data_ptr(), m, f, s, c, e, bits, 1,
                                      table.data_ptr(), stream)
                return lambda: fn(x.data_ptr(), sv.data_ptr(),
                                  dual.data_ptr(), icept.data_ptr(),
                                  o.data_ptr(), m, f, s, c, bits,
                                  epi_k.ctypes.data, epi_o.ctypes.data, 1,
                                  qg, qc, degree, stream)

            calls = {v: launcher(v) for v in names}
            bad += not report(f"{what} {m}", calls, outs)
    print(cs.smi("name,power.limit"))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
