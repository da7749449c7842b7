#!/usr/bin/env python3
"""Two or more versions of the port's kernels on one card, on the same
inputs, in turns: torch.profiler device ms, and whether their outputs are
bit-equal (to each other, and to the plain version where that is cheap).

    python3 tools/kernel_compare.py parent=path/to/old/csrc [other=...] \
        [--only=layer,svm,qmatmul,tree,mlp]

Each ``name=dir`` is a copy of ``src/repro_torch/kernels/csrc`` (for example
the parent commit's, unpacked with ``git archive`` into the git-ignored
``build/``); the repository's own sources are ``new``.  The libraries build
under ``build/kernel_compare/<name>/``.  Each shape is timed in the order
v1, v2, ..., new, new, ..., v2, v1 (two readings a version), so a drift of
the card's clock during the run shows as a spread, not as a difference.
``--only`` keeps the named sections.  Sections:

* ``layer``: fxp_layer at the logistic head (561 x 6) at 3089 and 65536
  rows and every container width, the SVM decision stage (300 x 6,
  300 x 10), an MLP's last layer (64 x 6), a serving round's 64 rows and
  one row, the exact sigmoid, and the wide route (561 x 64, the per-layer
  MLP's first layer) at every width and 3089 and 65536 rows;
* ``svm``: the SVM fleet of path D (4 D5 rbf SVMs at fxp32) at 64, 3298 and
  65536 rows, 2 D6 rbf SVMs at fxp16, and the single-model kernel at the D6
  (fxp16) and D5 (fxp32) rbf shapes;
* ``qmatmul``: fxp_qmatmul at D6 (561 x 300) and D5 (8 x 300), every
  width, 3089 and 65536 rows;
* ``tree``: tree_ensemble with the D6 tree (the port's CART, depth 12) on
  float32 rows and on each integer container, 3089 and 65536 rows (a
  version whose kernel takes float32 rows only is given the container cast
  to float32, which its lowering did in a launch of its own);
* ``mlp``: fxp_mlp_model (561 -> 64 -> 6 with the exact sigmoid at fxp16
  and 8 bits, fxp32) and fxp_mlp_fleet (8 models, fxp16) at 3089 and 65536
  rows, through the port's own wrappers bound to each version's library.

Inputs are seeded random integers (the tree's rows: the D6 test split,
tiled).  Exits non-zero if any two versions differ.  Needs one NVIDIA GPU
and ``nvcc``; the last line is the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import types

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tools"))

OUT = os.path.join(ROOT, "build", "kernel_compare")
LIBS = ("fxp_layer", "fxp_svm_fleet", "fxp_svm_model", "fxp_qmatmul",
        "tree_ensemble", "fxp_mlp_model", "fxp_mlp_fleet")
SECTIONS = ("layer", "svm", "qmatmul", "tree", "mlp")
# (bits, rows, K, N, activation)
LAYERS = ((16, 3089, 561, 6, "none"), (16, 65536, 561, 6, "none"),
          (8, 3089, 561, 6, "none"), (8, 65536, 561, 6, "none"),
          (32, 3089, 561, 6, "none"), (32, 65536, 561, 6, "none"),
          (16, 3089, 300, 6, "none"), (16, 65536, 300, 6, "none"),
          (16, 3089, 300, 10, "none"), (16, 3089, 64, 6, "none"),
          (16, 64, 561, 6, "none"), (16, 1, 561, 6, "none"),
          (16, 3089, 561, 6, "exact"), (16, 3089, 561, 64, "exact"),
          (16, 3089, 561, 64, "none"), (16, 65536, 561, 64, "none"),
          (8, 3089, 561, 64, "none"), (8, 65536, 561, 64, "none"),
          (32, 3089, 561, 64, "none"), (32, 65536, 561, 64, "none"))
# fxp_qmatmul: (bits, rows, K, N)
QMATMULS = tuple((bits, m, k, 300) for k in (561, 8) for bits in (16, 8, 32)
                 for m in (3089, 65536))
TREE_BATCHES = (3089, 65536)
# fxp_mlp_model: (bits, rows, hidden activation); fxp_mlp_fleet: 8 models
MLPS = ((16, 3089, "exact"), (16, 65536, "exact"), (8, 3089, "exact"),
        (32, 3089, "exact"))
MLP_FLEETS = ((16, 3089), (16, 65536))
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
        elif lib == "fxp_qmatmul":
            fn = ctypes.CDLL(so).fxp_qmatmul_launch
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        elif lib == "tree_ensemble":
            fn = ctypes.CDLL(so).tree_ensemble_launch
            fn.restype = ctypes.c_int
            with open(os.path.join(versions[name], "tree_ensemble.cu")) as f:
                fn.packed = "const void* table" in f.read()
            if fn.packed:  # (x, bits, table, out, M, F, nodes, smem, stream)
                fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_void_p] + [ctypes.c_int] * 4 + [
                                   ctypes.c_void_p]
            else:  # float32 rows and five node arrays
                fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
                    ctypes.c_void_p]
        elif lib in ("fxp_mlp_model", "fxp_mlp_fleet"):
            fn = ctypes.CDLL(so)  # bound by the port's own wrapper
        else:
            import svm_ablation
            fn = svm_ablation._bind(so, lib)
        fns[(name, lib)] = fn
    return fns


def _qmatmul_section(torch, cs, fxp, fns, names, report, rng, stream):
    from repro_torch.kernels import fxp_qmatmul

    bad = 0
    for bits, m, k, n in QMATMULS:
        fmt = fxp.FxpFormat(bits, bits - 6)
        a, b = (torch.from_numpy(cs._ints(rng, s, bits, "mid")).cuda()
                for s in ((m, k), (k, n)))
        outs = {v: torch.empty((m, n), dtype=a.dtype, device="cuda")
                for v in names}
        calls = {v: (lambda v=v: fns[(v, "fxp_qmatmul")](
            a.data_ptr(), b.data_ptr(), outs[v].data_ptr(), m, k, n, bits,
            fmt.frac_bits, stream)) for v in names}
        want = fxp_qmatmul.fxp_qmatmul_plain(a, b, fmt)
        bad += not report(f"fxp_qmatmul w{bits} {m}x{k}x{n}", calls, outs,
                          want)
    return bad


def _tree_section(torch, fxp, fns, names, report, stream):
    from repro_torch import models
    from repro_torch.data import load_dataset
    from repro_torch.kernels import tree_ensemble

    d6 = load_dataset("D6")
    tree = models.train_decision_tree(d6.x_train, d6.y_train, d6.n_classes,
                                      max_depth=12).tree
    rows = np.resize(d6.x_test, (max(TREE_BATCHES), d6.x_test.shape[1]))
    bad = 0
    for tag, fmt in (("flt", None), ("fxp16", fxp.FxpFormat(16, 8)),
                     ("auto8", fxp.FxpFormat(8, 4)),
                     ("fxp32", fxp.FxpFormat(32, 16))):
        t = tree if fmt is None else tree.quantized(fmt)
        table = tree_ensemble.packed_operands(t, torch.device("cuda"))
        arrays = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (
            t.feature.astype(np.int32), t.threshold.astype(np.float32),
            t.left.astype(np.int32), t.right.astype(np.int32),
            t.leaf_class.astype(np.int32))]
        for m in TREE_BATCHES:
            x = torch.from_numpy(rows[:m]).cuda()
            if fmt is not None:
                x = fxp.quantize(x, fmt)
            xf = x.to(torch.float32)
            bits = tree_ensemble.ROW_DTYPES[x.dtype]
            outs = {v: torch.empty((m,), dtype=torch.int32, device="cuda")
                    for v in names}

            def launcher(v):
                fn, o = fns[(v, "tree_ensemble")], outs[v]
                if fn.packed:
                    return lambda: fn(x.data_ptr(), bits, table.data_ptr(),
                                      o.data_ptr(), m, t.n_features,
                                      t.n_nodes, 1, stream)
                return lambda: fn(xf.data_ptr(), *(a.data_ptr()
                                                  for a in arrays),
                                  o.data_ptr(), m, t.n_features, t.n_nodes,
                                  stream)

            calls = {v: launcher(v) for v in names}
            want = tree_ensemble.tree_ensemble_plain(t, x)
            bad += not report(f"tree_ensemble {tag} {m}", calls, outs, want)
    return bad


def _mlp_section(torch, cs, fxp, fns, names, report, rng):
    from repro_torch.kernels import fxp_model

    def bound(v):  # the port's wrappers, loading version v's libraries
        fxp_model.build = types.SimpleNamespace(
            load=lambda lib: fns[(v, lib)])

    own = fxp_model.build
    bad = 0
    try:
        for bits, m, act in MLPS:
            dims = (561, 64, 6)
            x = torch.from_numpy(cs._ints(rng, (m, 561), bits, "mid")).cuda()
            ws = [torch.from_numpy(cs._ints(rng, (i, o), bits, "mid")).cuda()
                  for i, o in zip(dims, dims[1:])]
            bs = [torch.from_numpy(cs._ints(rng, (o,), bits, "full")).cuda()
                  for o in dims[1:]]
            sched = ((cs._mid_shift(bits, 561), fxp.FxpFormat(bits, bits - 6),
                      act),
                     (cs._mid_shift(bits, 64), fxp.FxpFormat(bits, bits - 6),
                      "none"))
            outs = {}

            def call(v):
                bound(v)
                outs[v] = fxp_model.fxp_mlp_model_cuda(x, ws, bs, sched)

            calls = {v: (lambda v=v: call(v)) for v in names}
            want = fxp_model.fxp_mlp_model_plain(x, ws, bs, sched)
            bad += not report(f"fxp_mlp_model w{bits} {m} {act}", calls, outs,
                              want)
        for bits, m in MLP_FLEETS:
            e, dims = 8, (561, 64, 6)
            x = torch.from_numpy(cs._ints(rng, (e, m, 561), bits,
                                          "mid")).cuda()
            ws = [torch.from_numpy(cs._ints(rng, (e, i, o), bits,
                                            "mid")).cuda()
                  for i, o in zip(dims, dims[1:])]
            bs = [torch.from_numpy(cs._ints(rng, (e, o), bits, "full")).cuda()
                  for o in dims[1:]]
            sched = tuple(
                ((cs._mid_shift(bits, 561), fxp.FxpFormat(bits, bits - 6),
                  "exact"),
                 (cs._mid_shift(bits, 64), fxp.FxpFormat(bits, bits - 6),
                  "none")) for _ in range(e))
            outs = {}

            def call_fleet(v):
                bound(v)
                outs[v] = fxp_model.fxp_mlp_fleet_cuda(x, ws, bs, sched)

            calls = {v: (lambda v=v: call_fleet(v)) for v in names}
            bad += not report(f"fxp_mlp_fleet w{bits} E={e} {m}", calls, outs)
    finally:
        fxp_model.build = own
    return bad


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_compare: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import fixedpoint as fxp
    from repro_torch.kernels import build, fxp_layer, fxp_model
    from repro_torch.kernels.fxp_layer import epilogue_params

    only = [a for a in sys.argv[1:] if a.startswith("--only=")]
    sections = only[-1][len("--only="):].split(",") if only else SECTIONS
    if not set(sections) <= set(SECTIONS):
        print(f"kernel_compare: sections are {SECTIONS}", file=sys.stderr)
        return 2
    versions = dict(arg.split("=", 1) for arg in sys.argv[1:]
                    if not arg.startswith("--"))
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
    for bits, m, k, n, act in LAYERS if "layer" in sections else ():
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
    for what, lib, bits, e, f, s, c, batches in (
            SVMS if "svm" in sections else ()):
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
    if "qmatmul" in sections:
        bad += _qmatmul_section(torch, cs, fxp, fns, names, report, rng,
                                stream)
    if "tree" in sections:
        bad += _tree_section(torch, fxp, fns, names, report, stream)
    if "mlp" in sections:
        bad += _mlp_section(torch, cs, fxp, fns, names, report, rng)
    print(cs.smi("name,power.limit"))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
