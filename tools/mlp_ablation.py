#!/usr/bin/env python3
"""Where the MLP megakernel's time goes on the card: device time of
``fxp_mlp_model`` with one phase of its tensor-core body taken out.

    python3 tools/mlp_ablation.py

Builds copies of ``src/repro_torch/kernels/csrc`` under the git-ignored
``build/mlp_ablation/``, each with one phase of ``fxp_mlp_body.cuh``
removed (its results are wrong, which is the point), and times every copy
on the same inputs with torch.profiler device time:

* ``base``: the kernel as it is (held bit for bit against the plain
  version first);
* ``no_mma``: the k loop loads its fragments but issues no ``mma.sync``;
* ``no_epilogue``: the layer epilogue is a bias add (no requantize, no
  saturation, no sigmoid);
* ``no_unpack``: the input tile is copied in but not unpacked into the
  byte planes.

The difference to ``base`` is the phase's share of the kernel's time, at
the D6 MLP's widths (561 -> 64 -> 6) and 3089 and 65536 rows, fxp16 with
the exact sigmoid and with none, and 8 bits with the exact sigmoid.  Needs
one NVIDIA GPU and ``nvcc``; the last line is the card's name and power
limit.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
OUT = os.path.join(ROOT, "build", "mlp_ablation")
# (text in fxp_mlp_body.cuh, its replacement) per variant
VARIANTS = {
    "base": [],
    "no_mma": [("    mma_run(f, acc);\n    f = next;\n", "    f = next;\n"),
               ("  }\n  mma_run(f, acc);\n}", "  }\n  acc[0][0] += f.b[0];\n}")],
    "no_epilogue": [("v[u] = (T)layer_epilogue(a[u], bv[u], e);",
                     "v[u] = (T)(a[u] + bv[u]);"),
                    ("store(r, c, (T)layer_epilogue(a, bias[c], e));",
                     "store(r, c, (T)(a + bias[c]));")],
    "no_unpack": [("    mlp_unpack<T>(region", "    if (M < 0) mlp_unpack<T>(region")],
}
CASES = ((16, "exact"), (16, "none"), (8, "exact"))
BATCHES = (3089, 65536)


def _build(name, patches, nvcc):
    out = os.path.join(OUT, name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(CSRC, out)
    body = os.path.join(out, "fxp_mlp_body.cuh")
    text = open(body).read()
    for old, new in patches:
        if old not in text:
            raise RuntimeError(f"{name}: the body no longer holds {old!r}")
        text = text.replace(old, new)
    open(body, "w").write(text)
    lib = os.path.join(out, "libfxp_mlp_model.so")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib,
           os.path.join(out, "fxp_mlp_model.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mlp_ablation: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import fixedpoint as fxp
    from repro_torch.kernels import build, fxp_model

    procs = {n: _build(n, p, build.nvcc_path()) for n, p in VARIANTS.items()}
    fns = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            print(f"nvcc failed for {name}:\n{out}", file=sys.stderr)
            return 1
        fn = ctypes.CDLL(lib).fxp_mlp_model_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    rng = np.random.RandomState(0)
    dims = (561, 64, 6)
    for bits, act in CASES:
        for m in BATCHES:
            fmt = fxp.FxpFormat(bits, bits - 6)
            x = torch.from_numpy(cs._ints(rng, (m, dims[0]), bits, "mid"))
            ws = [torch.from_numpy(cs._ints(rng, (i, o), bits, "mid"))
                  for i, o in zip(dims, dims[1:])]
            bs = [torch.from_numpy(cs._ints(rng, (o,), bits, "full"))
                  for o in dims[1:]]
            x, ws, bs = x.cuda(), [w.cuda() for w in ws], [b.cuda() for b in bs]
            sched = ((7, fmt, act), (3, fmt, "none"))
            out = torch.empty((m, dims[-1]), dtype=x.dtype, device="cuda")
            epis = fxp_model._schedule_params(sched)
            c_dims = (ctypes.c_int * 3)(*dims)
            c_ws = (ctypes.c_void_p * 2)(*[w.data_ptr() for w in ws])
            c_bs = (ctypes.c_void_p * 2)(*[b.data_ptr() for b in bs])
            stream = torch.cuda.current_stream().cuda_stream
            times = []
            for name, fn in fns.items():
                def call(fn=fn):
                    err = fn(x.data_ptr(), out.data_ptr(), m, 2, c_dims, c_ws,
                             c_bs, epis.ctypes.data, bits, stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                call()
                torch.cuda.synchronize()
                if name == "base" and not torch.equal(
                        out, fxp_model.fxp_mlp_model_plain(x, ws, bs, sched)):
                    raise AssertionError("the base kernel differs from the "
                                         "plain version")
                times.append(f"{name} {cs.device_ms(torch, call, 20):.4f}")
            print(f"w{bits} {act:5s} {m:6d} rows, device ms: "
                  + ", ".join(times), flush=True)
    print(cs.smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
