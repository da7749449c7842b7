#!/usr/bin/env python3
"""Where the kernel-SVM cluster body's time goes on the card: device time of
``fxp_svm_fleet`` and ``fxp_svm_model`` with one phase of the body taken out.

    python3 tools/svm_ablation.py

Builds copies of ``src/repro_torch/kernels/csrc`` under the git-ignored
``build/svm_ablation/``, each with one phase of ``fxp_svm_body.cuh``
removed (its results are wrong, which is the point), and times every copy
on the same inputs with torch.profiler device time:

* ``base``: the body as it is (held bit for bit against the plain version
  first);
* ``no_dot``: each 32-feature staging step multiplies one feature instead
  of 32 (the staging, its barriers and the norms stay);
* ``no_algebra``: the kernel value is the requantized dot (no ``qexp``, no
  ``qpow_int``, no ``qmul``/``qadd`` around them);
* ``no_decision``: the decision stage stages the duals but multiplies none
  (each block's partial is 0);
* ``no_cluster_sum``: each rank reads only its own partial, not the
  cluster's through distributed shared memory (the cluster barriers stay).

The difference to ``base`` is the phase's share of the kernel's time, at
path D's SVM fleet (4 D5 rbf SVMs at fxp32: F 8, S 300, C 10) and at the D6
rbf SVM (fxp16: F 561, S 300, C 6, the single-model kernel), at 3089/3298
and 65536 rows, with random inputs from a seed.  Needs one NVIDIA GPU and
``nvcc``; the last line is the card's name and power limit.
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
OUT = os.path.join(ROOT, "build", "svm_ablation")
BODY = "fxp_svm_body.cuh"
# (source file, text in it, its replacement) per variant
VARIANTS = {
    "base": [],
    "no_dot": [(BODY, "for (int kk = 0; kk < kStep; ++kk) mac(kk);",
                "for (int kk = 0; kk < 1; ++kk) mac(kk);"),
               (BODY, "for (int kk = 0; kk < kn; ++kk) mac(kk);",
                "for (int kk = 0; kk < 1; ++kk) mac(kk);")],
    "no_algebra": [(BODY, "      int32_t k;\n      if (!rbf) {",
                    "      int32_t k = dot;\n      if (M < 0) {"),
                   (BODY, "      } else {\n        const int32_t d2 =",
                    "      } else if (M < -1) {\n        const int32_t d2 =")],
    "no_decision": [(BODY, "for (; j + 4 <= n_local; j += 4) {",
                     "for (; j + 4 <= 0; j += 4) {"),
                    (BODY, "for (; j < n_local; ++j) a0 +=",
                     "for (; j < 0; ++j) a0 +=")],
    "no_cluster_sum": [
        (BODY, "if (g < G) a += cluster.map_shared_rank(part, g)[item];",
         "if (g == 0) a += part[item];")],
}
LIBS = ("fxp_svm_fleet", "fxp_svm_model")
# (what, library, bits, E, F, S, C) at each batch
CASES = (("D5 rbf fxp32 E=4 fleet", "fxp_svm_fleet", 32, 4, 8, 300, 10),
         ("D6 rbf fxp16 model", "fxp_svm_model", 16, 1, 561, 300, 6))
BATCHES = {"fxp_svm_fleet": (3298, 65536), "fxp_svm_model": (3089, 65536)}


def _build(name, patches, nvcc):
    out = os.path.join(OUT, name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(CSRC, out)
    for source, old, new in patches:
        path = os.path.join(out, source)
        text = open(path).read()
        if old not in text:
            raise RuntimeError(f"{name}: {source} no longer holds {old!r}")
        open(path, "w").write(text.replace(old, new))
    procs = {}
    for lib in LIBS:
        so = os.path.join(out, f"lib{lib}.so")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", so,
               os.path.join(out, f"{lib}.cu")]
        procs[lib] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      so)
    return procs


def _bind(so, lib):
    if lib == "fxp_svm_fleet":
        fn = ctypes.CDLL(so).fxp_svm_fleet_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p] * 2)
    else:
        fn = ctypes.CDLL(so).fxp_svm_model_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("svm_ablation: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import fixedpoint as fxp
    from repro_torch.kernels import build, fxp_model
    from repro_torch.kernels.fxp_layer import epilogue_params

    nvcc = build.nvcc_path()
    procs = {n: _build(n, p, nvcc) for n, p in VARIANTS.items()}
    fns = {}
    for name, libs in procs.items():
        for lib, (proc, so) in libs.items():
            out, _ = proc.communicate()
            if proc.returncode:
                print(f"nvcc failed for {name} {lib}:\n{out}",
                      file=sys.stderr)
                return 1
            fns[(name, lib)] = _bind(so, lib)
    rng = np.random.RandomState(0)
    stream = torch.cuda.current_stream().cuda_stream
    for what, lib, bits, e, f, s, c in CASES:
        for m in BATCHES[lib]:
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
            out = torch.empty((e, m, c), dtype=x.dtype, device="cuda")
            if lib == "fxp_svm_fleet":
                want = fxp_model.fxp_svm_fleet_plain(x, sv, dual, icept,
                                                     "rbf", params)
            else:
                want = fxp_model.fxp_svm_model_plain(
                    x[0], sv[0], dual[0], icept[0], "rbf", *params[0])[None]
            times = []
            for name in VARIANTS:
                fn = fns[(name, lib)]

                def call(fn=fn, name=name):
                    if lib == "fxp_svm_fleet":
                        err = fn(x.data_ptr(), sv.data_ptr(), dual.data_ptr(),
                                 icept.data_ptr(), out.data_ptr(), m, f, s, c,
                                 e, bits, 1, table.data_ptr(), stream)
                    else:
                        err = fn(x.data_ptr(), sv.data_ptr(), dual.data_ptr(),
                                 icept.data_ptr(), out.data_ptr(), m, f, s, c,
                                 bits, epi_k.ctypes.data, epi_o.ctypes.data,
                                 1, qg, qc, degree, stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                call()
                torch.cuda.synchronize()
                if name == "base" and not torch.equal(out, want):
                    raise AssertionError(f"{what}: the base kernel differs "
                                         f"from the plain version")
                times.append(f"{name} {cs.device_ms(torch, call, 20):.4f}")
            print(f"{what} {m:6d} rows, device ms: " + ", ".join(times),
                  flush=True)
    print(cs.smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
