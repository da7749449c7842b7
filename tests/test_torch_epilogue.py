"""The CUDA kernels' integer epilogue on the host.

``csrc/fxp_common.cuh`` — the requantize, saturating bias add and sigmoid
code both CUDA kernels run per output — compiles for the host as well.  This
test builds it with the system C++ compiler into a small library and holds
it, element by element, against the plain PyTorch epilogue (which the other
tests hold against the reference package): every container width, Q0.m and
Qn.0 formats, every activation, shifts 0 to 31, int32 accumulators at their
extremes and saturated biases.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.core.activations import pwl4_consts
from repro_torch.core.fixedpoint import FxpFormat
from repro_torch.kernels import fxp_layer

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src", "repro_torch", "kernels", "csrc")
HARNESS = r"""
#include "fxp_common.cuh"
extern "C" void apply(const int32_t* acc, const int32_t* bias, int n,
                      const long long* epi, int32_t* out) {
  const fxp::Epilogue e = fxp::epilogue_from(epi);
  for (int i = 0; i < n; ++i)
    out[i] = fxp::layer_epilogue((uint32_t)acc[i], bias[i], e);
}
"""
FORMATS = [(8, 0), (8, 2), (8, 7), (16, 0), (16, 4), (16, 15), (32, 0),
           (32, 10), (32, 31)]


@pytest.fixture(scope="module")
def host_epilogue(tmp_path_factory):
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler on this host")
    d = tmp_path_factory.mktemp("epilogue")
    src, lib = d / "harness.cpp", d / "libepilogue.so"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-std=c++17", "-O2", "-Wall", "-Werror", "-shared",
                    "-fPIC", "-I", CSRC, "-o", str(lib), str(src)],
                   check=True, capture_output=True, timeout=120)
    fn = ctypes.CDLL(str(lib)).apply
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = None
    return fn


def _inputs(fmt, seed):
    """Accumulators at the int32 extremes and at random, biases at the
    container's extremes and at random, plus every sigmoid breakpoint
    (+-1, both signs) with a zero bias, which shift 0 hits exactly."""
    rng = np.random.RandomState(seed)
    i32 = np.iinfo(np.int32)
    acc = np.concatenate([
        [i32.min, i32.min + 1, -1, 0, 1, i32.max - 1, i32.max],
        rng.randint(i32.min, i32.max, 3000, dtype=np.int64),
        rng.randint(-(1 << 20), 1 << 20, 3000),
        rng.randint(-(1 << 12), 1 << 12, 3000)])
    bias = rng.randint(fmt.qmin, fmt.qmax + 1, acc.shape, dtype=np.int64)
    bias[: acc.size // 8] = fmt.qmax
    bias[acc.size // 8: acc.size // 4] = fmt.qmin
    marks = np.array([v for v in pwl4_consts(fmt).values()] + [2 * fmt.scale])
    marks = np.concatenate([marks - 1, marks, marks + 1])
    marks = np.clip(np.concatenate([marks, -marks]), fmt.qmin, fmt.qmax)
    acc = np.concatenate([acc, marks]).astype(np.int32)
    bias = np.concatenate([bias, np.zeros(marks.size, np.int64)])
    return acc, bias.astype(np.int32)


@pytest.mark.parametrize("activation", fxp_layer.LAYER_ACTIVATIONS)
@pytest.mark.parametrize("bits,frac", FORMATS,
                         ids=[f"w{b}m{m}" for b, m in FORMATS])
def test_cuda_epilogue_matches_plain(host_epilogue, bits, frac, activation):
    fmt = FxpFormat(bits, frac)
    acc, bias = _inputs(fmt, seed=bits * 64 + frac)
    for shift in sorted({0, 1, frac, bits - 1, 31}):
        epi = np.ascontiguousarray(
            fxp_layer.epilogue_params(shift, fmt, activation))
        got = np.empty_like(acc)
        host_epilogue(acc.ctypes.data, bias.ctypes.data, acc.size,
                      epi.ctypes.data, got.ctypes.data)
        want = fxp_layer.epilogue_plain(
            torch.from_numpy(acc), torch.from_numpy(bias).to(fmt.dtype), fmt,
            activation, shift)
        np.testing.assert_array_equal(got, want.to(torch.int32).numpy(),
                                      err_msg=f"shift {shift}")
