"""The CUDA kernels' integer epilogue on the host.

``csrc/fxp_common.cuh`` — the requantize, saturating bias add and sigmoid
code both CUDA kernels run per output — compiles for the host as well.  This
test builds it with the system C++ compiler into a small library and holds
it, element by element, against the plain PyTorch epilogue (which the other
tests hold against the reference package): every container width, Q0.m and
Qn.0 formats, every activation, shifts 0 to 31, int32 accumulators at their
extremes and saturated biases.  The kernel SVM's elementwise helpers
(``qadd``, ``qsub``, ``qneg``, ``qmul``, ``qpow_int`` and the int64
sum-of-squares shift) are held the same way against
:mod:`repro_torch.core.fixedpoint` at the int8/16/32 edges.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.core.activations import pwl4_consts
from repro_torch.core import fixedpoint as tfx
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
OPS_HARNESS = r"""
#include "fxp_common.cuh"
extern "C" void elementwise(int op, const int32_t* a, const int32_t* b,
                            const long long* acc, int n, int p,
                            const long long* epi, int32_t* out) {
  const fxp::Epilogue e = fxp::epilogue_from(epi);
  for (int i = 0; i < n; ++i) {
    switch (op) {
      case 0: out[i] = fxp::qadd(a[i], b[i], e); break;
      case 1: out[i] = fxp::qsub(a[i], b[i], e); break;
      case 2: out[i] = fxp::qneg(a[i], e); break;
      case 3: out[i] = fxp::qmul(a[i], b[i], e); break;
      case 4: out[i] = fxp::qpow_int(a[i], p, e); break;
      default: out[i] = fxp::sumsq_shift((uint64_t)acc[i], e); break;
    }
  }
}
"""
FORMATS = [(8, 0), (8, 2), (8, 7), (16, 0), (16, 4), (16, 15), (32, 0),
           (32, 10), (32, 31)]


def _host_build(tmp_path_factory, name, source):
    """Compile ``source`` (which includes the CUDA headers) for the host."""
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler on this host")
    d = tmp_path_factory.mktemp(name)
    src, lib = d / "harness.cpp", d / f"lib{name}.so"
    src.write_text(source)
    subprocess.run([cxx, "-std=c++17", "-O2", "-Wall", "-Werror", "-shared",
                    "-fPIC", "-I", CSRC, "-o", str(lib), str(src)],
                   check=True, capture_output=True, timeout=120)
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def host_epilogue(tmp_path_factory):
    fn = _host_build(tmp_path_factory, "epilogue", HARNESS).apply
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


@pytest.fixture(scope="module")
def host_ops(tmp_path_factory):
    fn = _host_build(tmp_path_factory, "elementwise", OPS_HARNESS).elementwise
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = None

    def run(op, a, b, acc, fmt, p=0):
        epi = np.ascontiguousarray(
            fxp_layer.epilogue_params(fmt.frac_bits, fmt, "none"))
        out = np.empty(a.size, np.int32)
        fn(op, a.ctypes.data, b.ctypes.data, acc.ctypes.data, a.size, p,
           epi.ctypes.data, out.ctypes.data)
        return out

    return run


def _container_edges(fmt, seed, n=4000):
    """Container values: both extremes and their neighbours, -1/0/1, one_q,
    and random values, paired every way for the binary ops."""
    rng = np.random.RandomState(seed)
    marks = np.array([fmt.qmin, fmt.qmin + 1, -1, 0, 1, fmt.qmax - 1,
                      fmt.qmax, tfx.one_q(fmt), -tfx.one_q(fmt)])
    marks = np.clip(marks, fmt.qmin, fmt.qmax)
    a = np.concatenate([np.repeat(marks, marks.size),
                        rng.randint(fmt.qmin, fmt.qmax + 1, n, np.int64)])
    b = np.concatenate([np.tile(marks, marks.size),
                        rng.randint(fmt.qmin, fmt.qmax + 1, n, np.int64)])
    return a.astype(np.int32), b.astype(np.int32)


@pytest.mark.parametrize("bits,frac", FORMATS,
                         ids=[f"w{b}m{m}" for b, m in FORMATS])
def test_cuda_elementwise_helpers_match_plain(host_ops, bits, frac):
    fmt = tfx.FxpFormat(bits, frac)
    a, b = _container_edges(fmt, seed=bits * 64 + frac)
    ta, tb = (torch.from_numpy(v).to(fmt.dtype) for v in (a, b))
    none = np.zeros(a.size, np.int64)
    for op, want in ((0, tfx.qadd(ta, tb, fmt)), (1, tfx.qsub(ta, tb, fmt)),
                     (2, tfx.qneg(ta, fmt)), (3, tfx.qmul(ta, tb, fmt))):
        np.testing.assert_array_equal(host_ops(op, a, b, none, fmt),
                                      want.to(torch.int32).numpy(),
                                      err_msg=f"op {op}")
    for degree in range(5):
        np.testing.assert_array_equal(
            host_ops(4, a, b, none, fmt, degree),
            tfx.qpow_int(ta, degree, fmt).to(torch.int32).numpy(),
            err_msg=f"degree {degree}")
    # sums of squares: exact int64 sums of one container's squares, some
    # past int32 and past int64 (which wrap), and the int64 extremes
    rng = np.random.RandomState(frac)
    q = rng.randint(fmt.qmin, fmt.qmax + 1, (600, 561), np.int64)
    q[:200] = fmt.qmax
    q[200:300] = fmt.qmin
    acc = (q * q).sum(1)  # numpy int64 wraps mod 2^64 like the kernel
    i64 = np.iinfo(np.int64)
    acc = np.concatenate([acc, [0, 1, i64.max, i64.min, -1]]).astype(np.int64)
    zero = np.zeros(acc.size, np.int32)
    want = tfx.rshift_round_saturate(torch.from_numpy(acc), fmt)
    np.testing.assert_array_equal(host_ops(5, zero, zero, acc, fmt),
                                  want.to(torch.int32).numpy())
    np.testing.assert_array_equal(
        want[:600].numpy(),
        tfx.qsq_norm(torch.from_numpy(q).to(fmt.dtype), fmt).numpy())


HELPERS_HARNESS = r"""
#include "fxp_common.cuh"
extern "C" void helpers(const long long* x, const int* m, int n,
                        long long* rshr_out, long long* wrap_out,
                        long long* shl_out) {
  for (int i = 0; i < n; ++i) {
    rshr_out[i] = fxp::rshr(x[i], m[i]);
    wrap_out[i] = fxp::wrap(x[i], m[i] + 1);
    shl_out[i] = fxp::shl(x[i], m[i]);
  }
}
extern "C" void qexp_const(const int32_t* x, int n, const long long* epi,
                           int32_t* out) {
  const fxp::Epilogue e = fxp::epilogue_from(epi);
  for (int i = 0; i < n; ++i)  // the container's widths as constants
    out[i] = e.tb == 32 ? fxp::qexp_w(x[i], e, 32, 64)
           : e.tb == 16 ? fxp::qexp_w(x[i], e, 16, 32)
                        : fxp::qexp_w(x[i], e, 8, 16);
}
"""


@pytest.fixture(scope="module")
def host_helpers(tmp_path_factory):
    lib = _host_build(tmp_path_factory, "helpers", HELPERS_HARNESS)
    lib.helpers.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] + [
        ctypes.c_void_p] * 3
    lib.qexp_const.argtypes = [ctypes.c_void_p, ctypes.c_int] + [
        ctypes.c_void_p] * 2
    return lib


def test_64bit_helpers_match_integer_semantics(host_helpers):
    """``rshr`` (round-to-nearest shift, ties away from zero), ``wrap``
    (two's-complement wrap to a width) and ``shl`` (shift mod 2^64) against
    Python integers, on int64 extremes, their neighbours and random values
    of every magnitude, at every shift and width."""
    rng = np.random.RandomState(64)
    n = 60000
    x = rng.randint(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64)
    x[::3] >>= rng.randint(0, 63, x[::3].size)
    edges = [-2 ** 63, -2 ** 63 + 1, -1, 0, 1, 2 ** 63 - 2, 2 ** 63 - 1]
    x[:len(edges) * 64] = np.repeat(edges, 64)
    m = rng.randint(0, 64, n).astype(np.int32)
    m[:len(edges) * 64] = np.tile(np.arange(64), len(edges))
    outs = [np.empty(n, np.int64) for _ in range(3)]
    host_helpers.helpers(x.ctypes.data, m.ctypes.data, n,
                         *(o.ctypes.data for o in outs))

    def signed(v, bits=64):
        v %= 2 ** bits
        return v - 2 ** bits if v >= 2 ** (bits - 1) else v

    for i, (xi, mi) in enumerate(zip(x.tolist(), m.tolist())):
        if mi == 0:
            want = xi
        else:
            q, rem = xi >> mi, xi - ((xi >> mi) << mi)
            want = q + (1 if rem > (1 << (mi - 1)) - (xi >= 0) else 0)
        assert outs[0][i] == want, ("rshr", xi, mi)
        assert outs[1][i] == signed(xi, mi + 1), ("wrap", xi, mi + 1)
        assert outs[2][i] == signed(xi << mi), ("shl", xi, mi)


@pytest.mark.parametrize("bits,frac", FORMATS,
                         ids=[f"w{b}m{m}" for b, m in FORMATS])
def test_qexp_with_constant_widths_matches_plain(host_helpers, bits, frac):
    """``qexp_w`` with the container's widths as compile-time constants (the
    SVM body's fxp32 algebra) equals the plain ``qexp`` on every container
    value class: extremes, small magnitudes and random values."""
    fmt = tfx.FxpFormat(bits, frac)
    a, _ = _container_edges(fmt, seed=bits * 32 + frac)
    small = np.arange(-4 * fmt.scale, 4 * fmt.scale + 1, max(1, fmt.scale // 64))
    x = np.clip(np.concatenate([a, small]), fmt.qmin, fmt.qmax).astype(np.int32)
    epi = np.ascontiguousarray(fxp_layer.epilogue_params(frac, fmt, "none"))
    out = np.empty(x.size, np.int32)
    host_helpers.qexp_const(x.ctypes.data, x.size, epi.ctypes.data,
                            out.ctypes.data)
    want = tfx.qexp(torch.from_numpy(x).to(fmt.dtype), fmt)
    np.testing.assert_array_equal(out, want.to(torch.int32).numpy())
