"""The float PWL route of the port against the live JAX package.

* ``pwl_activation_plain`` (what the CPU runs, and what the CUDA kernel is
  held to on the card) against the reference's ``pwl_activation_ref`` and
  against ``pwl_activation_pallas`` in interpret mode, bit for bit, over
  random values and the edges: +-0, +-inf, NaN, subnormals, the segment
  edges 1.0, 2.375 and 5.0 and their neighbours, and the float32 extremes.
  NaN compares as NaN: its sign and payload bits follow the order of the
  operations, which the packages need not share.  XLA flushes subnormal
  results to zero, and the port does the same;
* ``csrc/pwl.cuh`` — the CUDA kernel's own arithmetic — compiled for the
  host with the system C++ compiler, against the same;
* the ``flt`` MLP with a ``pwl2``/``pwl4``/``rational`` sigmoid: the port
  on ``cuda`` (``device="cpu"``) routes through ``ops.pwl_activation`` and
  its labels equal the reference's on ``pallas``.
"""

import ctypes
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables jax x64, as the reference runs)
from repro import compile as jcompile
from repro.kernels import ref as jref
from repro.kernels.pwl_activation import pwl_activation_pallas
from repro_torch import compile as tcompile
from repro_torch.convert import model_from_params
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.pwl_activation import (PWL_VARIANTS,
                                                pwl_activation_plain)

from _torch_port_cases import jax_model, model_params

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src", "repro_torch", "kernels", "csrc")
HARNESS = r"""
#include "pwl.cuh"
extern "C" void apply(int variant, const float* x, float* y, int n) {
  for (int i = 0; i < n; ++i) y[i] = pwl::apply(variant, x[i]);
}

// pwl_activation.cu's loops (pwl::thread_share), thread after thread of a
// grid of `threads`, over float32 items of `vec` values (1: not
// vectorized); without a bias when b is NULL.
struct Op {
  int variant;
  float operator()(float v) const { return pwl::apply(variant, v); }
  float operator()(float v, float b) const {
    return pwl::apply(variant, v + b);
  }
};
template <int kVec> struct Vec { float e[kVec]; };

template <int kVec>
void rows_of(const Op& op, const float* x, const float* b, float* y,
             long long n, int cols, int vectorized, long long threads) {
  for (long long tid = 0; tid < threads; ++tid) {
    if (b != nullptr)
      pwl::thread_share<true, kVec, Vec<kVec>>(x, b, y, n, cols, vectorized,
                                               tid, threads, op);
    else
      pwl::thread_share<false, kVec, Vec<kVec>>(x, b, y, n, cols, vectorized,
                                                tid, threads, op);
  }
}

extern "C" void apply_rows(int variant, const float* x, const float* b,
                           float* y, long long n, int cols, int vec,
                           long long threads) {
  const Op op{variant};
  if (vec == 8) rows_of<8>(op, x, b, y, n, cols, 1, threads);
  else if (vec == 4) rows_of<4>(op, x, b, y, n, cols, 1, threads);
  else rows_of<1>(op, x, b, y, n, cols, 0, threads);
}
"""
# Widths of a biased tensor: 1, D5-like odd widths that cross the 4- and
# 8-value vectors of the kernel's 16-byte loads, 64 (path C's hidden
# layer) and D6's 561.
BIAS_WIDTHS = (1, 6, 7, 33, 64, 561)


def _edges() -> np.ndarray:
    f32 = np.finfo(np.float32)
    base = [0.0, 1.0, 2.375, 5.0, 0.5, 2.0, 4.0, 1e30, float(f32.max),
            float(f32.tiny), float(f32.smallest_subnormal), 1e-40, 3e-39,
            np.inf, np.nan]
    vals = []
    with np.errstate(over="ignore"):
        for v in np.asarray(base, np.float32):
            for w in (v, np.nextafter(v, np.float32(np.inf)),
                      np.nextafter(v, np.float32(-np.inf))):
                vals += [w, -w]
    return np.asarray(vals, np.float32)


def _inputs() -> np.ndarray:
    """(8, 128) float32: the edges, then seeded values over the segments."""
    rng = np.random.RandomState(0)
    x = (rng.randn(8 * 128) * 3).astype(np.float32)
    e = _edges()
    x[:e.size] = e
    return x.reshape(8, 128)


def _bits(a) -> np.ndarray:
    """The float32 bits, with every NaN as one canonical pattern."""
    a = np.array(a, np.float32)
    a[np.isnan(a)] = np.nan
    return a.view(np.int32)


@pytest.fixture(scope="module")
def host_pwl(tmp_path_factory):
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler on this host")
    d = tmp_path_factory.mktemp("pwl")
    src, lib = d / "harness.cpp", d / "libpwl.so"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-std=c++17", "-O2", "-Wall", "-Werror", "-shared",
                    "-fPIC", "-I", CSRC, "-o", str(lib), str(src)],
                   check=True, capture_output=True, timeout=120)
    cdll = ctypes.CDLL(str(lib))
    fn = cdll.apply
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int]
    fn.restype = None
    rows = cdll.apply_rows
    rows.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_int, ctypes.c_longlong]
    rows.restype = None

    def run(variant, x, bias=None, vec=None, threads=1):
        """``pwl::apply`` element by element, or with ``vec`` the kernel's
        loops over a grid of ``threads`` (with ``bias``: the biased pass)."""
        x = np.ascontiguousarray(x, np.float32)
        y = np.full_like(x, 7.0)  # any element the loops miss stays 7
        if vec is None:
            fn(PWL_VARIANTS.index(variant), x.ctypes.data, y.ctypes.data,
               x.size)
        else:
            b = None if bias is None else np.ascontiguousarray(bias,
                                                               np.float32)
            rows(PWL_VARIANTS.index(variant), x.ctypes.data,
                 None if b is None else b.ctypes.data, y.ctypes.data, x.size,
                 x.shape[-1], vec, threads)
        return y

    return run


@pytest.mark.parametrize("variant", PWL_VARIANTS)
def test_plain_matches_reference_bit_for_bit(variant):
    x = _inputs()
    got = pwl_activation_plain(torch.from_numpy(x), variant).numpy()
    ref = np.asarray(jref.pwl_activation_ref(jnp.asarray(x), variant))
    kern = np.asarray(pwl_activation_pallas(jnp.asarray(x), variant,
                                            block_rows=8, block_cols=128,
                                            interpret=True))
    np.testing.assert_array_equal(_bits(ref), _bits(kern))
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    if variant == "silu_pwl4":  # the flush: 0.5 * 2^-126 is subnormal
        assert (got == 0).sum() > (x == 0).sum()
    # the port's oracle and its ops routes agree with the plain version
    for impl in ("ref", "cuda"):
        out = ops.pwl_activation(torch.from_numpy(x), variant, impl=impl)
        np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))
    np.testing.assert_array_equal(
        _bits(tref.pwl_activation_ref(torch.from_numpy(x), variant).numpy()),
        _bits(ref))


@pytest.mark.parametrize("variant", PWL_VARIANTS)
def test_kernel_arithmetic_matches_reference_on_host(host_pwl, variant):
    """``csrc/pwl.cuh`` — the kernel's functions — compiled for the host."""
    x = _inputs()
    ref = np.asarray(jref.pwl_activation_ref(jnp.asarray(x), variant))
    np.testing.assert_array_equal(_bits(host_pwl(variant, x)), _bits(ref))


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_plain_narrow_floats_compute_in_float32(dtype):
    """Like the reference, the plain version takes any float dtype, computes
    in float32 and casts back (the CUDA kernel does the same for float16
    and bfloat16; tests/test_torch_cuda.py holds it to this version)."""
    x = _inputs()[:, :64]
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    for variant in PWL_VARIANTS:
        got = pwl_activation_plain(xt, variant)
        assert got.dtype == xt.dtype
        want = np.asarray(jref.pwl_activation_ref(xj, variant)
                          .astype(jnp.float32))
        np.testing.assert_array_equal(_bits(got.to(torch.float32).numpy()),
                                      _bits(want))


def _biased_inputs(width, rows=5, seed=0):
    """(rows, width) x and (width,) bias in float32: seeded values over the
    segments, with the normal edges (+-0, +-inf, NaN, segment edges, the
    float32 extremes) in x and +-0, +-inf and NaN in the bias.  Subnormal
    operands are left to ``test_subnormal_sum_follows_ieee``."""
    rng = np.random.RandomState(seed + width)
    x = (rng.randn(rows * width) * 3).astype(np.float32)
    e = _edges()
    with np.errstate(invalid="ignore"):
        e = e[~(np.abs(e) < np.finfo(np.float32).tiny) | (e == 0)]
    x[:min(e.size, x.size)] = e[:x.size]
    b = (rng.randn(width) * 2).astype(np.float32)
    b_edges = np.asarray([0.0, -0.0, np.inf, -np.inf, np.nan], np.float32)
    b[:min(b_edges.size, width)] = b_edges[:width]
    return x.reshape(rows, width), b


def _as_float32_bits(a) -> np.ndarray:
    return _bits(np.asarray(a.to(torch.float32) if isinstance(a, torch.Tensor)
                            else jnp.asarray(a).astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("variant", PWL_VARIANTS)
def test_plain_bias_matches_reference_bit_for_bit(variant, dtype):
    """``pwl_activation_plain(x, v, bias=b)`` is the reference's
    ``pwl_activation_pallas(x + b, v)`` (interpret mode), the sum rounded
    to the dtype, at widths that cross the kernel's 16-byte vectors; and
    so is every route of ``ops.pwl_activation`` with the bias."""
    for width in BIAS_WIDTHS:
        x, b = _biased_inputs(width)
        xt = torch.from_numpy(x).to(getattr(torch, dtype))
        bt = torch.from_numpy(b).to(getattr(torch, dtype))
        xj = jnp.asarray(x).astype(getattr(jnp, dtype))
        bj = jnp.asarray(b).astype(getattr(jnp, dtype))
        # the two packages round the float32 values to the same narrow bits
        np.testing.assert_array_equal(_as_float32_bits(xt),
                                      _as_float32_bits(xj))
        want = pwl_activation_pallas(xj + bj, variant, block_rows=x.shape[0],
                                     block_cols=width, interpret=True)
        got = pwl_activation_plain(xt, variant, bias=bt)
        assert got.dtype == xt.dtype and got.shape == xt.shape
        np.testing.assert_array_equal(_as_float32_bits(got),
                                      _as_float32_bits(want),
                                      err_msg=f"width {width}")
        for impl in ("cuda", "ref"):
            out = ops.pwl_activation(xt, variant, impl=impl, bias=bt)
            np.testing.assert_array_equal(_as_float32_bits(out),
                                          _as_float32_bits(want))


@pytest.mark.parametrize("vectorized,vec", [(1, 4), (1, 8), (0, 1)])
@pytest.mark.parametrize("variant", PWL_VARIANTS)
def test_kernel_bias_loops_match_reference_on_host(host_pwl, variant,
                                                   vectorized, vec):
    """The kernel's own loops (``pwl::thread_share`` of ``csrc/pwl.cuh``,
    which ``csrc/pwl_activation.cu`` launches: the column walk over items of
    4 or 8 values and the tail, or an unaligned tensor element by element),
    run thread by thread on the host over grids of 1, 3 and 64 threads,
    against the reference's ``pwl_activation_pallas(x + b)``, and without a
    bias against ``pwl_activation_pallas(x)``."""
    for width in BIAS_WIDTHS:
        for rows in (1, 5):
            x, b = _biased_inputs(width, rows)
            want = np.asarray(pwl_activation_pallas(
                jnp.asarray(x) + jnp.asarray(b), variant, block_rows=rows,
                block_cols=width, interpret=True))
            plain = np.asarray(pwl_activation_pallas(
                jnp.asarray(x), variant, block_rows=rows, block_cols=width,
                interpret=True))
            assert vectorized == (vec > 1)
            for threads in (1, 3, 64):
                got = host_pwl(variant, x, b, vec=vec, threads=threads)
                np.testing.assert_array_equal(
                    _bits(got), _bits(want),
                    err_msg=f"width {width} rows {rows} threads {threads}")
                got = host_pwl(variant, x, vec=vec, threads=threads)
                np.testing.assert_array_equal(
                    _bits(got), _bits(plain),
                    err_msg=f"no bias, width {width} rows {rows} threads "
                            f"{threads}")


def test_subnormal_sum_follows_ieee():
    """The fused sum is IEEE's, as PyTorch's unfused ``h + b`` is (on the
    host and on the card): a subnormal x plus a zero bias stays x.  XLA on
    the CPU also treats a subnormal operand as zero, so the reference's
    ``x + b`` gives +0 there; only ``silu_pwl4`` shows it, as the sign of
    its (flushed) zero result.  Every other variant and value agrees."""
    x = np.asarray([[-1e-40, 1e-40, -1e-45, 1e-45]], np.float32)
    b = np.zeros(4, np.float32)
    xt, bt = torch.from_numpy(x), torch.from_numpy(b)
    for variant in PWL_VARIANTS:
        got = pwl_activation_plain(xt, variant, bias=bt)
        unfused = pwl_activation_plain(xt + bt, variant)
        np.testing.assert_array_equal(_bits(got.numpy()),
                                      _bits(unfused.numpy()))
        want = np.asarray(pwl_activation_pallas(
            jnp.asarray(x) + jnp.asarray(b), variant, block_rows=1,
            block_cols=4, interpret=True))
        if variant == "silu_pwl4":
            np.testing.assert_array_equal(np.signbit(got.numpy()),
                                          np.signbit(x))
            assert (got.numpy() == 0).all() and not np.signbit(want).any()
        else:
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_bias_must_match_the_last_axis():
    x = torch.zeros(3, 5)
    for bad in (torch.zeros(4), torch.zeros(5, dtype=torch.float64),
                torch.zeros(1, 5)):
        with pytest.raises(ValueError, match="bias"):
            pwl_activation_plain(x, "pwl4", bias=bad)
        for impl in ("cuda", "ref"):
            with pytest.raises(ValueError, match="bias"):
                ops.pwl_activation(x, "pwl4", impl=impl, bias=bad)


def test_cuda_wrapper_takes_float32_cuda_tensors_only():
    from repro_torch.kernels.pwl_activation import pwl_activation_cuda

    with pytest.raises(ValueError, match="CUDA"):
        pwl_activation_cuda(torch.zeros(4), "pwl4")
    with pytest.raises(KeyError):
        pwl_activation_plain(torch.zeros(4), "tanh")


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.RandomState(3)
    means = rng.randn(3, 12) * 2.0
    y = rng.randint(0, 3, 400).astype(np.int32)
    x = (means[y] + rng.randn(400, 12)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("sigmoid", ["pwl2", "pwl4", "rational"])
@pytest.mark.parametrize("name", ["mlp1", "mlp2"])
def test_flt_pwl_mlp_matches_reference(blobs, name, sigmoid):
    """The flt MLP with a PWL sigmoid: port on cuda (host device, the plain
    kernel version) against the reference on pallas.  Float32 matmuls may
    sum in another order, so rows whose top-2 logit gap is under 1e-4 are
    left out; the rest must agree exactly."""
    x, y = blobs
    kind, params = model_params(name, x, y)
    jart = jcompile.compile(jax_model(kind, params),
                            jcompile.Target(sigmoid=sigmoid,
                                            backend="pallas"))
    before = ops._active_counters[:]
    with ops.count_dispatches() as c:
        tart = tcompile.compile(model_from_params(kind, params),
                                tcompile.Target(sigmoid=sigmoid,
                                                backend="cuda"),
                                device="cpu")
        got = tart.predict(x)
    assert ops._active_counters == before
    assert c.count == len(params["weights"]) - 1  # one per hidden layer
    want = jart.predict(x)
    h = x.astype(np.float64)
    sig = {"pwl2": lambda v: np.clip(0.25 * v + 0.5, 0, 1),
           "rational": lambda v: 0.5 + 0.5 * v / (1 + np.abs(v)),
           "pwl4": lambda v: pwl_activation_plain(
               torch.from_numpy(v), "pwl4").numpy()}[sigmoid]
    for i, (w, b) in enumerate(zip(params["weights"], params["biases"])):
        h = h @ w + b
        if i < len(params["weights"]) - 1:
            h = sig(h)
    top2 = np.sort(h, axis=1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) >= 1e-4
    assert decided.sum() >= 0.9 * len(x)
    np.testing.assert_array_equal(got[decided], want[decided])
    assert len(np.unique(want)) > 1
