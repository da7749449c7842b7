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
"""


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
    fn = ctypes.CDLL(str(lib)).apply
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int]
    fn.restype = None

    def run(variant, x):
        x = np.ascontiguousarray(x, np.float32)
        y = np.empty_like(x)
        fn(PWL_VARIANTS.index(variant), x.ctypes.data, y.ctypes.data, x.size)
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
