"""Fixed-point matmul ``rshift_round_saturate(A @ B, m)`` in one launch.

Replaces the Pallas kernel ``repro/kernels/fxp_qmatmul.py::fxp_qmatmul_pallas``
(body ``_kernel``): the first stage of the kernel SVM's per-layer route,
``x . sv^T`` in the kernel-domain format.  Two versions of the same function:

* :func:`fxp_qmatmul_cuda` launches ``csrc/fxp_qmatmul.cu``: one block per
  32x32 output tile, the tile loop shared with ``fxp_layer``
  (``csrc/fxp_tile.cuh``), an int32 accumulator that wraps at 32 bits, one
  rounded shift by ``fmt.frac_bits`` and saturation.  It counts its
  launches in ``fxp_qmatmul_cuda.launches``.
* :func:`fxp_qmatmul_plain` is the same function in PyTorch ops on any
  device: the exact product wrapped to int32
  (:func:`repro_torch.core.fixedpoint.imatmul`) and the single-format
  requantize.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import fixedpoint as fxp
from repro_torch.core.fixedpoint import FxpFormat

from . import build
from .fxp_layer import _check_cuda

__all__ = ["fxp_qmatmul_plain", "fxp_qmatmul_cuda", "REPLACES"]

REPLACES = "src/repro/kernels/fxp_qmatmul.py:62"  # fxp_qmatmul_pallas


def fxp_qmatmul_plain(a: torch.Tensor, b: torch.Tensor,
                      fmt: FxpFormat) -> torch.Tensor:
    """The kernel's function in PyTorch ops: int32 accumulation with wrap,
    then ``rshift_round_saturate`` into ``fmt``."""
    return fxp.rshift_round_saturate(fxp.imatmul(a, b, torch.int32), fmt)


def _lib():
    fn = build.load("fxp_qmatmul").fxp_qmatmul_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fxp_qmatmul_cuda(a: torch.Tensor, b: torch.Tensor,
                     fmt: FxpFormat) -> torch.Tensor:
    """Launch the CUDA kernel: a (M, K), b (K, N) in ``fmt.dtype`` on one
    CUDA device -> (M, N) in ``fmt.dtype``."""
    if a.device.type != "cuda":
        raise ValueError(f"fxp_qmatmul_cuda needs CUDA tensors, got {a.device}")
    dev = a.device
    a = _check_cuda("a", a, fmt.dtype, dev)
    b = _check_cuda("b", b, fmt.dtype, dev)
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2:
        raise ValueError(f"shape mismatch: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}")
    out = torch.empty((m, n), dtype=fmt.dtype, device=dev)
    if m == 0 or n == 0:
        return out
    if k == 0:
        raise ValueError("fxp_qmatmul needs K >= 1")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib()(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n,
                     fmt.total_bits, fmt.frac_bits, stream)
    if err != 0:
        raise RuntimeError(f"fxp_qmatmul kernel launch failed: CUDA error "
                           f"{err}")
    fxp_qmatmul_cuda.launches += 1
    return out


fxp_qmatmul_cuda.launches = 0
