"""Whole fixed-point models in one launch: the MLP and kernel-SVM megakernels.

Replaces the Pallas kernels of ``repro/kernels/fxp_model.py``:
``fxp_mlp_model_pallas`` (body ``_mlp_kernel``) and ``fxp_svm_model_pallas``
(body ``_svm_kernel`` via ``_svm_forward``); the fleet kernels come with
their slice.

* :func:`fxp_mlp_model_cuda` launches ``csrc/fxp_mlp_model.cu``: one block
  per ``MODEL_BLOCK_M`` batch rows, the activations ping-ponging between two
  shared-memory buffers in the container type, every layer's int32
  accumulate-and-wrap plus the shared epilogue, one launch for the whole
  model.  It counts its launches in ``fxp_mlp_model_cuda.launches``.
* :func:`fxp_svm_model_cuda` launches ``csrc/fxp_svm_model.cu``: one block
  per ``MODEL_BLOCK_M`` batch rows fills a (rows, S) tile of kernel values
  in shared memory (x . sv^T through the shared tile loop, then the poly or
  rbf algebra), then runs the decision stage ``k . dual`` with the shared
  epilogue.  It counts its launches in ``fxp_svm_model_cuda.launches``.
* :func:`fxp_mlp_model_plain` and :func:`fxp_svm_model_plain` are the same
  functions in PyTorch ops.

:func:`mlp_fits_smem` and :func:`svm_fits_smem` are the routing predicates
that replace ``mlp_fits_vmem`` and ``svm_fits_vmem``: each counts what its
kernel keeps in shared memory (the MLP's two activation buffers; the SVM's
kernel-value tile, squared norms and operand tiles) against one block's
227 KB.  ``REPRO_MEGAKERNEL_VMEM`` overrides the budget under the reference
package's name; ``0`` forces the per-layer route in both packages.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import fixedpoint as fxp
from repro_torch.core.fixedpoint import FxpFormat

from . import build
from .fxp_layer import (LAYER_ACTIVATIONS, _check_cuda, epilogue_params,
                        epilogue_plain, fxp_layer_plain)
from .ref import svm_kernel_values
from .tune import MODEL_BLOCK_M, SMEM_PER_BLOCK, TILE

__all__ = ["fxp_mlp_model_plain", "fxp_mlp_model_cuda", "LayerSchedule",
           "LAYER_ACTIVATIONS", "MAX_LAYERS", "smem_budget", "mlp_smem_bytes",
           "mlp_fits_smem", "REPLACES", "SVM_KERNELS", "fxp_svm_model_plain",
           "fxp_svm_model_cuda", "svm_smem_bytes", "svm_fits_smem",
           "SVM_REPLACES"]

# One entry per layer: (requantization shift, output format, activation).
LayerSchedule = Tuple[Tuple[int, FxpFormat, str], ...]

MAX_LAYERS = 8  # kMaxLayers in csrc/fxp_mlp_model.cu
REPLACES = "src/repro/kernels/fxp_model.py:211"  # fxp_mlp_model_pallas
SVM_REPLACES = "src/repro/kernels/fxp_model.py:307"  # fxp_svm_model_pallas
SVM_KERNELS = ("poly", "rbf")


def smem_budget() -> int:
    """Shared-memory bytes the megakernel may use per block;
    ``REPRO_MEGAKERNEL_VMEM`` overrides (``0`` disables the megakernel)."""
    env = os.environ.get("REPRO_MEGAKERNEL_VMEM")
    if env is not None:
        try:
            return max(0, int(env))
        except ValueError:
            pass
    return SMEM_PER_BLOCK


def mlp_smem_bytes(widths: Sequence[int], bits: int,
                   bm: int = MODEL_BLOCK_M) -> int:
    """Shared memory of one megakernel block: two ``bm x max(widths)``
    activation buffers in the container type."""
    return 2 * bm * max(int(w) for w in widths) * (int(bits) // 8)


def mlp_fits_smem(widths: Sequence[int], bits: int,
                  bm: int = MODEL_BLOCK_M) -> bool:
    """Whether the megakernel takes this MLP (``widths`` = [n_features,
    hidden..., n_classes])."""
    return (len(widths) - 1 <= MAX_LAYERS
            and mlp_smem_bytes(widths, bits, bm) <= smem_budget())


def _check_schedule(weights, biases, schedule) -> None:
    if not (len(weights) == len(biases) == len(schedule) >= 1):
        raise ValueError("weights/biases/schedule must align, >= 1 layer")
    for _, _, activation in schedule:
        if activation not in LAYER_ACTIVATIONS:
            raise KeyError(f"activation must be one of {LAYER_ACTIVATIONS}")


def fxp_mlp_model_plain(x: torch.Tensor, weights, biases,
                        schedule: LayerSchedule) -> torch.Tensor:
    """The megakernel's function in PyTorch ops: the plain fused layer (int32
    accumulator with wrap) per schedule entry; the output is in the last
    layer's format."""
    _check_schedule(weights, biases, schedule)
    h = x
    for (shift, fmt, activation), w, b in zip(schedule, weights, biases):
        h = fxp_layer_plain(h, w, b, fmt, activation, shift)
    return h


@functools.lru_cache(maxsize=64)
def _schedule_params(schedule: LayerSchedule) -> np.ndarray:
    """The schedule's epilogue rows, stacked (cached, read-only)."""
    out = np.stack([epilogue_params(s, f, a) for s, f, a in schedule])
    out.flags.writeable = False
    return out


def _lib():
    fn = build.load("fxp_mlp_model").fxp_mlp_model_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fxp_mlp_model_cuda(x: torch.Tensor, weights, biases,
                       schedule: LayerSchedule) -> torch.Tensor:
    """Launch the CUDA megakernel.  x (M, K0); weights[i] (K_i, K_{i+1});
    biases[i] (K_{i+1},); every tensor on one CUDA device in one container
    width (the schedule's); returns (M, K_L) in that container."""
    if x.device.type != "cuda":
        raise ValueError(f"fxp_mlp_model_cuda needs CUDA tensors, got {x.device}")
    _check_schedule(weights, biases, schedule)
    bits = schedule[0][1].total_bits
    if any(fmt.total_bits != bits for _, fmt, _ in schedule):
        raise ValueError("the megakernel runs one container width per model")
    if len(schedule) > MAX_LAYERS:
        raise ValueError(f"the megakernel runs at most {MAX_LAYERS} layers")
    dtype = schedule[0][1].dtype
    dev = x.device
    x = _check_cuda("x", x, dtype, dev)
    weights = [_check_cuda(f"weights[{i}]", w, dtype, dev)
               for i, w in enumerate(weights)]
    biases = [_check_cuda(f"biases[{i}]", b, dtype, dev)
              for i, b in enumerate(biases)]
    dims = [int(x.shape[1])]
    for i, (w, b) in enumerate(zip(weights, biases)):
        if w.shape[0] != dims[-1] or b.shape != (w.shape[1],):
            raise ValueError(f"layer {i}: weight {tuple(w.shape)} / bias "
                             f"{tuple(b.shape)} do not follow width {dims[-1]}")
        dims.append(int(w.shape[1]))
    if mlp_smem_bytes(dims, bits) > SMEM_PER_BLOCK:
        raise ValueError(f"widths {dims} exceed one block's shared memory; "
                         f"route this model per layer")
    m = int(x.shape[0])
    out = torch.empty((m, dims[-1]), dtype=dtype, device=dev)
    if m == 0:
        return out
    epis = _schedule_params(tuple(schedule))
    n = len(schedule)
    c_dims = (ctypes.c_int * (n + 1))(*dims)
    c_ws = (ctypes.c_void_p * n)(*[w.data_ptr() for w in weights])
    c_bs = (ctypes.c_void_p * n)(*[b.data_ptr() for b in biases])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib()(x.data_ptr(), out.data_ptr(), m, n, c_dims, c_ws, c_bs,
                     epis.ctypes.data, bits, stream)
    if err != 0:
        raise RuntimeError(f"fxp_mlp_model kernel launch failed: CUDA error "
                           f"{err}")
    fxp_mlp_model_cuda.launches += 1
    return out


fxp_mlp_model_cuda.launches = 0


# --------------------------------------------------------------------------
# kernel-SVM megakernel
# --------------------------------------------------------------------------
def svm_smem_bytes(n_sv: int, bm: int = MODEL_BLOCK_M) -> int:
    """Shared memory of one SVM megakernel block: the (bm, S) int32
    kernel-value tile, the S + bm int32 squared norms, and the two int32
    operand tiles of the shared tile loop (``csrc/fxp_tile.cuh``).  The
    features and classes stream through the tile and L1/L2."""
    return 4 * (bm * int(n_sv) + int(n_sv) + bm) + 2 * 4 * TILE * (TILE + 1)


def svm_fits_smem(n_sv: int, bm: int = MODEL_BLOCK_M) -> bool:
    """Whether the SVM megakernel takes a model of ``n_sv`` support vectors
    (at every container width: the tiles are int32)."""
    return svm_smem_bytes(n_sv, bm) <= smem_budget()


def _check_svm(kind: str, degree: int) -> None:
    if kind not in SVM_KERNELS:
        raise KeyError(f"kind must be one of {SVM_KERNELS}, got {kind!r}")
    if degree < 0:
        raise ValueError("degree must be a non-negative integer")


def fxp_svm_model_plain(qx: torch.Tensor, sv: torch.Tensor, dual: torch.Tensor,
                        icept: torch.Tensor, kind: str, fmt: FxpFormat,
                        out_fmt: FxpFormat, qgamma: int, qcoef0: int,
                        degree: int, dec_shift: int) -> torch.Tensor:
    """The megakernel's function in PyTorch ops: x . sv^T with an int32
    accumulator that wraps, requantized into ``fmt``; the kernel algebra;
    the decision ``k . dual`` with an int32 accumulator, requantized by
    ``dec_shift`` into ``out_fmt`` plus the saturating intercept."""
    _check_svm(kind, degree)
    dot = fxp.rshift_round_saturate(fxp.imatmul(qx, sv.T, torch.int32), fmt)
    k = svm_kernel_values(dot, qx, sv, kind, fmt, qgamma, qcoef0, degree)
    acc = fxp.imatmul(k, dual, torch.int32)
    return epilogue_plain(acc, icept[None, :], out_fmt, "none", dec_shift)


def _svm_lib():
    fn = build.load("fxp_svm_model").fxp_svm_model_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def fxp_svm_model_cuda(qx: torch.Tensor, sv: torch.Tensor, dual: torch.Tensor,
                       icept: torch.Tensor, kind: str, fmt: FxpFormat,
                       out_fmt: FxpFormat, qgamma: int, qcoef0: int,
                       degree: int, dec_shift: int) -> torch.Tensor:
    """Launch the CUDA megakernel.  qx (M, F), sv (S, F), dual (S, C),
    icept (C,), all in one container width on one CUDA device; returns
    (M, C) in ``out_fmt``'s container."""
    if qx.device.type != "cuda":
        raise ValueError(f"fxp_svm_model_cuda needs CUDA tensors, got "
                         f"{qx.device}")
    _check_svm(kind, degree)
    if fmt.total_bits != out_fmt.total_bits:
        raise ValueError("the megakernel runs one container width per model")
    dtype, dev = fmt.dtype, qx.device
    qx = _check_cuda("qx", qx, dtype, dev)
    sv = _check_cuda("sv", sv, dtype, dev)
    dual = _check_cuda("dual", dual, dtype, dev)
    icept = _check_cuda("icept", icept, dtype, dev)
    (m, f), (s, c) = qx.shape, dual.shape
    if sv.shape != (s, f) or icept.shape != (c,):
        raise ValueError(f"shape mismatch: qx {tuple(qx.shape)}, sv "
                         f"{tuple(sv.shape)}, dual {tuple(dual.shape)}, "
                         f"icept {tuple(icept.shape)}")
    if min(f, s, c) == 0:
        raise ValueError("the SVM megakernel needs F, S and C >= 1")
    if svm_smem_bytes(s) > SMEM_PER_BLOCK:
        raise ValueError(f"{s} support vectors exceed one block's shared "
                         f"memory; route this model per layer")
    out = torch.empty((m, c), dtype=dtype, device=dev)
    if m == 0:
        return out
    epi_k = epilogue_params(fmt.frac_bits, fmt, "none")
    epi_out = epilogue_params(dec_shift, out_fmt, "none")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _svm_lib()(qx.data_ptr(), sv.data_ptr(), dual.data_ptr(),
                         icept.data_ptr(), out.data_ptr(), m, f, s, c,
                         fmt.total_bits, epi_k.ctypes.data, epi_out.ctypes.data,
                         SVM_KERNELS.index(kind), int(qgamma), int(qcoef0),
                         int(degree), stream)
    if err != 0:
        raise RuntimeError(f"fxp_svm_model kernel launch failed: CUDA error "
                           f"{err}")
    fxp_svm_model_cuda.launches += 1
    return out


fxp_svm_model_cuda.launches = 0
