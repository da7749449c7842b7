"""The whole fixed-point MLP forward pass in one launch (the megakernel).

Replaces the Pallas kernel
``repro/kernels/fxp_model.py::fxp_mlp_model_pallas`` (body ``_mlp_kernel``);
the kernel-SVM half of that module comes with the next slice.

* :func:`fxp_mlp_model_cuda` launches ``csrc/fxp_mlp_model.cu``: one block
  per ``MODEL_BLOCK_M`` batch rows, the activations ping-ponging between two
  shared-memory buffers in the container type, every layer's int32
  accumulate-and-wrap plus the shared epilogue, one launch for the whole
  model.  It counts its launches in ``fxp_mlp_model_cuda.launches``.
* :func:`fxp_mlp_model_plain` is the same function in PyTorch ops: the plain
  fused layer, composed.

:func:`mlp_fits_smem` is the routing predicate that replaces
``mlp_fits_vmem``: it counts what this kernel keeps in shared memory (the
two activation buffers) against one block's 227 KB, and bounds the layer
count by the kernel's schedule array.  ``REPRO_MEGAKERNEL_VMEM`` overrides
the budget under the reference package's name; ``0`` forces the per-layer
route in both packages.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.fixedpoint import FxpFormat

from . import build
from .fxp_layer import (LAYER_ACTIVATIONS, _check_cuda, epilogue_params,
                        fxp_layer_plain)
from .tune import MODEL_BLOCK_M, SMEM_PER_BLOCK

__all__ = ["fxp_mlp_model_plain", "fxp_mlp_model_cuda", "LayerSchedule",
           "LAYER_ACTIVATIONS", "MAX_LAYERS", "smem_budget", "mlp_smem_bytes",
           "mlp_fits_smem", "REPLACES"]

# One entry per layer: (requantization shift, output format, activation).
LayerSchedule = Tuple[Tuple[int, FxpFormat, str], ...]

MAX_LAYERS = 8  # kMaxLayers in csrc/fxp_mlp_model.cu
REPLACES = "src/repro/kernels/fxp_model.py:211"  # fxp_mlp_model_pallas


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
