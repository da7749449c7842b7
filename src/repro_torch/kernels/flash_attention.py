"""Causal or full softmax attention over (BH, S, dh), in one launch.

Replaces the Pallas kernel
``repro/kernels/flash_attention.py::flash_attention_pallas`` (body
``_kernel``): the streaming-softmax attention of the LM's prefill, scores
and the running (max, sum, acc) in float32, output in the input's dtype.
Two versions of the same function:

* :func:`flash_attention_cuda` launches the hand-written Hopper kernel
  (``csrc/flash_attention.cu``): one block per (bh, 64-query tile), K/V
  tiles staged in shared memory as float32, products on the CUDA cores.
  It takes float32 or bfloat16 and dh in {32, 64, 128}; anything else
  raises.  Unlike the TPU kernel it takes any S (ragged edges are masked).
  It counts its launches in ``flash_attention_cuda.launches``.
* :func:`flash_attention_plain` materializes the (BH, S, S) scores in
  float32 in PyTorch ops (the oracle
  :func:`repro_torch.kernels.ref.flash_attention_ref`), on any device.

The two sum in different orders, so they agree to float32 rounding (bf16
outputs to one rounding of the output), not bit for bit.  GQA grouping is
the caller's: K/V heads are repeated to the query heads before the launch.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import build
from .ref import flash_attention_ref

__all__ = ["flash_attention_plain", "flash_attention_cuda", "HEAD_DIMS",
           "REPLACES"]

HEAD_DIMS = (32, 64, 128)  # the kernel's template instances
REPLACES = "src/repro/kernels/flash_attention.py:71"  # flash_attention_pallas
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must be (BH, S, dh) of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """The kernel's function in PyTorch ops, with the scores materialized in
    float32: (BH, S, dh) -> (BH, S, dh) in ``q``'s dtype."""
    _check(q, k, v)
    return flash_attention_ref(q, k, v, causal)


def _lib():
    fn = build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel on (BH, S, dh) CUDA tensors; returns a new
    (BH, S, dh) tensor of ``q``'s dtype."""
    _check(q, k, v)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention_cuda needs q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention_cuda takes float32 or bfloat16, "
                        f"got {q.dtype}")
    bh, s, dh = q.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda takes head dims {HEAD_DIMS}, "
                         f"got {dh}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    scale = float(np.float32(1.0 / math.sqrt(dh)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     bh, s, dh, _DTYPES[q.dtype], scale, int(bool(causal)),
                     stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{err}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
