"""The float PWL sigmoid family, elementwise, in one launch.

Replaces the Pallas kernel
``repro/kernels/pwl_activation.py::pwl_activation_pallas`` (body
``_kernel``): ``pwl2``, ``pwl4``, ``rational`` and the fused ``silu_pwl4``
gate, computed in float32.  Two versions of the same function:

* :func:`pwl_activation_cuda` launches the hand-written Hopper kernel
  (``csrc/pwl_activation.cu``): a grid-stride pass over the flat tensor
  with 16-byte loads, the arithmetic of ``csrc/pwl.cuh``.  It takes
  float32, float16 and bfloat16: a narrow value widens to float32, and the
  result narrows back with round to nearest even, as the reference's cast
  does.  Another dtype raises ``TypeError``.  It counts its launches in
  ``pwl_activation_cuda.launches``.
* :func:`pwl_activation_plain` computes the same thing in PyTorch ops on any
  device and any float dtype, in float32 with a cast back, as the
  reference does (the oracle's float sigmoids).

Both take an optional ``bias`` over the last axis (``x.shape[-1]`` values
of ``x``'s dtype), added before the variant: ``variant(x + bias)``, with
the sum rounded to ``x``'s dtype first, as the unfused ``pwl(h + b)``
rounds it, so the fused and unfused routes agree bit for bit.  On the card
that is one launch where the unfused route makes two (a hidden layer of
the ``flt`` PWL MLP); ``silu_pwl4`` is the LM's PWL-gated SiLU in one
launch (:func:`repro_torch.lm.layers.gated_silu`).

Every slope is a power of two, so the kernel, the plain version and the
reference agree bit for bit (+-inf, -0.0 and subnormals included; NaN
where the reference gives NaN).  Like XLA, all three flush a subnormal
result to a zero of its sign (see ``csrc/pwl.cuh``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .ref import pwl_activation_ref

__all__ = ["PWL_VARIANTS", "pwl_activation_plain", "pwl_activation_cuda",
           "REPLACES"]

# Order = pwl::Variant in csrc/pwl.cuh.
PWL_VARIANTS = ("pwl2", "pwl4", "rational", "silu_pwl4")
REPLACES = "src/repro/kernels/pwl_activation.py:63"  # pwl_activation_pallas
# The kernel's storage dtypes, by their code in csrc/pwl_activation.cu.
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _check_variant(variant: str) -> int:
    try:
        return PWL_VARIANTS.index(variant)
    except ValueError:
        raise KeyError(f"variant must be one of {PWL_VARIANTS}, got "
                       f"{variant!r}") from None


def _check_bias(x: torch.Tensor, bias: torch.Tensor) -> None:
    if x.dim() == 0 or bias.shape != x.shape[-1:] or bias.dtype != x.dtype:
        raise ValueError(f"bias must have shape {tuple(x.shape[-1:])} and "
                         f"dtype {x.dtype} (x's last axis), got "
                         f"{bias.dtype}{tuple(bias.shape)}")
    if bias.device != x.device:
        raise ValueError(f"bias on {bias.device}, x on {x.device}")


def pwl_activation_plain(x: torch.Tensor, variant: str,
                         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in PyTorch ops: any shape and float dtype,
    computed in float32 (subnormal results flushed), returned in ``x``'s
    dtype; ``bias`` is added in ``x``'s dtype first.  The float sigmoids
    have one definition in the port, in :mod:`repro_torch.core.activations`,
    which the oracle :func:`repro_torch.kernels.ref.pwl_activation_ref`
    applies."""
    _check_variant(variant)
    if bias is not None:
        _check_bias(x, bias)
        x = x + bias
    return pwl_activation_ref(x, variant)


def _lib():
    fn = build.load("pwl_activation").pwl_activation_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def pwl_activation_cuda(x: torch.Tensor, variant: str,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA kernel on a float32, float16 or bfloat16 CUDA tensor
    of any shape (with ``bias``: at least one axis); returns a new tensor of
    the same shape and dtype."""
    code = _check_variant(variant)
    if x.device.type != "cuda":
        raise ValueError(f"pwl_activation_cuda needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"pwl_activation_cuda takes {tuple(_DTYPES)}, got "
                        f"{x.dtype}")
    x = x.contiguous()
    cols = 0
    if bias is not None:
        _check_bias(x, bias)
        bias = bias.contiguous()
        cols = x.shape[-1]
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _lib()(x.data_ptr(), None if bias is None else bias.data_ptr(),
                     out.data_ptr(), x.numel(), cols, code, _DTYPES[x.dtype],
                     stream)
    if err != 0:
        raise RuntimeError(f"pwl_activation kernel launch failed: CUDA error "
                           f"{err}")
    pwl_activation_cuda.launches += 1
    return out


pwl_activation_cuda.launches = 0
