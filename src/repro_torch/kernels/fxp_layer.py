"""Fused fixed-point layer ``act(qadd(requantize(A @ B), bias))`` in one launch.

Replaces the Pallas kernel ``repro/kernels/fxp_layer.py::fxp_layer_pallas``.
Two versions of the same function live here:

* :func:`fxp_layer_cuda` launches the hand-written Hopper kernel
  (``csrc/fxp_layer.cu``), which picks its route by shape alone.  A layer
  of at most 32 outputs whose weights fit :func:`narrow_plan` (every layer
  the main paths launch: 561x6, 300x6, 300x10, 64x6) streams its rows
  through persistent blocks that stage W once, a warp's lanes splitting K
  and a shuffle butterfly summing their uint32 partials
  (``csrc/fxp_layer_narrow.cuh``).  Any other layer runs one block per
  64x64 output tile of the integer tile shared with ``fxp_qmatmul``
  (``csrc/fxp_tile.cuh``: the int8 tensor cores through byte planes, the
  TPU's sequential K grid axis turned into a cp.async ring of stages).
  Both wrap the int32
  accumulator at 32 bits and run the shared integer epilogue
  (``csrc/fxp_common.cuh``).  ``blocks`` carries the block-size tuner's
  choice (:mod:`.tune`): the tile's rows (32, 64 or 128) on the wide route,
  the persistent grid on the narrow one (:func:`narrow_grid` is today's
  rule, :func:`narrow_occupancy` what the card holds).  It counts its
  launches in ``fxp_layer_cuda.launches``.
* :func:`fxp_layer_plain` computes the same thing in PyTorch ops — an exact
  integer product wrapped to int32 (:func:`repro_torch.core.fixedpoint.imatmul`)
  and the epilogue from :mod:`repro_torch.core` — on any device.  It is the
  yardstick of correctness, not of speed.

What bounds the kernel on the H100, and what the design does about it, is in
the source's header comment.  :func:`epilogue_params` packs one layer's
epilogue constants for both CUDA kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import fixedpoint as fxp
from repro_torch.core.activations import get_qsigmoid, pwl4_consts
from repro_torch.core.fixedpoint import FxpFormat

from . import build

__all__ = ["fxp_layer_plain", "fxp_layer_cuda", "epilogue_params",
           "epilogue_plain", "narrow_plan", "narrow_grid", "narrow_occupancy",
           "NARROW_SMEM", "NARROW_K_CHUNK", "LAYER_ACTIVATIONS", "REPLACES"]

# "none" = linear output layer (logits); the rest are Qn.m sigmoid variants.
LAYER_ACTIVATIONS = ("none", "exact", "rational", "pwl2", "pwl4")
REPLACES = "src/repro/kernels/fxp_layer.py:78"  # fxp_layer_pallas

# Must match fxp::Act and fxp::Epilogue in csrc/fxp_common.cuh.
_ACT_CODES = {"none": 0, "exact": 1, "rational": 2, "pwl2": 3, "pwl4": 4}
EPILOGUE_FIELDS = 21

# csrc/fxp_layer_narrow.cuh: the instances of the narrow route (N rounded
# up), K staged in whole chunks, and one block's shared memory for W.
_NARROW_BUCKETS = (1, 2, 4, 6, 8, 10, 16, 32)
NARROW_K_CHUNK = 128
NARROW_SMEM = 98_304
NARROW_WARPS = 8  # kNarrowWarps: each warp owns a row group at a time


def narrow_plan(k: int, n: int) -> Optional[Tuple[int, int, int, int, int]]:
    """The narrow kernel's plan for a K x N layer, as ``narrow_plan`` in
    ``csrc/fxp_layer_narrow.cuh`` computes it: (NB, rows a warp owns, W's
    row stride in words, K padded to whole chunks, shared-memory bytes), or
    None when the layer takes the wide route, the integer tile of
    ``csrc/fxp_tile.cuh`` (N > 32, or W past ``NARROW_SMEM``)."""
    nb = next((b for b in _NARROW_BUCKETS if b >= n), 0) if n >= 1 else 0
    if k < 1 or not nb:
        return None
    vec = 4 if nb % 4 == 0 else 2 if nb % 2 == 0 else 1
    stride = nb if (nb // vec) % 2 else nb + vec
    k_pad = -(-k // NARROW_K_CHUNK) * NARROW_K_CHUNK
    smem = 4 * (k_pad * stride + nb)
    if smem > NARROW_SMEM:
        return None
    return nb, (4 if nb <= 10 else 32 // nb), stride, k_pad, smem


def narrow_grid(groups: int, sms: int, slots: int) -> int:
    """The narrow route's persistent blocks for ``groups`` row groups when no
    grid is chosen, as ``narrow_blocks`` in ``csrc/fxp_layer_narrow.cuh``
    computes it: a block for every 8 groups, at least one an SM while the
    groups last, at most ``slots`` (the blocks the card holds at once)."""
    b = -(-int(groups) // NARROW_WARPS)
    b = max(b, min(int(groups), int(sms)))
    return min(b, int(slots))


def _occupancy_lib():
    fn = build.load("fxp_layer").fxp_layer_narrow_occupancy
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=256)
def _narrow_occupancy(k: int, n: int, bits: int, index: int):
    sms, slots = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _occupancy_lib()(k, n, bits, ctypes.byref(sms),
                               ctypes.byref(slots))
    if err != 0:
        raise RuntimeError(f"fxp_layer narrow occupancy query failed: CUDA "
                           f"error {err}")
    return sms.value, slots.value


def narrow_occupancy(k: int, n: int, bits: int,
                     device: torch.device) -> Tuple[int, int]:
    """(SMs, blocks of the narrow instance the card holds at once) for a
    K x N layer of the narrow route on the CUDA ``device``: what the
    tuner's grid candidates are made of (cached per device and shape)."""
    device = torch.device(device)
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return _narrow_occupancy(int(k), int(n), int(bits), index)


@functools.lru_cache(maxsize=256)
def epilogue_params(shift: int, fmt: FxpFormat, activation: str) -> np.ndarray:
    """One layer's epilogue as the int64 row the CUDA kernels read
    (field order of ``fxp::Epilogue``); cached and read-only, since every
    launch of a compiled model asks for the same rows."""
    if activation not in _ACT_CODES:
        raise KeyError(f"activation must be one of {LAYER_ACTIVATIONS}")
    if not 0 <= shift <= 31:
        # The accumulator is int32: shifts past its width are degenerate.
        raise ValueError(f"shift must be in [0, 31] for an int32 "
                         f"accumulator, got {shift}")
    log2e_q, (c0, c1, c2, c3) = fxp.exp_poly_consts(fmt)
    p = pwl4_consts(fmt)
    row = [shift, _ACT_CODES[activation], fmt.frac_bits, fmt.total_bits,
           2 * fmt.total_bits, fmt.int_bits, fmt.qmin, fmt.qmax, fxp.one_q(fmt),
           log2e_q, c0, c1, c2, c3, p["one"], p["half"], p["t5"], p["t2375"],
           p["t1"], p["c84375"], p["c625"]]
    assert len(row) == EPILOGUE_FIELDS
    out = np.asarray(row, np.int64)
    out.flags.writeable = False
    return out


def fxp_layer_plain(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor,
                    fmt: FxpFormat, activation: str = "none",
                    shift: Optional[int] = None) -> torch.Tensor:
    """The kernel's function in PyTorch ops: int32 accumulation with wrap,
    then requantize, saturating bias add and activation, in ``fmt``."""
    if activation not in LAYER_ACTIVATIONS:
        raise KeyError(f"activation must be one of {LAYER_ACTIVATIONS}")
    shift = fmt.frac_bits if shift is None else shift
    acc = fxp.imatmul(a, b, torch.int32)
    return epilogue_plain(acc, bias[None, :], fmt, activation, shift)


def epilogue_plain(acc: torch.Tensor, bias: torch.Tensor, fmt: FxpFormat,
                   activation: str, shift: int) -> torch.Tensor:
    """The kernels' epilogue on an int32 accumulator: requantize by
    ``shift``, saturating bias add, activation, in ``fmt``'s container."""
    h = fxp.requantize(acc, shift, fmt)
    h = fxp.qadd(h, bias, fmt)
    if activation != "none":
        h = get_qsigmoid(activation)(h, fmt)
    return h.to(fmt.dtype)


def _check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    return t.contiguous()


def _lib():
    lib = build.load("fxp_layer")
    fn = lib.fxp_layer_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fxp_layer_cuda(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor,
                   fmt: FxpFormat, activation: str = "none",
                   shift: Optional[int] = None,
                   blocks: Optional[Tuple[int, int, int]] = None,
                   count: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel: a (M, K), b (K, N), bias (N,) in
    ``fmt.dtype`` on one CUDA device -> (M, N) in ``fmt.dtype``.

    ``blocks`` is a blocking of :mod:`.tune` (``(bm, 64, 128 // P)`` on the
    wide route, ``(rows a group, grid, 128)`` on the narrow one; None:
    today's).  ``count=False`` leaves ``fxp_layer_cuda.launches`` alone (a
    tuner's sweep counts its own launches)."""
    if a.device.type != "cuda":
        raise ValueError(f"fxp_layer_cuda needs CUDA tensors, got {a.device}")
    shift = fmt.frac_bits if shift is None else shift
    epi = epilogue_params(shift, fmt, activation)
    dev = a.device
    a = _check_cuda("a", a, fmt.dtype, dev)
    b = _check_cuda("b", b, fmt.dtype, dev)
    bias = _check_cuda("bias", bias, fmt.dtype, dev)
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2 or bias.shape != (n,):
        raise ValueError(f"shape mismatch: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, bias {tuple(bias.shape)}")
    out = torch.empty((m, n), dtype=fmt.dtype, device=dev)
    if m == 0 or n == 0:
        return out
    if k == 0:
        raise ValueError("fxp_layer needs K >= 1")
    # the wide route's tile rows or the narrow route's grid; 0 today's
    block = 0
    if blocks is not None:
        block = blocks[1] if narrow_plan(k, n) is not None else blocks[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib()(a.data_ptr(), b.data_ptr(), bias.data_ptr(),
                     out.data_ptr(), m, k, n, fmt.total_bits, epi.ctypes.data,
                     int(block), stream)
    if err != 0:
        raise RuntimeError(f"fxp_layer kernel launch failed: CUDA error {err}")
    if count:
        fxp_layer_cuda.launches += 1
    return out


fxp_layer_cuda.launches = 0
