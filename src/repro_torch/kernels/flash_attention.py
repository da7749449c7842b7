"""Causal or full softmax attention over (BH, S, dh), optionally within a
sliding window, in one launch.

Replaces the Pallas kernel
``repro/kernels/flash_attention.py::flash_attention_pallas`` (body
``_kernel``): the streaming-softmax attention of the LM's prefill, scores
and the running (max, sum, acc) in float32, output in the input's dtype.
Grouped-query attention is part of the function here: q is (BH, S, dh)
with BH = B * H query heads, k and v are (BH / G, S, dh) with G query
heads per KV head, G read off the shapes, and query row ``bh`` reads KV
row ``bh // G`` (for ``bh = b*H + h`` that is ``b*(H/G) + h//G``, the
reference LM's ``_grouped_scores``).  G = 1 is the JAX kernel's
signature, equal-shape q, k, v.  A sliding ``window`` (an int >= 1, or None)
masks the score at (q, k) where ``q - k >= window``, causal or not: the
reference LM's ``blockwise_attention`` mask, whose codegen the TPU kernel
is; the kernel skips the key tiles before a query tile's window.  Two
versions of the same function:

* :func:`flash_attention_cuda` launches the hand-written Hopper kernel
  (``csrc/flash_attention.cu``).  In bfloat16 one block owns 128 query
  rows of a head: a producer warp keeps TMA loads of Q and a two-stage
  ring of K/V tiles in flight, and two consumer warpgroups of 64 rows take
  turns on the tensor cores (``wgmma``: Q.K^T from shared memory, P.V with
  P in registers); in float32 one block owns 64 rows and the products stay
  on the CUDA cores (TF32 would not hold the float32 tolerance).  Its
  instances take dh in {32, 64, 128, 192, 224} (192: MLA's 128 + 64 rotary
  query/key dims, with v zero-padded to it by the caller; 224: Zamba2's
  shared block), every one of them on the ``wgmma`` design in bfloat16
  (:data:`WGMMA_HEAD_DIMS`): a head dim between them is zero-padded to the
  next instance (:func:`pad_head_dim`; zeros add nothing to q.k or to the
  output's first dh columns, and the default scale stays ``1/sqrt(dh)`` of
  the true dh), and the output is sliced back; dh above 224 raises.  The
  scores' ``scale`` defaults to ``float32(1/sqrt(dh))``; a model that states
  another (Zamba2's ``(dh/2)^-1/2``) passes it.  float32 and bfloat16 run
  their own instances; any other float dtype (float16, float64) computes
  on the float32 instance and is cast back, as the reference computes in
  float32.  Unlike the TPU kernel it takes any S (ragged edges are
  masked).  It counts its launches in ``flash_attention_cuda.launches``,
  those on the ``wgmma`` design also in ``.wgmma_launches``, and those on
  the dh-224 instance (either dtype) in ``.dh224_launches``.
* :func:`flash_attention_plain` repeats K/V to the query heads and
  materializes the (BH, S, S) scores in float32 in PyTorch ops (the oracle
  :func:`repro_torch.kernels.ref.flash_attention_ref`), on any device.

The two sum in different orders, and the bf16 kernel rounds P to bf16
before P.V, so they agree to float32 rounding (bf16 outputs to about one
rounding of the output), not bit for bit.
"""

from __future__ import annotations

import ctypes
import math
import numpy as np
import torch

from . import build
from .ref import flash_attention_ref

__all__ = ["flash_attention_plain", "flash_attention_cuda", "check_shapes",
           "check_window", "expand_kv", "pad_head_dim", "HEAD_DIMS",
           "WGMMA_HEAD_DIMS", "REPLACES"]

HEAD_DIMS = (32, 64, 128, 192, 224)  # the kernel's template instances
# the bfloat16 instances on the warpgroup-MMA design (``bf16::Tile`` in
# the source)
WGMMA_HEAD_DIMS = (32, 64, 128, 192, 224)
REPLACES = "src/repro/kernels/flash_attention.py:71"  # flash_attention_pallas
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_shapes(q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> int:
    """Validate the shapes; returns the group G = BH / BH_kv, the query
    heads that share one key/value row."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"q, k, v must be (BH, S, dh) and k, v of one shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    bh, bh_kv = q.shape[0], k.shape[0]
    group = bh // bh_kv if bh_kv else int(bh == 0)
    if k.shape[1:] != q.shape[1:] or not group or group * bh_kv != bh:
        raise ValueError(f"k, v must be (BH / G, S, dh) for q "
                         f"{tuple(q.shape)}, with G dividing BH, got "
                         f"{tuple(k.shape)}")
    return group


def expand_kv(t: torch.Tensor, group: int) -> torch.Tensor:
    """(BH / G, S, dh) key or value rows repeated to the (BH, S, dh) query
    rows they serve: row ``bh`` is input row ``bh // G``."""
    return t if group == 1 else t.repeat_interleave(group, dim=0)


def check_window(window: int | None) -> int:
    """The kernel's window argument: 0 for None, else ``window`` (>= 1)."""
    if window is None:
        return 0
    if int(window) != window or window < 1:
        raise ValueError(f"window must be None or an int >= 1, got {window!r}")
    return int(window)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, scale: float | None = None,
                          window: int | None = None) -> torch.Tensor:
    """The kernel's function in PyTorch ops, with K/V repeated to the query
    heads and the scores materialized in float32: (BH, S, dh) ->
    (BH, S, dh) in ``q``'s dtype.  ``scale`` multiplies the scores
    (default ``float32(1/sqrt(dh))``); ``window`` masks ``q - k >=
    window``."""
    group = check_shapes(q, k, v)
    check_window(window)
    return flash_attention_ref(q, expand_kv(k, group), expand_kv(v, group),
                               causal, scale, window)


def pad_head_dim(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float | None = None):
    """(q, k, v, scale) with the head dim zero-padded to the kernel's next
    instance (:data:`HEAD_DIMS`) and ``scale`` (default ``float32(1/sqrt(dh))``
    of the true dh): attention over the padded tensors, sliced to the first
    dh output columns, is attention over the given ones.  Raises for dh
    above the largest instance."""
    dh = q.shape[-1]
    fit = [d for d in HEAD_DIMS if d >= dh]
    if not fit:
        raise ValueError(f"flash_attention_cuda takes head dims up to "
                         f"{HEAD_DIMS[-1]} (instances {HEAD_DIMS}), got {dh}")
    if scale is None:
        scale = float(np.float32(1.0 / math.sqrt(dh)))
    if fit[0] != dh:
        pad = (0, fit[0] - dh)
        q, k, v = (torch.nn.functional.pad(t, pad) for t in (q, k, v))
    return q, k, v, scale


def _lib():
    fn = build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and starting on a 16-byte boundary (the kernel's 16-byte
    copies and TMA's tensor maps)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int | None = None,
                         scale: float | None = None) -> torch.Tensor:
    """Launch the CUDA kernel on a (BH, S, dh) q and (BH / G, S, dh) k and v
    on one CUDA device, within a sliding ``window`` when one is given, the
    scores multiplied by ``scale`` (default ``float32(1/sqrt(dh))``);
    returns a new (BH, S, dh) tensor of ``q``'s dtype."""
    group = check_shapes(q, k, v)
    win = check_window(window)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention_cuda needs q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if not q.dtype.is_floating_point:
        raise TypeError(f"flash_attention_cuda takes float tensors, got "
                        f"{q.dtype}")
    dtype, dh = q.dtype, q.shape[-1]
    if dtype not in _DTYPES:  # float16, float64: the float32 instance
        q, k, v = q.float(), k.float(), v.float()
    q, k, v, scale = pad_head_dim(q, k, v, scale)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    bh, s, dh_kernel = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out[..., :dh].to(dtype)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     bh, s, dh_kernel, _DTYPES[q.dtype], scale,
                     int(bool(causal)), win, group, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{err}")
    flash_attention_cuda.launches += 1
    if q.dtype == torch.bfloat16 and dh_kernel in WGMMA_HEAD_DIMS:
        flash_attention_cuda.wgmma_launches += 1
    if dh_kernel == 224:
        flash_attention_cuda.dh224_launches += 1
    if dh_kernel != dh:
        out = out[..., :dh].contiguous()
    return out if out.dtype == dtype else out.to(dtype)


flash_attention_cuda.launches = 0
flash_attention_cuda.wgmma_launches = 0
flash_attention_cuda.dh224_launches = 0
