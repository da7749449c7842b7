"""Public wrappers around the fixed-point kernels, and their routing.

The counterpart of :mod:`repro.kernels.ops` for the five ported kernels.
Each wrapper routes by ``impl`` and by where its tensors lie:

* ``impl="ref"`` — the int64-accumulating oracle of :mod:`.ref`;
* ``impl="cuda"`` — a CUDA tensor launches the hand-written kernel (or the
  launch raises: there is no fallback), a CPU tensor takes the kernel's
  plain PyTorch version, which computes the same bits.

The CUDA kernels mask ragged edges themselves, so no wrapper pads.
``count_dispatches()`` counts wrapper calls (one per logical kernel
dispatch, whichever version ran); each CUDA launcher also counts its own
launches (``fxp_layer_cuda.launches``, ``fxp_svm_model_cuda.launches``,
...).
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import torch

from repro_torch.core.fixedpoint import FxpFormat
from repro_torch.core.trees import TreeArrays

from . import ref as ref_ops
from .fxp_layer import fxp_layer_cuda, fxp_layer_plain
from .fxp_model import (LayerSchedule, fxp_mlp_model_cuda, fxp_mlp_model_plain,
                        fxp_svm_model_cuda, fxp_svm_model_plain)
from .fxp_qmatmul import fxp_qmatmul_cuda, fxp_qmatmul_plain
from .tree_ensemble import tree_ensemble_cuda, tree_ensemble_plain

__all__ = ["fxp_qmatmul", "fxp_layer", "fxp_mlp_model", "fxp_svm_model",
           "tree_predict", "count_dispatches", "IMPLS"]

IMPLS = ("cuda", "ref")


class DispatchCounter:
    """Counts wrapper-level kernel dispatches."""

    def __init__(self):
        self.count = 0


_active_counters: List[DispatchCounter] = []


def _tick() -> None:
    for c in _active_counters:
        c.count += 1


@contextlib.contextmanager
def count_dispatches():
    """``with count_dispatches() as c: ...`` — ``c.count`` is the number of
    kernel dispatches issued inside the block."""
    c = DispatchCounter()
    _active_counters.append(c)
    try:
        yield c
    finally:
        _active_counters.remove(c)


def _route(impl: str, t: torch.Tensor) -> str:
    """'ref', 'cuda' (launch the kernel) or 'plain' (CPU tensor)."""
    if impl == "ref":
        return "ref"
    if impl != "cuda":
        raise KeyError(f"impl must be one of {IMPLS}, got {impl!r}")
    if t.device.type == "cuda":
        return "cuda"
    if t.device.type == "cpu":
        return "plain"
    raise ValueError(f"no kernel for tensors on {t.device}")


def fxp_qmatmul(a: torch.Tensor, b: torch.Tensor, fmt: FxpFormat,
                impl: str = "cuda") -> torch.Tensor:
    """Qn.m matmul ``rshift_round_saturate(a @ b)`` in one dispatch.
    a (M, K), b (K, N) in ``fmt.dtype`` -> (M, N)."""
    _tick()
    route = _route(impl, a)
    if route == "ref":
        return ref_ops.fxp_qmatmul_ref(a, b, fmt)
    if route == "cuda":
        return fxp_qmatmul_cuda(a, b, fmt)
    return fxp_qmatmul_plain(a, b, fmt)


def fxp_layer(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
              fmt: FxpFormat, activation: str = "none",
              shift: Optional[int] = None, impl: str = "cuda") -> torch.Tensor:
    """Fused fixed-point layer ``act(qadd(requantize(a @ w), bias))`` in one
    dispatch.  a (M, K), w (K, N), bias (N,) -> (M, N); bias and output in
    ``fmt``; ``shift`` is the requantization amount (None: ``fmt.frac_bits``).
    """
    _tick()
    route = _route(impl, a)
    if route == "ref":
        return ref_ops.fxp_layer_ref(a, w, bias, fmt, activation, shift)
    if route == "cuda":
        return fxp_layer_cuda(a, w, bias, fmt, activation, shift)
    return fxp_layer_plain(a, w, bias, fmt, activation, shift)


def fxp_mlp_model(x: torch.Tensor, weights, biases, schedule: LayerSchedule,
                  impl: str = "cuda") -> torch.Tensor:
    """The whole MLP forward — every layer — in one dispatch.  Callers check
    :func:`repro_torch.kernels.fxp_model.mlp_fits_smem` first (the lowering
    does, and falls back to per-layer :func:`fxp_layer` calls)."""
    _tick()
    weights, biases = tuple(weights), tuple(biases)
    route = _route(impl, x)
    if route == "ref":
        return ref_ops.fxp_mlp_model_ref(x, weights, biases, schedule)
    if route == "cuda":
        return fxp_mlp_model_cuda(x, weights, biases, schedule)
    return fxp_mlp_model_plain(x, weights, biases, schedule)


def fxp_svm_model(qx: torch.Tensor, sv: torch.Tensor, dual: torch.Tensor,
                  icept: torch.Tensor, kind: str, fmt: FxpFormat,
                  out_fmt: FxpFormat, qgamma: int, qcoef0: int, degree: int,
                  dec_shift: int, impl: str = "cuda") -> torch.Tensor:
    """The whole kernel-SVM decision function in one dispatch: x . sv^T,
    the poly/rbf algebra and the decision stage ``k . dual + intercept``.
    ``sv`` is the un-transposed (S, F) matrix; ``qgamma``/``qcoef0`` the
    quantized integer constants.  Callers check
    :func:`repro_torch.kernels.fxp_model.svm_fits_smem` first (the lowering
    does, and falls back to :func:`fxp_qmatmul` + :func:`fxp_layer`)."""
    _tick()
    args = (qx, sv, dual, icept, kind, fmt, out_fmt, qgamma, qcoef0, degree,
            dec_shift)
    route = _route(impl, qx)
    if route == "ref":
        return ref_ops.fxp_svm_model_ref(*args)
    if route == "cuda":
        return fxp_svm_model_cuda(*args)
    return fxp_svm_model_plain(*args)


def tree_predict(tree: TreeArrays, x: torch.Tensor,
                 impl: str = "cuda") -> torch.Tensor:
    """Decision-tree inference in one dispatch.  x (B, F) float32 -> (B,)
    int32 class ids."""
    _tick()
    route = _route(impl, x)
    if route == "ref":
        return ref_ops.tree_ensemble_ref(tree, x)
    if route == "cuda":
        return tree_ensemble_cuda(tree, x)
    return tree_ensemble_plain(tree, x)
