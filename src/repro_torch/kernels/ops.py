"""Public wrappers around the fixed-point kernels, and their routing.

The counterpart of :mod:`repro.kernels.ops` for the nine ported kernels.
Each wrapper routes by ``impl`` and by where its tensors lie:

* ``impl="ref"`` — the int64-accumulating oracle of :mod:`.ref`;
* ``impl="cuda"`` — a CUDA tensor launches the hand-written kernel (or the
  launch raises: there is no fallback), a CPU tensor takes the kernel's
  plain PyTorch version, which computes the same bits.

The CUDA kernels mask ragged edges themselves, so no wrapper pads.  No
kernel has a backward: the float kernels' wrappers (``flash_attention``,
``pwl_activation``) raise ``RuntimeError`` rather than launch on an input
that requires grad while grad is enabled, since the launch writes a fresh
tensor and would cut the gradient without a word.
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
from .flash_attention import flash_attention_cuda, flash_attention_plain
from .fxp_layer import fxp_layer_cuda, fxp_layer_plain
from .fxp_model import (FleetSchedules, LayerSchedule, SvmFleetParams,
                        fxp_mlp_fleet_cuda, fxp_mlp_fleet_plain,
                        fxp_mlp_model_cuda, fxp_mlp_model_plain,
                        fxp_svm_fleet_cuda, fxp_svm_fleet_plain,
                        fxp_svm_model_cuda, fxp_svm_model_plain)
from .fxp_qmatmul import fxp_qmatmul_cuda, fxp_qmatmul_plain
from .pwl_activation import (_check_bias, pwl_activation_cuda,
                             pwl_activation_plain)
from .tree_ensemble import tree_ensemble_cuda, tree_ensemble_plain

__all__ = ["fxp_qmatmul", "fxp_layer", "fxp_mlp_model", "fxp_svm_model",
           "fxp_mlp_fleet", "fxp_svm_fleet", "pwl_activation", "tree_predict",
           "flash_attention", "count_dispatches", "IMPLS"]

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


def _no_backward(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise before a launch whose output autograd would need to
    differentiate: the kernels have no backward."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input requires "
            f"grad; train through the reference's route "
            f"(repro_torch.lm.model.loss_fn), or call it under "
            f"torch.no_grad()")


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


def fxp_mlp_fleet(x: torch.Tensor, weights, biases,
                  schedules: FleetSchedules, impl: str = "cuda") -> torch.Tensor:
    """E stacked MLP forward passes — the whole fleet — in one dispatch.
    x (E, M, K0); ``weights[i]``/``biases[i]`` carry the leading model axis;
    ``schedules[e]`` is model e's layer plan (they may differ per model).
    Slot e is bit-identical to model e's own :func:`fxp_mlp_model`.  Callers
    check :func:`repro_torch.kernels.fxp_model.mlp_fleet_fits_smem` first
    (:func:`repro_torch.compile.stack_fleet` does)."""
    _tick()
    weights, biases = tuple(weights), tuple(biases)
    schedules = tuple(schedules)
    route = _route(impl, x)
    if route == "ref":
        return ref_ops.fxp_mlp_fleet_ref(x, weights, biases, schedules)
    if route == "cuda":
        return fxp_mlp_fleet_cuda(x, weights, biases, schedules)
    return fxp_mlp_fleet_plain(x, weights, biases, schedules)


def fxp_svm_fleet(qx: torch.Tensor, sv: torch.Tensor, dual: torch.Tensor,
                  icept: torch.Tensor, kind: str, params: SvmFleetParams,
                  impl: str = "cuda") -> torch.Tensor:
    """E stacked kernel-SVM decision functions in one dispatch.  qx (E, M,
    F), sv (E, S, F), dual (E, S, C), icept (E, C); ``params[e]`` = model
    e's (fmt, out_fmt, qgamma, qcoef0, degree, dec_shift).  Slot e is
    bit-identical to model e's own :func:`fxp_svm_model`."""
    _tick()
    params = tuple(tuple(p) for p in params)
    route = _route(impl, qx)
    if route == "ref":
        return ref_ops.fxp_svm_fleet_ref(qx, sv, dual, icept, kind, params)
    if route == "cuda":
        return fxp_svm_fleet_cuda(qx, sv, dual, icept, kind, params)
    return fxp_svm_fleet_plain(qx, sv, dual, icept, kind, params)


def pwl_activation(x: torch.Tensor, variant: str = "pwl4",
                   impl: str = "cuda",
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The float PWL sigmoid/silu family over any-shaped input, in one
    dispatch: ``variant(x + bias)`` with an optional ``bias`` over the last
    axis, the sum rounded to ``x``'s dtype (float32, float16 or bfloat16
    on the card; the plain version and ``ref`` take any float dtype; all
    compute the variant in float32)."""
    _tick()
    route = _route(impl, x)
    if route == "ref":
        if bias is not None:
            _check_bias(x, bias)
            x = x + bias
        return ref_ops.pwl_activation_ref(x, variant)
    if route == "cuda":
        _no_backward("pwl_activation", x, bias)
        return pwl_activation_cuda(x, variant, bias)
    return pwl_activation_plain(x, variant, bias)


def tree_predict(tree: TreeArrays, x: torch.Tensor,
                 impl: str = "cuda") -> torch.Tensor:
    """Decision-tree inference in one dispatch.  x (B, F) float32 rows or
    the quantized container (int8, int16, int32; the ``cuda`` route casts
    each feature it reads to float32 itself) -> (B,) int32 class ids."""
    _tick()
    route = _route(impl, x)
    if route == "ref":
        return ref_ops.tree_ensemble_ref(tree, x)
    if route == "cuda":
        return tree_ensemble_cuda(tree, x)
    return tree_ensemble_plain(tree, x)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, impl: str = "cuda",
                    window: Optional[int] = None) -> torch.Tensor:
    """(BH, S, dh) softmax attention, causal or full, any S, in one
    dispatch; float32 or bfloat16.  k and v hold BH / G rows, G >= 1: query
    row ``bh`` reads key/value row ``bh // G`` (G = 1 is the JAX kernel's
    equal-shape signature).  ``window`` (an int >= 1) masks the scores
    where ``q - k >= window``: a sliding window, causal or not."""
    _tick()
    route = _route(impl, q)
    if route == "cuda":
        _no_backward("flash_attention", q, k, v)
        return flash_attention_cuda(q, k, v, causal, window)
    return flash_attention_plain(q, k, v, causal, window=window)
