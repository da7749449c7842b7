"""Public wrappers around the fixed-point kernels, and their routing.

The counterpart of :mod:`repro.kernels.ops` for the nine ported kernels.
Each wrapper routes by ``impl`` and by where its tensors lie:

* ``impl="ref"`` — the int64-accumulating oracle of :mod:`.ref`;
* ``impl="cuda"`` — a CUDA tensor launches the hand-written kernel (or the
  launch raises: there is no fallback), a CPU tensor takes the kernel's
  plain PyTorch version, which computes the same bits.

The CUDA kernels mask ragged edges themselves, so no wrapper pads.  The
integer kernels take the reference's block overrides (``blocks=`` on
:func:`fxp_qmatmul` and :func:`fxp_layer`, ``bm=`` on the megakernels,
``be=``/``bm=`` on the fleets).  An override must name a compiled instance
(:mod:`.tune`), else it raises ``ValueError`` on every route; on the
``cuda`` route it launches that instance, and ``None`` asks the tuner, which
on a shape's first call times the candidates on the card (CUDA events, best
of 3 after a warm launch, on zero operands of the bucketed shape and the
real weights; these launches count in ``tune.sweep_launches`` only).  The
plain and ``ref`` routes check an override and ignore it: they compute the
same bits, and they never consult the tuner.  No
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
from typing import Callable, List, Optional, Sequence

import torch

from repro_torch.core.fixedpoint import FxpFormat
from repro_torch.core.trees import TreeArrays

from . import ref as ref_ops
from . import tune
from .flash_attention import flash_attention_cuda, flash_attention_plain
from .fxp_layer import (fxp_layer_cuda, fxp_layer_plain, narrow_occupancy,
                        narrow_plan)
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


# --------------------------------------------------------------------------
# the tuner's runners
# --------------------------------------------------------------------------
# Cycles the stream spins before each timed launch (~0.1 ms on an H100):
# the launch is queued behind the spin, so the events time the kernel and
# not the host's issue of it, which at small batches takes longer.
_HOLD_CYCLES = 200_000


def _event_ms(device: torch.device, call: Callable[[], object]) -> float:
    """Best of 3 CUDA-event times (ms) of ``call`` on the current stream,
    after one warm call; every call is one sweep launch."""
    stream = torch.cuda.current_stream(device)
    call()
    tune.sweep_launches += 1
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.device(device):
            torch.cuda._sleep(_HOLD_CYCLES)
        start.record(stream)
        call()
        end.record(stream)
        tune.sweep_launches += 1
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def _timed_runner(device: torch.device, shape: Sequence[int],
                  dtype: torch.dtype, launch: Callable) -> Callable:
    """The tuner's runner: ``launch(zeros, blocks)`` timed by
    :func:`_event_ms`, on zeros of ``shape`` (the bucketed input; made on the
    first run, so a warm lookup allocates nothing).  Timing depends on the
    shape, not on the values."""
    zeros: List[torch.Tensor] = []

    def run(blocks) -> float:
        if not zeros:
            zeros.append(torch.zeros(tuple(shape), dtype=dtype,
                                     device=device))
        return _event_ms(device, lambda: launch(zeros[0], blocks))

    return run


def _bucket(m: int) -> int:
    return tune.batch_bucket(m, cap=1 << 30)


def _matmul_blocks(kind: str, a: torch.Tensor, k: int, n: int,
                   fmt: FxpFormat, launch: Callable) -> tune.Blocks:
    """The tuned blocking of a matmul on the card (the tuner sweeps
    ``launch`` on the shape's first call)."""
    occupancy = None
    if kind == "layer" and narrow_plan(k, n) is not None:
        occupancy = narrow_occupancy(k, n, fmt.total_bits, a.device)
    m = int(a.shape[0])
    runner = _timed_runner(a.device, (_bucket(m), k), fmt.dtype, launch)
    return tune.matmul_blocks(kind, m, k, n, fmt.total_bits, runner,
                              occupancy=occupancy, device=a.device)


def fxp_qmatmul(a: torch.Tensor, b: torch.Tensor, fmt: FxpFormat,
                impl: str = "cuda",
                blocks: Optional[tune.Blocks] = None) -> torch.Tensor:
    """Qn.m matmul ``rshift_round_saturate(a @ b)`` in one dispatch.
    a (M, K), b (K, N) in ``fmt.dtype`` -> (M, N).  ``blocks`` overrides the
    tuned ``(bm, 64, 128 // P)``."""
    _tick()
    route = _route(impl, a)
    k, n = int(a.shape[-1]), int(b.shape[-1])
    if blocks is not None:
        blocks = tune.check_matmul_blocks("qmatmul", k, n, fmt.total_bits,
                                          blocks)
    if route == "ref":
        return ref_ops.fxp_qmatmul_ref(a, b, fmt)
    if route == "cuda":
        if blocks is None and a.shape[0] > 0 and n > 0 and k > 0:
            blocks = _matmul_blocks(
                "qmatmul", a, k, n, fmt,
                lambda z, blk: fxp_qmatmul_cuda(z, b, fmt, blk, count=False))
        return fxp_qmatmul_cuda(a, b, fmt, blocks)
    return fxp_qmatmul_plain(a, b, fmt)


def fxp_layer(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
              fmt: FxpFormat, activation: str = "none",
              shift: Optional[int] = None, impl: str = "cuda",
              blocks: Optional[tune.Blocks] = None) -> torch.Tensor:
    """Fused fixed-point layer ``act(qadd(requantize(a @ w), bias))`` in one
    dispatch.  a (M, K), w (K, N), bias (N,) -> (M, N); bias and output in
    ``fmt``; ``shift`` is the requantization amount (None: ``fmt.frac_bits``).
    ``blocks`` overrides the tuned blocking: ``(bm, 64, 128 // P)`` on the
    integer tile, ``(rows a group, grid, 128)`` on the narrow route (N <= 32).
    """
    _tick()
    route = _route(impl, a)
    k, n = int(a.shape[-1]), int(w.shape[-1])
    if blocks is not None:
        blocks = tune.check_matmul_blocks("layer", k, n, fmt.total_bits,
                                          blocks)
    if route == "ref":
        return ref_ops.fxp_layer_ref(a, w, bias, fmt, activation, shift)
    if route == "cuda":
        if blocks is None and a.shape[0] > 0 and n > 0 and k > 0:
            blocks = _matmul_blocks(
                "layer", a, k, n, fmt,
                lambda z, blk: fxp_layer_cuda(z, w, bias, fmt, activation,
                                              shift, blk, count=False))
        return fxp_layer_cuda(a, w, bias, fmt, activation, shift, blocks)
    return fxp_layer_plain(a, w, bias, fmt, activation, shift)


def _mlp_dims(k0: int, weights) -> tuple:
    return (int(k0),) + tuple(int(w.shape[-1]) for w in weights)


def fxp_mlp_model(x: torch.Tensor, weights, biases, schedule: LayerSchedule,
                  impl: str = "cuda", bm: Optional[int] = None) -> torch.Tensor:
    """The whole MLP forward — every layer — in one dispatch.  Callers check
    :func:`repro_torch.kernels.fxp_model.mlp_fits_smem` first (the lowering
    does, and falls back to per-layer :func:`fxp_layer` calls).  ``bm``
    overrides the tuned block (16 x warp groups at 8 and 16 bits, rows at
    32)."""
    _tick()
    weights, biases = tuple(weights), tuple(biases)
    route = _route(impl, x)
    bits = schedule[0][1].total_bits
    if bm is not None:
        bm = tune.check_model_bm("mlp", _mlp_dims(x.shape[-1], weights),
                                 bits, bm)
    if route == "ref":
        return ref_ops.fxp_mlp_model_ref(x, weights, biases, schedule)
    if route == "cuda":
        if bm is None and x.shape[0] > 0:
            dims = _mlp_dims(x.shape[-1], weights)
            bm = tune.model_block_m(
                "mlp", int(x.shape[0]), dims, bits, device=x.device,
                runner=_timed_runner(
                    x.device, (_bucket(x.shape[0]), dims[0]), x.dtype,
                    lambda z, b: fxp_mlp_model_cuda(z, weights, biases,
                                                    schedule, b,
                                                    count=False)))
        return fxp_mlp_model_cuda(x, weights, biases, schedule, bm)
    return fxp_mlp_model_plain(x, weights, biases, schedule)


def fxp_svm_model(qx: torch.Tensor, sv: torch.Tensor, dual: torch.Tensor,
                  icept: torch.Tensor, kind: str, fmt: FxpFormat,
                  out_fmt: FxpFormat, qgamma: int, qcoef0: int, degree: int,
                  dec_shift: int, impl: str = "cuda",
                  bm: Optional[int] = None) -> torch.Tensor:
    """The whole kernel-SVM decision function in one dispatch: x . sv^T,
    the poly/rbf algebra and the decision stage ``k . dual + intercept``.
    ``sv`` is the un-transposed (S, F) matrix; ``qgamma``/``qcoef0`` the
    quantized integer constants.  Callers check
    :func:`repro_torch.kernels.fxp_model.svm_fits_smem` first (the lowering
    does, and falls back to :func:`fxp_qmatmul` + :func:`fxp_layer`).
    ``bm`` overrides the tuned rows of a cluster."""
    _tick()
    args = (qx, sv, dual, icept, kind, fmt, out_fmt, qgamma, qcoef0, degree,
            dec_shift)
    route = _route(impl, qx)
    dims = (int(qx.shape[-1]), int(sv.shape[0]), int(dual.shape[-1]))
    if bm is not None:
        bm = tune.check_model_bm(f"svm-{kind}", dims, fmt.total_bits, bm)
    if route == "ref":
        return ref_ops.fxp_svm_model_ref(*args)
    if route == "cuda":
        if bm is None and qx.shape[0] > 0:
            bm = tune.model_block_m(
                f"svm-{kind}", int(qx.shape[0]), dims, fmt.total_bits,
                device=qx.device,
                runner=_timed_runner(
                    qx.device, (_bucket(qx.shape[0]), dims[0]), qx.dtype,
                    lambda z, b: fxp_svm_model_cuda(z, *args[1:], bm=b,
                                                    count=False)))
        return fxp_svm_model_cuda(*args, bm=bm)
    return fxp_svm_model_plain(*args)


def fxp_mlp_fleet(x: torch.Tensor, weights, biases,
                  schedules: FleetSchedules, impl: str = "cuda",
                  be: Optional[int] = None,
                  bm: Optional[int] = None) -> torch.Tensor:
    """E stacked MLP forward passes — the whole fleet — in one dispatch.
    x (E, M, K0); ``weights[i]``/``biases[i]`` carry the leading model axis;
    ``schedules[e]`` is model e's layer plan (they may differ per model).
    Slot e is bit-identical to model e's own :func:`fxp_mlp_model`.  Callers
    check :func:`repro_torch.kernels.fxp_model.mlp_fleet_fits_smem` first
    (:func:`repro_torch.compile.stack_fleet` does).  ``be`` (members a
    block) can only be 1; ``bm`` overrides the tuned block as in
    :func:`fxp_mlp_model`."""
    _tick()
    weights, biases = tuple(weights), tuple(biases)
    schedules = tuple(schedules)
    route = _route(impl, x)
    bits = schedules[0][0][1].total_bits
    if be is not None or bm is not None:
        tune.check_fleet_blocks("mlp", _mlp_dims(x.shape[-1], weights), bits,
                                be, bm)
    if route == "ref":
        return ref_ops.fxp_mlp_fleet_ref(x, weights, biases, schedules)
    if route == "cuda":
        if bm is None and x.shape[1] > 0:
            dims = _mlp_dims(x.shape[-1], weights)
            _, bm = tune.fleet_blocks(
                "mlp", int(x.shape[0]), int(x.shape[1]), dims, bits,
                uniform=len(set(schedules)) == 1, device=x.device,
                runner=_timed_runner(
                    x.device, (x.shape[0], _bucket(x.shape[1]), dims[0]),
                    x.dtype,
                    lambda z, blk: fxp_mlp_fleet_cuda(z, weights, biases,
                                                      schedules, blk[1],
                                                      count=False)))
        return fxp_mlp_fleet_cuda(x, weights, biases, schedules, bm)
    return fxp_mlp_fleet_plain(x, weights, biases, schedules)


def fxp_svm_fleet(qx: torch.Tensor, sv: torch.Tensor, dual: torch.Tensor,
                  icept: torch.Tensor, kind: str, params: SvmFleetParams,
                  impl: str = "cuda", be: Optional[int] = None,
                  bm: Optional[int] = None) -> torch.Tensor:
    """E stacked kernel-SVM decision functions in one dispatch.  qx (E, M,
    F), sv (E, S, F), dual (E, S, C), icept (E, C); ``params[e]`` = model
    e's (fmt, out_fmt, qgamma, qcoef0, degree, dec_shift).  Slot e is
    bit-identical to model e's own :func:`fxp_svm_model`.  ``be`` can only
    be 1; ``bm`` overrides the tuned rows of a cluster."""
    _tick()
    params = tuple(tuple(p) for p in params)
    route = _route(impl, qx)
    bits = params[0][0].total_bits
    dims = (int(qx.shape[-1]), int(sv.shape[-2]), int(dual.shape[-1]))
    if be is not None or bm is not None:
        tune.check_fleet_blocks(f"svm-{kind}", dims, bits, be, bm)
    if route == "ref":
        return ref_ops.fxp_svm_fleet_ref(qx, sv, dual, icept, kind, params)
    if route == "cuda":
        if bm is None and qx.shape[1] > 0:
            _, bm = tune.fleet_blocks(
                f"svm-{kind}", int(qx.shape[0]), int(qx.shape[1]), dims, bits,
                uniform=len(set(params)) == 1, device=qx.device,
                runner=_timed_runner(
                    qx.device, (qx.shape[0], _bucket(qx.shape[1]), dims[0]),
                    qx.dtype,
                    lambda z, blk: fxp_svm_fleet_cuda(z, sv, dual, icept,
                                                      kind, params, blk[1],
                                                      count=False)))
        return fxp_svm_fleet_cuda(qx, sv, dual, icept, kind, params, bm)
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
                    window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """(BH, S, dh) softmax attention, causal or full, any S, in one
    dispatch; float32 or bfloat16.  k and v hold BH / G rows, G >= 1: query
    row ``bh`` reads key/value row ``bh // G`` (G = 1 is the JAX kernel's
    equal-shape signature).  ``window`` (an int >= 1) masks the scores
    where ``q - k >= window``: a sliding window, causal or not.  ``scale``
    multiplies the scores (default ``float32(1/sqrt(dh))``)."""
    _tick()
    route = _route(impl, q)
    # a scale only where the caller states one: the default calls stay as
    # they were
    extra = {} if scale is None else {"scale": scale}
    if route == "cuda":
        _no_backward("flash_attention", q, k, v)
        return flash_attention_cuda(q, k, v, causal, window, **extra)
    return flash_attention_plain(q, k, v, causal, window=window, **extra)
