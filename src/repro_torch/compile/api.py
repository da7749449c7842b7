"""The staged compiler entry point: ``compile(model, Target(...))``.

The counterpart of :mod:`repro.compile.api`:

    extract_params -> calibrate -> quantize -> lower -> specialize

``calibrate`` runs only for calibrated (``auto*``) targets and stays on the
host in numpy.  ``lower`` places the quantized program on the artifact's
device: CUDA unless the caller passes ``device="cpu"``, which runs the
kernels' plain PyTorch versions on the host (the tests do).  With no CUDA
device and no explicit ``"cpu"``, compiling raises: the port never carries
on on the host by itself.  The ``emit`` backend lowers as ``ref`` on that
device and serves through the generated C on the host (:func:`_specialize`).
Mesh specialization arrives with a later slice.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.fixedpoint import FxpStats

from .artifact import CompiledArtifact
from .fingerprint import fingerprint_params
from .registry import Lowered, get_lowering, model_kind
from .target import Target

__all__ = ["compile", "compile_from_params", "resolve_device"]


def resolve_device(device: Any = None) -> torch.device:
    """The device an artifact runs on: CUDA by default, the host only when
    asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch artifacts run on the GPU by "
                "default; pass device='cpu' to run the kernels' plain "
                "PyTorch versions on the host")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but no CUDA "
                               f"device is available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}: use 'cuda' or 'cpu'")
    return device


def _subtract_phantom_rows(stats: FxpStats, k: int, pad_row_cache: list,
                           probe: Callable) -> FxpStats:
    """Remove ``k`` zero-pad rows' contribution from ``stats``.

    Every counter is elementwise, so an all-zeros batch of N rows yields N
    copies of one pad row's events; ``probe()`` runs such a batch once and
    returns ``(n_rows, FxpStats)``, memoized in ``pad_row_cache``.
    """
    if not pad_row_cache:
        n, zstats = probe()
        pad_row_cache.append(tuple(
            int(v) // n for v in (zstats.overflow, zstats.underflow,
                                  zstats.total)))
    per = pad_row_cache[0]
    return FxpStats(*(np.int64(int(v) - k * p) for v, p in zip(
        (stats.overflow, stats.underflow, stats.total), per)))


def _emit_predict(program: Lowered, target: Target, kind: str) -> Callable:
    """The ``emit`` backend's predict: the lowering's ``emit_spec`` templated
    into a freestanding C translation unit, built with the host's C compiler
    on the first predict (emission itself needs no toolchain; without one
    the first predict raises ``EmitToolchainError``).  Inputs are quantized
    on the host with the tensor ops' rounding and the compiled binary gives
    the labels; stats cover the input quantization only (the C program has
    no stats plumbing)."""
    from repro_torch import emit as emit_mod

    spec = (program.extras or {}).get("emit_spec")
    if spec is None:
        if not target.is_quantized:
            raise TypeError(
                "the 'emit' backend serves quantized targets only — "
                "float models have no fixed-point program to emit "
                "(use number_format='fxp*'/'auto*')")
        raise TypeError(
            f"the '{kind or 'requested'}' lowering does not support the "
            f"'emit' backend (no emit_spec); C emission covers the "
            f"classifier lowerings (tree/logistic/mlp/svm-*)")
    runner_cell: list = []

    def predict(x):
        if not runner_cell:
            src = emit_mod.emit_c(spec, kind=kind,
                                  target_name=target.number_format)
            runner_cell.append(emit_mod.CRunner(
                src, emit_mod.input_format(spec)))
        labels, stats = runner_cell[0].predict(x)
        return torch.from_numpy(labels), stats

    return predict


def _specialize(program: Lowered, target: Target, kind: str = "") -> Callable:
    """Stage 4: the backend and the batch policy.  ``emit`` serves through
    the generated C (:func:`_emit_predict`); ``fixed`` pads every call up to
    ``batch_size`` (the embedded static-allocation posture), rejects larger
    batches and slices the padded rows off the output."""
    predict = program.predict
    if target.backend == "emit":
        predict = _emit_predict(program, target, kind)
    if target.batch_policy != "fixed":
        return predict
    inner = predict
    batch_size = target.batch_size
    pad_row_stats: list = []

    def predict(x):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x, np.float32))
        n = x.shape[0]
        if n > batch_size:
            raise ValueError(
                f"batch {n} exceeds the artifact's fixed batch_size "
                f"{batch_size}; recompile with a larger Target.batch_size")
        if n == batch_size:
            return inner(x)
        pad = x.new_zeros((batch_size - n,) + tuple(x.shape[1:]))
        out, stats = inner(torch.cat([x, pad]))
        if not target.is_quantized:
            return out[:n], stats  # float stats are structurally zero
        stats = _subtract_phantom_rows(
            stats, batch_size - n, pad_row_stats,
            lambda: (batch_size, inner(x.new_zeros(
                (batch_size,) + tuple(x.shape[1:])))[1]))
        return out[:n], stats

    return predict


def compile_from_params(kind: str, params: Any, target: Target,
                        calibration: Any = None, plan: Any = None,
                        device: Any = None) -> CompiledArtifact:
    """Run the calibrate/quantize/lower/specialize stages on already-extracted
    params (numpy).  Calibrated targets need a ``calibration`` batch or an
    already-frozen ``plan``."""
    from repro_torch.quant import make_plan

    dev = resolve_device(device)
    lowering = get_lowering(kind)
    if target.is_calibrated:
        if plan is None:
            plan = make_plan(lowering, params, target, calibration)
    else:
        plan = None  # fixed/float targets ignore stray plans
    qparams = lowering.quantize(params, target, plan)
    program = lowering.lower(qparams, target, plan, dev)
    return CompiledArtifact(kind=kind, target=target, params=params,
                            _predict=_specialize(program, target, kind),
                            device=dev,
                            flash_bytes=program.flash_bytes,
                            sram_bytes=program.sram_bytes,
                            extras=program.extras,
                            fingerprint=fingerprint_params(kind, params),
                            quant_plan=plan)


def compile(model: Any, target: Optional[Target] = None,
            calibration: Any = None, device: Any = None,
            **kwargs) -> CompiledArtifact:
    """Compile a trained model into an inference artifact.

    ``target`` may be omitted and given as keyword fields instead:
    ``compile(model, number_format="fxp16", backend="cuda")``.
    ``calibration`` is a sample input batch, required by ``auto*`` formats.
    ``device`` defaults to the current CUDA device and raises without one;
    pass ``device="cpu"`` to run on the host.
    """
    if target is not None and kwargs:
        raise TypeError("pass either a Target or keyword fields, not both")
    tgt = target if target is not None else Target(**kwargs)
    kind = model_kind(model)
    params = get_lowering(kind).extract_params(model)
    return compile_from_params(kind, params, tgt, calibration=calibration,
                               device=device)
