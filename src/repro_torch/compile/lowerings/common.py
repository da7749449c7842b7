"""Helpers shared by the classifier lowerings."""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import fixedpoint as fxp
from repro_torch.core.fixedpoint import STATS_DTYPE, FxpFormat, FxpStats

__all__ = ["zero_stats", "q", "qx_with_stats", "nbytes", "elem_bytes",
           "resolve_formats", "as_input", "argmax_first",
           "require_full_float32"]


def zero_stats(device: torch.device) -> FxpStats:
    z = torch.zeros((), dtype=STATS_DTYPE, device=device)
    return FxpStats(z, z, z)


def q(x: np.ndarray, fmt: FxpFormat, device: torch.device) -> torch.Tensor:
    """Quantize static parameters on the host and place them on ``device``."""
    return fxp.quantize(torch.from_numpy(np.asarray(x, np.float32)),
                        fmt).to(device)


def qx_with_stats(x: torch.Tensor,
                  fmt: FxpFormat) -> Tuple[torch.Tensor, FxpStats]:
    return fxp.quantize_with_stats(x, fmt)


def as_input(x: Any, device: torch.device,
             ranks: Tuple[int, ...] = (2,)) -> torch.Tensor:
    """A predict input as a float32 tensor on ``device`` (numpy arrays are
    copied over; tensors already there are used as they are).  A tensor in
    pinned host memory (the serving plane's staging buffers) is copied to
    the card without blocking, ordered on the current stream; the caller
    keeps the buffer unchanged until the predict's result has been read.
    Raises ``ValueError`` unless the input's rank is one of ``ranks``: an
    artifact's predict takes a 2-D (N, F) batch (a single row is
    ``x[None]``), a fleet's also (E, M, F) rows."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    if x.dim() not in ranks:
        raise ValueError(f"predict takes a {' or '.join(map(str, ranks))}-D "
                         f"input ((N, F) rows), got shape {tuple(x.shape)}")
    pinned = (device.type == "cuda" and x.device.type == "cpu"
              and x.is_pinned())
    return x.to(device=device, dtype=torch.float32, non_blocking=pinned)


def require_full_float32(device: torch.device) -> None:
    """Refuse to run a float target's products below full float32.

    The float targets' matmuls must be full float32, as the reference
    computes them.  That is PyTorch's default; a process that turned TF32
    (or bf16) on for float32 matmuls would change their labels.  The float
    predicts call this on every run and raise; they change no setting."""
    if device.type == "cuda":
        backend = torch.backends.cuda.matmul
    else:
        backend = getattr(torch.backends.mkldnn, "matmul", None)
    precision = getattr(backend, "fp32_precision", None)
    if precision is None:  # a PyTorch without the fp32_precision settings
        reduced = (device.type == "cuda"
                   and torch.backends.cuda.matmul.allow_tf32)
    else:
        reduced = precision not in ("ieee", "none")
    if reduced:
        raise RuntimeError(
            f"float32 matmuls on {device.type} run at reduced precision "
            f"({precision or 'tf32'}); a float target needs full float32: "
            f"set torch.backends.{'cuda' if device.type == 'cuda' else 'mkldnn'}"
            f".matmul.fp32_precision = 'ieee'")


def argmax_first(h: torch.Tensor) -> torch.Tensor:
    """Row-wise argmax taking the first maximum, as ``jnp.argmax`` does —
    saturated logits at ``qmax`` tie often — as int32."""
    n = h.shape[-1]
    idx = torch.arange(n, device=h.device, dtype=torch.int32)
    best = h.max(dim=-1, keepdim=True).values
    return torch.where(h == best, idx, n).min(dim=-1).values.to(torch.int32)


def nbytes(*arrays) -> int:
    return int(sum(fxp.to_numpy(a).nbytes for a in arrays))


def elem_bytes(fmt: FxpFormat | None) -> int:
    return 4 if fmt is None else fmt.total_bits // 8


def resolve_formats(target, plan) -> Optional[Callable[[str], FxpFormat]]:
    """Per-tensor format lookup ``F(path) -> FxpFormat``: through the
    QuantPlan for calibrated targets, the Target's single format for fixed
    ones, None for float targets."""
    if target.is_calibrated:
        if plan is None:
            raise ValueError(
                f"Target '{target.number_format}' needs a QuantPlan; compile "
                f"through repro_torch.compile with a calibration batch")
        if plan.total_bits != target.container_bits:
            raise ValueError(
                f"QuantPlan container width {plan.total_bits} does not match "
                f"Target '{target.number_format}'")
        return plan.fmt
    fixed = target.fmt
    if fixed is None:
        return None
    return lambda path: fixed
