"""Decorator-based lowering registry: model kind -> staged compiler.

The counterpart of :mod:`repro.compile.registry`.  A lowering implements

    extract_params(model) -> params              # numpy dict (serializable)
    calibrate(params, x, target) -> Calibration  # auto* formats only
    quantize(params, target, plan) -> qparams
    lower(qparams, target, plan, device) -> Lowered

Models declare their kind through a ``compile_kind`` attribute, so the
registry never imports model classes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.fixedpoint import FxpStats

from .target import Target

__all__ = ["Lowered", "Lowering", "register_lowering", "get_lowering",
           "lowering_kinds", "model_kind"]


@dataclasses.dataclass
class Lowered:
    """Output of a lowering's ``lower`` stage.

    ``predict(x) -> (labels, FxpStats)`` is the raw program the specialize
    stage wraps (labels: int32 tensor on the artifact's device);
    ``flash_bytes``/``sram_bytes`` model the artifact footprint; ``extras``
    carries kind-specific data (``kernel_strategy``, ``emit_spec``).
    """

    predict: Callable[[Any], Tuple[torch.Tensor, FxpStats]]
    flash_bytes: int = 0
    sram_bytes: int = 0
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)


class Lowering:
    """Base class: one registered compiler per model kind."""

    kinds: Tuple[str, ...] = ()

    def extract_params(self, model: Any) -> Dict[str, Any]:
        raise NotImplementedError

    def calibrate(self, params: Dict[str, Any], x: Any, target: Target):
        """Observed tensor ranges for calibrated targets (see quant)."""
        raise NotImplementedError(
            f"the '{type(self).__name__}' lowering does not support "
            f"calibrated (auto*) number formats")

    def quantize(self, params: Dict[str, Any], target: Target,
                 plan: Optional[Any] = None) -> Dict[str, Any]:
        return params

    def lower(self, qparams: Dict[str, Any], target: Target,
              plan: Optional[Any], device: torch.device) -> Lowered:
        raise NotImplementedError


_LOWERINGS: Dict[str, Lowering] = {}


def register_lowering(*kinds: str) -> Callable[[type], type]:
    """Class decorator: ``@register_lowering("mlp")`` registers an instance
    of the decorated :class:`Lowering` subclass for each kind."""

    def deco(cls: type) -> type:
        inst = cls()
        inst.kinds = kinds
        for kind in kinds:
            _LOWERINGS[kind] = inst
        return cls

    return deco


def get_lowering(kind: str) -> Lowering:
    try:
        return _LOWERINGS[kind]
    except KeyError:
        raise KeyError(f"no lowering registered for kind '{kind}'; "
                       f"known: {sorted(_LOWERINGS)}")


def lowering_kinds() -> Tuple[str, ...]:
    return tuple(sorted(_LOWERINGS))


def model_kind(model: Any) -> str:
    """Resolve a model object to its registered lowering kind."""
    kind = getattr(model, "compile_kind", None)
    if isinstance(kind, str):
        return kind
    raise TypeError(
        f"{type(model).__name__} declares no 'compile_kind'; "
        f"cannot compile it (known kinds: {lowering_kinds()})")
