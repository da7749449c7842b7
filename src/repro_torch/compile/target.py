"""The frozen :class:`Target` spec — *what* to compile for, in one value.

The counterpart of :mod:`repro.compile.target`: the serving number format
(paper C1), the sigmoid replacement (C3), the tree inference layout (C4),
the backend that executes the artifact, and the batch policy.

Backends: ``ref`` runs the wide-accumulating oracle semantics in PyTorch
ops; ``cuda`` is the counterpart of the reference package's ``pallas``:
the hand-written CUDA kernels on a card, or their plain PyTorch versions
when the artifact was compiled for ``device="cpu"``.  The ``emit`` backend
(C emission) arrives with its own slice; asking for it raises.  The LM
fields ``weight_scale`` and ``kv_cache`` are read by the ``lm`` lowering,
which ignores ``backend`` as the reference's does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.activations import SIGMOID_NAMES
from repro_torch.core.fixedpoint import FXP8, FXP16, FXP32, FxpFormat
from repro_torch.core.trees import TREE_LAYOUTS

__all__ = ["Target", "NUMBER_FORMATS", "CALIBRATED_FORMATS", "BACKENDS",
           "BATCH_POLICIES", "TREE_LAYOUTS"]

NUMBER_FORMATS: Dict[str, Optional[FxpFormat]] = {
    "flt": None,
    "fxp32": FXP32,
    "fxp16": FXP16,
    "fxp8": FXP8,
}

# Calibrated ("auto") formats: the name fixes only the container width; the
# per-tensor Qn.m split comes from a calibration-derived QuantPlan.
CALIBRATED_FORMATS: Dict[str, int] = {
    "auto32": 32,
    "auto16": 16,
    "auto8": 8,
}

BACKENDS = ("ref", "cuda")
BATCH_POLICIES = ("dynamic", "fixed")


@dataclasses.dataclass(frozen=True)
class Target:
    """Frozen compilation target for :func:`repro_torch.compile.compile`.

    * ``number_format`` — ``flt`` | ``fxp32`` (Q22.10) | ``fxp16`` (Q12.4) |
      ``fxp8`` (Q5.2) | ``auto32``/``auto16``/``auto8`` (calibrated:
      per-tensor Qn.m from ``compile(..., calibration=x)``).
    * ``sigmoid`` — ``exact`` | ``rational`` | ``pwl2`` | ``pwl4``.
    * ``tree_layout`` — ``iterative`` | ``ifelse`` | ``oblivious``.
    * ``backend`` — ``ref`` | ``cuda`` (see the module docstring).
    * ``batch_policy`` — ``dynamic`` or ``fixed`` (padded to ``batch_size``,
      larger batches rejected).
    * ``weight_scale`` — LM weight-only scale mode: ``qnm`` (paper-faithful
      global power-of-two scale) or ``per_channel``.
    * ``kv_cache`` — LM decode cache: ``native`` dtype or ``int8``.
    For the ``lm`` lowering, ``fxp8``/``fxp16`` select int8/int16
    weight-only quantization (calibrated formats are classifier-only) and
    ``sigmoid`` the gate sigmoid/SiLU variant.
    """

    number_format: str = "flt"
    sigmoid: str = "exact"
    tree_layout: str = "iterative"
    backend: str = "ref"
    batch_policy: str = "dynamic"
    batch_size: Optional[int] = None
    weight_scale: str = "qnm"
    kv_cache: str = "native"

    def __post_init__(self):
        if (self.number_format not in NUMBER_FORMATS
                and self.number_format not in CALIBRATED_FORMATS):
            raise KeyError(
                f"number_format must be one of "
                f"{list(NUMBER_FORMATS) + list(CALIBRATED_FORMATS)}")
        if self.sigmoid not in SIGMOID_NAMES:
            raise KeyError(f"sigmoid must be one of {SIGMOID_NAMES}")
        if self.tree_layout not in TREE_LAYOUTS:
            raise KeyError(f"tree_layout must be one of {TREE_LAYOUTS}")
        if self.backend == "emit":
            raise NotImplementedError(
                "the 'emit' backend (C emission) is not ported to "
                "repro_torch yet; use the reference package's repro.emit")
        if self.backend not in BACKENDS:
            raise KeyError(f"backend must be one of {BACKENDS}")
        if self.batch_policy not in BATCH_POLICIES:
            raise KeyError(f"batch_policy must be one of {BATCH_POLICIES}")
        if self.batch_policy == "fixed" and not self.batch_size:
            raise ValueError("batch_policy='fixed' requires batch_size")
        if self.weight_scale not in ("qnm", "per_channel"):
            raise KeyError("weight_scale must be 'qnm' or 'per_channel'")
        if self.kv_cache not in ("native", "int8"):
            raise KeyError("kv_cache must be 'native' or 'int8'")

    @property
    def fmt(self) -> Optional[FxpFormat]:
        """The global fixed-point format, or None for float serving
        (calibrated targets have none: their formats live in the plan)."""
        if self.is_calibrated:
            raise ValueError(
                f"'{self.number_format}' is a calibrated format: per-tensor "
                f"formats live in the QuantPlan, not on the Target")
        return NUMBER_FORMATS[self.number_format]

    @property
    def is_calibrated(self) -> bool:
        return self.number_format in CALIBRATED_FORMATS

    @property
    def is_quantized(self) -> bool:
        return self.number_format != "flt"

    @property
    def container_bits(self) -> Optional[int]:
        if self.is_calibrated:
            return CALIBRATED_FORMATS[self.number_format]
        fmt = NUMBER_FORMATS[self.number_format]
        return None if fmt is None else fmt.total_bits

    def replace(self, **kwargs) -> "Target":
        return dataclasses.replace(self, **kwargs)
