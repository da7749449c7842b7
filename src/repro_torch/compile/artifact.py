"""The compiled artifact — the paper's "output file" analogue.

The counterpart of :mod:`repro.compile.artifact`, in memory only: archives
(``save``/``load``) arrive with their own slice.  A :class:`CompiledArtifact`
holds the extracted parameters, the specialized predict program and the
memory model of one compile.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.fixedpoint import FxpStats

from .target import Target

__all__ = ["CompiledArtifact"]


@dataclasses.dataclass
class CompiledArtifact:
    """Frozen inference artifact: parameters + specialized predict program."""

    kind: str  # 'logistic' | 'mlp'
    target: Target
    params: Optional[Dict[str, Any]]  # extracted (float) parameters
    _predict: Callable[..., Tuple[torch.Tensor, FxpStats]] = dataclasses.field(repr=False)
    device: torch.device = torch.device("cpu")
    flash_bytes: int = 0  # read-only parameter memory
    sram_bytes: int = 0  # activation scratch
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict, repr=False)
    # sha256 of the extracted parameter tree (the reference's fingerprint)
    fingerprint: str = ""
    # Calibrated per-tensor formats (repro_torch.quant.QuantPlan); None for
    # fixed and float targets.
    quant_plan: Optional[Any] = dataclasses.field(default=None, repr=False)

    @property
    def plan_key(self) -> Optional[Tuple]:
        """Hashable QuantPlan descriptor (None = no calibrated plan)."""
        return None if self.quant_plan is None else self.quant_plan.descriptor()

    @property
    def kernel_strategy(self) -> Optional[str]:
        """How the ``cuda`` backend runs the forward pass: ``"megakernel"``
        (one launch), ``"per-layer"`` (one ``fxp_layer`` launch per layer),
        or None where the distinction does not exist."""
        return self.extras.get("kernel_strategy")

    @property
    def cache_key(self) -> Tuple[str, Target, Optional[Tuple], Optional[str],
                                 str]:
        # kernel_strategy keys too: the routing depends on the shared-memory
        # budget override, which is ambient state beyond the Target.
        return (self.fingerprint, self.target, self.plan_key,
                self.kernel_strategy, str(self.device))

    def predict(self, x) -> np.ndarray:
        """int32 class labels on the host."""
        out, _ = self._predict(x)
        return out.cpu().numpy().astype(np.int32, copy=False)

    def predict_with_stats(self, x) -> Tuple[np.ndarray, Dict[str, float]]:
        out, stats = self._predict(x)
        over, under, total = (int(stats.overflow), int(stats.underflow),
                              int(stats.total))
        denom = max(total, 1)
        return out.cpu().numpy().astype(np.int32, copy=False), {
            "overflow": over,
            "underflow": under,
            "total": total,
            "overflow_rate": float(over / denom),
            "underflow_rate": float(under / denom),
        }

    def memory_report(self) -> Dict[str, int]:
        return {"flash": self.flash_bytes, "sram": self.sram_bytes,
                "total": self.flash_bytes + self.sram_bytes}
