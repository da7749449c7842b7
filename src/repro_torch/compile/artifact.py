"""The compiled artifact — the paper's "output file" analogue.

The counterpart of :mod:`repro.compile.artifact`, in memory only: archives
(``save``/``load``, with ``include_c``) arrive with their own slice.  A
:class:`CompiledArtifact` holds the extracted parameters, the specialized
predict program and the memory model of one compile, and what the serving
plane reads off it (``max_supported_batch``, ``pretune``, and
``mesh``/``replicas`` of a single-device artifact).  It emits its C
(:meth:`CompiledArtifact.emit_c`) and reports its footprint, measured from
the compiled C where asked (:meth:`CompiledArtifact.report`).
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

    kind: str  # a registered lowering kind ('tree', 'mlp', 'svm-rbf', ...)
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

    # A single-device artifact: mesh specialization (data-parallel replicas
    # over several cards) arrives with the multi-GPU slice.  The serving
    # plane reads both, as it does the reference's.
    mesh = None
    replicas = 1

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

    @property
    def max_supported_batch(self) -> Optional[int]:
        """Largest batch one predict call accepts (None = unbounded): the
        micro-batching scheduler clamps its bucket ladder to it, so a
        ``batch_policy='fixed'`` artifact is never fed a batch it would
        reject."""
        if self.target.batch_policy == "fixed":
            return self.target.batch_size
        return None

    def pretune(self, example, batches: Optional[Tuple[int, ...]] = None
                ) -> "CompiledArtifact":
        """Warm the artifact for the serving bucket ladder, ahead of traffic.

        The port has no block-size tuner sweep yet (the kernels' block sizes
        are fixed in their sources), so this runs one ``predict`` on zero
        rows shaped like ``example`` at each batch size in ``batches``
        (default: the power-of-two ladder up to ``max_supported_batch``, or
        64).  The first call builds and loads the artifact's CUDA kernels,
        so the first live request pays neither the build nor a cold
        allocation.  Returns self.
        """
        row = np.asarray(example)
        if row.ndim > 1:
            row = row[0]
        if batches is None:
            top = self.max_supported_batch or 64
            ladder, b = [], 1
            while b < top:
                ladder.append(b)
                b *= 2
            batches = tuple(ladder) + (top,)
        for b in batches:
            self.predict(np.zeros((int(b),) + row.shape, row.dtype))
        return self

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

    # -- C emission ----------------------------------------------------------
    def emit_c(self) -> str:
        """The freestanding C99 translation unit for this artifact.

        Available for any quantized classifier artifact regardless of its
        backend (the emit spec rides on the lowered program); raises
        :class:`repro_torch.emit.EmitError` for float targets and the ``lm``
        lowering.  Emission is pure templating: no C compiler is needed
        (only :meth:`report`'s measured sizes and the ``emit`` backend's
        replay build the C).
        """
        from repro_torch import emit as emit_mod

        return emit_mod.emit_artifact_c(self)

    # -- memory model --------------------------------------------------------
    def memory_report(self) -> Dict[str, int]:
        return {"flash": self.flash_bytes, "sram": self.sram_bytes,
                "total": self.flash_bytes + self.sram_bytes}

    def report(self, x: Optional[np.ndarray] = None,
               y: Optional[np.ndarray] = None,
               measure_c: Any = "auto") -> Dict[str, Any]:
        """Paper-style resource report for this artifact.

        Always includes the memory model and the per-tensor number formats
        (the QuantPlan table for calibrated targets, the single global
        format otherwise).  ``model_bytes`` is computed from the *actual
        quantized tensors* (per-tensor container widths), not a float-size
        estimate.  Given an evaluation batch ``x``, adds the observed
        saturation/underflow counts (paper §V-A); given labels ``y`` as
        well, adds accuracy and the delta vs a float recompile of the same
        parameters on the ``ref`` backend and the artifact's device (paper
        Tables V-VII).

        ``measure_c`` controls the *measured* footprint (paper Tables
        IV-VI): compile the generated C freestanding with the host's C
        compiler and report its real ``.text``/``.rodata``/``.data`` section
        sizes as ``c_sections`` (with ``model_bytes_measured = flash``).
        ``"auto"`` measures for ``emit``-backend artifacts when a toolchain
        exists and skips otherwise, as the reference does (the measurement
        is of the host's C build; it stands in for no device); ``True``
        forces measurement (raising without a C compiler or for
        un-emittable artifacts); ``False`` disables it.
        """
        rep: Dict[str, Any] = {
            "kind": self.kind,
            "number_format": self.target.number_format,
            "backend": self.target.backend,
            "model_bytes": self.flash_bytes,
            "sram_bytes": self.sram_bytes,
        }
        want_measure = (measure_c is True
                        or (measure_c == "auto"
                            and self.target.backend == "emit"))
        if want_measure:
            try:
                from repro_torch import emit as emit_mod

                rep["c_sections"] = emit_mod.measure_artifact(self)
                rep["model_bytes_measured"] = rep["c_sections"]["flash"]
            except Exception:
                if measure_c is True:
                    raise
                # auto mode: no toolchain / un-emittable — estimate only.
        if self.quant_plan is not None:
            rep["formats"] = {
                path: repr(self.quant_plan.fmt(path))
                for path in self.quant_plan.paths()}
            rep["calibration_ranges"] = dict(self.quant_plan.ranges)
        elif self.target.is_quantized:
            rep["formats"] = {"*": repr(self.target.fmt)}
        else:
            rep["formats"] = {}
        if x is not None:
            out, stats = self.predict_with_stats(x)
            rep["saturation"] = stats
            if y is not None:
                y = np.asarray(y)
                rep["accuracy"] = float((out == y).mean())
                if self.params is not None and self.target.is_quantized:
                    from .api import compile_from_params

                    flt = compile_from_params(
                        self.kind, self.params,
                        self.target.replace(number_format="flt",
                                            backend="ref"),
                        device=self.device)
                    rep["accuracy_float"] = float(
                        (flt.predict(x) == y).mean())
                    rep["accuracy_delta"] = (rep["accuracy"]
                                             - rep["accuracy_float"])
        return rep
