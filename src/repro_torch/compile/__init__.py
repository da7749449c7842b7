"""repro_torch.compile — the model -> target artifact compiler on PyTorch.

    from repro_torch.compile import compile, Target

    art = compile(model, Target(number_format="fxp16", backend="cuda"))
    art.predict(x)                      # int32 labels, via the CUDA kernels
    art.predict_with_stats(x)           # + overflow/underflow accounting
    art.memory_report()                 # flash/SRAM footprint model

Stages: ``extract_params -> calibrate -> quantize -> lower -> specialize``,
dispatched through the lowering registry by model kind: ``tree``,
``logistic``, ``mlp``, ``svm-linear``, ``svm-poly`` and ``svm-rbf``.
``compile(..., device="cpu")`` runs the kernels' plain PyTorch versions on
the host.
"""

from .api import compile, compile_from_params, resolve_device
from .artifact import CompiledArtifact
from .fingerprint import fingerprint_params
from .registry import (Lowered, Lowering, get_lowering, lowering_kinds,
                       model_kind, register_lowering)
from .target import BACKENDS, CALIBRATED_FORMATS, NUMBER_FORMATS, Target
from . import lowerings as _lowerings  # noqa: F401  (registration side effects)

__all__ = [
    "compile",
    "compile_from_params",
    "resolve_device",
    "CompiledArtifact",
    "Target",
    "NUMBER_FORMATS",
    "CALIBRATED_FORMATS",
    "BACKENDS",
    "fingerprint_params",
    "Lowering",
    "Lowered",
    "register_lowering",
    "get_lowering",
    "lowering_kinds",
    "model_kind",
]
