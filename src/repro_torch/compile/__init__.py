"""repro_torch.compile — the model -> target artifact compiler on PyTorch.

    from repro_torch.compile import Target, compile, load

    art = compile(model, Target(number_format="fxp16", backend="cuda"))
    art.predict(x)                      # int32 labels, via the CUDA kernels
    art.predict_with_stats(x)           # + overflow/underflow accounting
    art.memory_report()                 # flash/SRAM footprint model
    art.save("model.embml")             # the archive (the paper's output file)
    again = load("model.embml")         # recompiled on the card

Stages: ``extract_params -> calibrate -> quantize -> lower -> specialize``,
dispatched through the lowering registry by model kind: ``tree``,
``logistic``, ``mlp``, ``svm-linear``, ``svm-poly``, ``svm-rbf`` and ``lm``
(an :class:`LMModel`: weight-only quantized decode serving, whose artifact
carries ``generate`` in its ``extras``).
``compile(..., device="cpu")`` runs the kernels' plain PyTorch versions on
the host.  :func:`fleet_signature` and :func:`stack_fleet` fuse compatible
artifacts into one stacked program (:class:`FleetStack`) for the serving
plane's fleet megabatching.
"""

from .api import compile, compile_from_params, resolve_device
from .artifact import ArtifactIntegrityError, CompiledArtifact, load
from .fingerprint import fingerprint_params
from .fleet import FleetStack, fleet_signature, stack_fleet
from .registry import (Lowered, Lowering, get_lowering, lowering_kinds,
                       model_kind, register_lowering)
from .target import BACKENDS, CALIBRATED_FORMATS, NUMBER_FORMATS, Target
from . import lowerings as _lowerings  # noqa: F401  (registration side effects)
from .lowerings.lm import LMModel

__all__ = [
    "compile",
    "compile_from_params",
    "resolve_device",
    "CompiledArtifact",
    "ArtifactIntegrityError",
    "load",
    "LMModel",
    "Target",
    "NUMBER_FORMATS",
    "CALIBRATED_FORMATS",
    "BACKENDS",
    "fingerprint_params",
    "FleetStack",
    "fleet_signature",
    "stack_fleet",
    "Lowering",
    "Lowered",
    "register_lowering",
    "get_lowering",
    "lowering_kinds",
    "model_kind",
]
