"""C/MCU emission backend — the EmbML deliverable (paper Fig. 1).

The counterpart of :mod:`repro.emit`.  The paper's tool turns a trained
classifier into *compilable C source* for FPU-less microcontrollers.
:mod:`repro_torch.emit.cgen` walks a lowering's ``emit_spec`` (the
already-quantized tensors + the per-matmul shift schedule frozen from the
:class:`repro_torch.quant.QuantPlan`) and emits freestanding C99 —
integer-only, no libc, the exact ``rshift_round_saturate`` / ``requantize``
/ ``qadd`` / PWL-activation semantics of :mod:`repro_torch.core.fixedpoint`
— and :mod:`repro_torch.emit.harness` compiles it with the system ``cc`` and
replays quantized rows through the binary, so the compiled C is held to the
labels of the ``cuda`` and ``ref`` backends.  Emission needs numpy only;
building and replaying need a C compiler on the host, and nothing of it
runs on the card.
"""

from .cgen import (EmitError, assert_integer_only, emit_c, input_format,
                   spec_of)
from .harness import (CRunner, EmitToolchainError, find_cc, section_sizes)

__all__ = [
    "EmitError",
    "EmitToolchainError",
    "emit_c",
    "emit_artifact_c",
    "assert_integer_only",
    "input_format",
    "spec_of",
    "CRunner",
    "find_cc",
    "section_sizes",
    "measure_artifact",
]


def emit_artifact_c(artifact) -> str:
    """Generate the freestanding C translation unit for a compiled artifact.

    Works for any quantized classifier artifact regardless of its execution
    backend — the ``emit_spec`` rides on the lowered program's extras.
    """
    return emit_c(spec_of(artifact), kind=artifact.kind,
                  target_name=artifact.target.number_format,
                  fingerprint=artifact.fingerprint)


def measure_artifact(artifact, cc: str = None) -> dict:
    """Compile the artifact's generated C and measure real section sizes.

    Returns ``{"text", "rodata", "data", "bss", "flash"}`` in bytes from the
    toolchain (``flash = text + rodata + data``: what actually occupies
    read-only program memory), so the paper's Tables IV-VI memory columns
    can come from a compiler instead of an estimate.  Raises
    :class:`EmitToolchainError` when no C compiler is available.
    """
    spec = spec_of(artifact)
    src = emit_c(spec, kind=artifact.kind,
                 target_name=artifact.target.number_format,
                 fingerprint=artifact.fingerprint)
    runner = CRunner(src, input_format(spec), cc=cc)
    try:
        return runner.sizes()
    finally:
        runner.close()
