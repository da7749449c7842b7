"""Block sizes of the hand-written kernels, and the shape-bucketing helpers.

The counterpart of :mod:`repro.kernels.tune`.  The CUDA kernels run with
fixed block sizes, ``constexpr`` in their sources; the JSON
disk cache and the timed sweeps of the TPU autotuner are not ported yet.
``MODEL_BLOCK_M`` must match ``kMlpBM`` in ``csrc/fxp_mlp_body.cuh`` and
``kSvmRows`` in ``csrc/fxp_svm_body.cuh``: the megakernels' fit predicates
size their shared memory from it.
"""

from __future__ import annotations

import torch

__all__ = ["pow2ceil", "batch_bucket", "device_key", "MODEL_BLOCK_M",
           "SMEM_PER_BLOCK"]

# fxp_mlp_model, fxp_svm_model: batch rows per block (the whole model for
# those rows in one block).
MODEL_BLOCK_M = 32
# Shared memory one Hopper block may use (227 KB, opt-in above 48 KB).
SMEM_PER_BLOCK = 232_448


def pow2ceil(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(0, (int(n) - 1).bit_length())


def batch_bucket(b: int, cap: int = 256) -> int:
    """Round a batch up to its power-of-two bucket, capped (the serving
    layer's bucket ladder)."""
    return min(int(cap), pow2ceil(max(1, int(b))))


def device_key(device=None) -> str:
    """Cache-key component naming the hardware: ``cuda:<device name>`` for a
    CUDA device (the default one when ``device`` is None and a card is
    present), ``cpu:cpu`` otherwise."""
    if device is None:
        device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    device = torch.device(device)
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
    else:
        kind = device.type
    return f"{device.type}:{kind}".replace(" ", "_")
