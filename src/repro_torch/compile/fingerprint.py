"""Stable content fingerprints for compiled artifacts.

The serving layer dedupes recompiles through an artifact cache keyed by
``(model fingerprint, Target)``.  The fingerprint is a sha256 over a
canonical walk of the *extracted* parameter tree (the archive payload), so
two models with identical parameters — e.g. the same archive loaded twice,
or the same trained model compiled for two Targets — share one fingerprint
regardless of dict ordering or array dtype object identity.  A torch
tensor (an LM's parameters, on any device and of any dtype, bfloat16
included) is hashed by its dtype, shape and raw bytes; numpy leaves hash as
the reference's do.
"""

from __future__ import annotations

import hashlib
from typing import Any

import numpy as np
import torch

__all__ = ["fingerprint_params"]


def _walk(h: "hashlib._Hash", x: Any) -> None:
    if isinstance(x, dict):
        h.update(b"{")
        for k in sorted(x, key=str):
            h.update(str(k).encode())
            h.update(b"=")
            _walk(h, x[k])
        h.update(b"}")
    elif isinstance(x, (list, tuple)):
        h.update(b"[")
        for v in x:
            _walk(h, v)
        h.update(b"]")
    elif x is None or isinstance(x, (bool, int, float, str, bytes)):
        h.update(repr(x).encode())
        h.update(b";")
    elif isinstance(x, torch.Tensor):
        t = x.detach().contiguous().cpu()
        h.update(str(t.dtype).encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    else:
        a = np.asarray(x)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())


def fingerprint_params(kind: str, params: Any) -> str:
    """sha256 hex digest of ``kind`` + the extracted parameter tree."""
    h = hashlib.sha256()
    h.update(kind.encode())
    h.update(b":")
    _walk(h, params)
    return h.hexdigest()
