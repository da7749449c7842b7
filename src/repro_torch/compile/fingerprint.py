"""Stable content fingerprints for compiled artifacts.

The serving layer dedupes recompiles through an artifact cache keyed by
``(model fingerprint, Target)``.  The fingerprint is a sha256 over a
canonical walk of the *extracted* parameter tree (the archive payload), so
two models with identical parameters — e.g. the same archive loaded twice,
or the same trained model compiled for two Targets — share one fingerprint
regardless of dict ordering or array dtype object identity.  A torch
tensor (an LM's parameters, on any device and of any dtype, bfloat16
included) is hashed by its dtype, shape and the sha256 digests of its raw
bytes in 64 MiB chunks, taken in parallel threads (hashlib releases the
GIL), so a full-width model's tens of GB hash in seconds, not minutes;
numpy leaves hash as the reference's do.
"""

from __future__ import annotations

import hashlib
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

__all__ = ["fingerprint_params"]

_CHUNK = 1 << 26  # bytes of a tensor hashed as one piece
_POOL = ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1))


def _chunk_digest(chunk: torch.Tensor) -> bytes:
    return hashlib.sha256(chunk.cpu().numpy()).digest()


def _tensor_digests(x: torch.Tensor) -> bytes:
    """The sha256 digests of a tensor's raw bytes, chunk by chunk."""
    flat = x.detach().contiguous().reshape(-1).view(torch.uint8)
    chunks = [flat[i:i + _CHUNK] for i in range(0, flat.numel(), _CHUNK)]
    if len(chunks) == 1:
        return _chunk_digest(chunks[0])
    return b"".join(_POOL.map(_chunk_digest, chunks))


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
        h.update(str(x.dtype).encode())
        h.update(str(tuple(x.shape)).encode())
        h.update(_tensor_digests(x))
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
