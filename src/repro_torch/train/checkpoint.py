"""The checkpoint codec: compressed msgpack containers and array leaves.

The counterpart of the codec half of :mod:`repro.train.checkpoint`
(``compress_bytes``, ``decompress_bytes``, ``LEAF_KEY``, ``encode_leaf``,
``decode_leaf``, ``atomic_write_bytes``), shared with the artifact archive
(:mod:`repro_torch.compile.artifact`).  The pytree checkpoints
(``save_pytree``, ``restore_pytree``, ``CheckpointManager``) arrive with the
LM trainer.

* Compression: zstd when the ``zstandard`` package imports, zlib otherwise.
  The streams identify themselves (zstd frame magic or zlib header), so
  either reader takes either file; a zstd stream without the package
  raises.
* Serialization: :func:`packb` and :func:`unpackb`, the port's own msgpack
  for the subset that archives use (map, array, str, bin, int, float64,
  bool, nil).  ``packb(x)`` writes the bytes ``msgpack.packb(x,
  use_bin_type=True)`` writes, and ``unpackb(b)`` returns what
  ``msgpack.unpackb(b, raw=False, strict_map_key=False)`` returns, so the
  two packages read each other's files; no ``msgpack`` is needed.
* Leaves: a numpy array or a torch tensor is stored as ``{dtype, shape,
  data}`` raw bytes; a tensor is moved to the host first.  bfloat16 (which
  numpy lacks) is stored under the dtype name ``"bfloat16"``, as the
  reference stores its ``ml_dtypes`` arrays, and decodes to a
  ``torch.bfloat16`` tensor with the same bits; every other dtype decodes
  to a numpy array.
"""

from __future__ import annotations

import os
import struct
import tempfile
import zlib
from typing import Any, Dict, List

import numpy as np
import torch

try:  # zstd preferred; zlib is the always-available fallback
    import zstandard
except ImportError:  # pragma: no cover - environment-dependent
    zstandard = None

__all__ = ["compress_bytes", "decompress_bytes", "encode_leaf", "decode_leaf",
           "atomic_write_bytes", "packb", "unpackb", "LEAF_KEY"]

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"

# Sentinel key marking an encoded leaf dict; shared with the compiled-
# artifact archive codec (repro_torch.compile.artifact).
LEAF_KEY = "__leaf__"


def compress_bytes(raw: bytes) -> bytes:
    """zstd when available, else zlib.  Streams are self-identifying (zstd
    frame magic vs zlib header), so either reader handles either file."""
    if zstandard is not None:
        return zstandard.ZstdCompressor(level=3).compress(raw)
    return zlib.compress(raw, 6)


def decompress_bytes(blob: bytes) -> bytes:
    if blob[:4] == _ZSTD_MAGIC:
        if zstandard is None:
            raise RuntimeError(
                "checkpoint is zstd-compressed but the 'zstandard' package "
                "is not installed; install it or re-save with zlib")
        return zstandard.ZstdDecompressor().decompress(blob)
    return zlib.decompress(blob)


def atomic_write_bytes(path: str, blob: bytes) -> None:
    """Write-to-tmp + fsync + rename: ``path`` is never observable
    half-written.

    The tmp file comes from ``tempfile.mkstemp`` in the destination
    directory, so every writer (two threads of one process included) gets a
    private file, and the final ``os.replace`` (atomic on POSIX) publishes a
    complete blob or nothing.  On any failure the tmp file is removed.
    """
    apath = os.path.abspath(path)
    directory = os.path.dirname(apath)
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory,
                               prefix=os.path.basename(apath) + ".tmp-")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, apath)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


# --------------------------------------------------------------------------
# msgpack, the subset archives use
# --------------------------------------------------------------------------
def _pack_len(out: List[bytes], n: int, fix: int, fix_max: int,
              b8: int, b16: int, b32: int) -> None:
    """A container or string header: the fix form, then 8/16/32-bit
    lengths (``b8`` < 0 where the type has no 8-bit form)."""
    if n <= fix_max and fix >= 0:
        out.append(bytes((fix | n,)))
    elif n <= 0xFF and b8 >= 0:
        out.append(struct.pack(">BB", b8, n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", b16, n))
    elif n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", b32, n))
    else:
        raise ValueError(f"msgpack object of length {n} is too large")


def _pack_int(out: List[bytes], v: int) -> None:
    if 0 <= v < 0x80:
        out.append(bytes((v,)))
    elif -0x20 <= v < 0:
        out.append(struct.pack(">b", v))
    elif v >= 0:
        for code, fmt, hi in ((0xCC, ">BB", 0xFF), (0xCD, ">BH", 0xFFFF),
                              (0xCE, ">BI", 0xFFFFFFFF),
                              (0xCF, ">BQ", 0xFFFFFFFFFFFFFFFF)):
            if v <= hi:
                out.append(struct.pack(fmt, code, v))
                return
        raise OverflowError("int too big to pack")
    else:
        for code, fmt, lo in ((0xD0, ">Bb", -0x80), (0xD1, ">Bh", -0x8000),
                              (0xD2, ">Bi", -0x80000000),
                              (0xD3, ">Bq", -0x8000000000000000)):
            if v >= lo:
                out.append(struct.pack(fmt, code, v))
                return
        raise OverflowError("int too big to pack")


def _pack(out: List[bytes], x: Any) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True:
        out.append(b"\xc3")
    elif x is False:
        out.append(b"\xc2")
    elif isinstance(x, int):
        _pack_int(out, int(x))
    elif isinstance(x, float):
        out.append(struct.pack(">Bd", 0xCB, x))
    elif isinstance(x, str):
        data = x.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 31, 0xD9, 0xDA, 0xDB)
        out.append(data)
    elif isinstance(x, (bytes, bytearray, memoryview)):
        data = bytes(x)
        _pack_len(out, len(data), -1, -1, 0xC4, 0xC5, 0xC6)
        out.append(data)
    elif isinstance(x, dict):
        _pack_len(out, len(x), 0x80, 15, -1, 0xDE, 0xDF)
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(x, (list, tuple)):
        _pack_len(out, len(x), 0x90, 15, -1, 0xDC, 0xDD)
        for v in x:
            _pack(out, v)
    else:
        raise TypeError(f"can not serialize {type(x).__name__!r} object")


def packb(x: Any) -> bytes:
    """msgpack bytes of ``x``, as ``msgpack.packb(x, use_bin_type=True)``
    writes them (``str`` as str, ``bytes`` as bin, floats as float64)."""
    out: List[bytes] = []
    _pack(out, x)
    return b"".join(out)


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("msgpack data is truncated")
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]


# Fixed-width scalars: code -> (struct format, size)
_SCALARS = {0xCA: (">f", 4), 0xCB: (">d", 8),
            0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
            0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8)}
# Sized objects: code -> (kind, width of the length field)
_SIZED = {0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
          0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
          0xDC: ("array", 2), 0xDD: ("array", 4),
          0xDE: ("map", 2), 0xDF: ("map", 4)}
_LEN_FMT = {1: ">B", 2: ">H", 4: ">I"}


def _unpack(r: _Reader) -> Any:
    code = r.unpack(">B", 1)
    if code <= 0x7F:
        return code
    if code >= 0xE0:
        return code - 0x100
    if 0x80 <= code <= 0x8F:
        kind, n = "map", code & 0x0F
    elif 0x90 <= code <= 0x9F:
        kind, n = "array", code & 0x0F
    elif 0xA0 <= code <= 0xBF:
        kind, n = "str", code & 0x1F
    elif code == 0xC0:
        return None
    elif code == 0xC2:
        return False
    elif code == 0xC3:
        return True
    elif code in _SCALARS:
        fmt, size = _SCALARS[code]
        return r.unpack(fmt, size)
    elif code in _SIZED:
        kind, width = _SIZED[code]
        n = r.unpack(_LEN_FMT[width], width)
    else:
        raise ValueError(f"unsupported msgpack type byte 0x{code:02x}")
    if kind == "str":
        return str(r.take(n), "utf-8")
    if kind == "bin":
        return bytes(r.take(n))
    if kind == "array":
        return [_unpack(r) for _ in range(n)]
    out: Dict[Any, Any] = {}
    for _ in range(n):
        k = _unpack(r)
        if isinstance(k, (list, dict)):
            raise ValueError("msgpack map key is not hashable")
        out[k] = _unpack(r)
    return out


def unpackb(data: bytes) -> Any:
    """The object of one msgpack message, as ``msgpack.unpackb(data,
    raw=False, strict_map_key=False)`` returns it; raises ``ValueError`` on
    truncated, trailing or unsupported bytes."""
    r = _Reader(data)
    x = _unpack(r)
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes of extra data after "
                         f"the msgpack message")
    return x


# --------------------------------------------------------------------------
# leaves
# --------------------------------------------------------------------------
def encode_leaf(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return {LEAF_KEY: "ndarray", "dtype": "bfloat16",
                    "shape": list(t.shape),
                    "data": t.view(torch.int16).numpy().tobytes()}
        x = t.numpy()
    if isinstance(x, (np.ndarray, np.generic)):
        arr = np.asarray(x)
        if arr.dtype.kind == "V":
            raise TypeError(f"unsupported checkpoint leaf dtype {arr.dtype}")
        return {LEAF_KEY: "ndarray", "dtype": arr.dtype.str,
                "shape": list(arr.shape), "data": arr.tobytes()}
    if isinstance(x, (bool, int, float, str, bytes, type(None))):
        return {LEAF_KEY: "scalar", "value": x}
    raise TypeError(f"unsupported checkpoint leaf type {type(x)}")


def decode_leaf(d: Dict) -> Any:
    kind = d[LEAF_KEY]
    if kind == "ndarray":
        s = d["dtype"]
        if s == "bfloat16":
            bits = np.frombuffer(d["data"], np.uint16).reshape(d["shape"])
            return torch.from_numpy(bits.copy()).view(torch.bfloat16)
        if s.lstrip("<>|=").startswith("V"):
            raise ValueError(
                f"checkpoint leaf has void dtype '{s}' — written by a codec "
                "version that mangled ml_dtypes arrays; re-save the source")
        try:
            dtype = np.dtype(s)
        except TypeError:
            raise TypeError(f"checkpoint leaf dtype '{s}' has no numpy or "
                            f"torch counterpart here") from None
        arr = np.frombuffer(d["data"], dtype=dtype)
        return arr.reshape(d["shape"]).copy()
    if kind == "scalar":
        return d["value"]
    raise TypeError(f"unknown leaf kind {kind}")
