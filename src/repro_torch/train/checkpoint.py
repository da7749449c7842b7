"""Checkpointing: atomic, compressed, resumable; and the codec under it.

The counterpart of :mod:`repro.train.checkpoint`.  The codec
(``compress_bytes``, ``decompress_bytes``, ``LEAF_KEY``, ``encode_leaf``,
``decode_leaf``, ``atomic_write_bytes``) is shared with the artifact
archive (:mod:`repro_torch.compile.artifact`); the pytree checkpoints
(:func:`save_pytree`, :func:`restore_pytree`, :class:`CheckpointManager`)
hold the LM trainer's state.  A file either package writes restores in the
other.

* Pytrees: nested dicts, lists, tuples and named tuples (such as
  :class:`repro_torch.train.optim.OptState`) of tensors, numpy arrays and
  Python scalars; ``None`` is an empty subtree.  The leaves are stored in
  ``jax.tree.flatten``'s order — dict keys sorted, sequences and named
  tuples' fields in order — which is not the insertion order that
  :func:`repro_torch.train.optim.tree_leaves` walks.  The payload keeps the
  reference's keys: ``treedef`` (a description; nothing reads it back),
  ``leaves``, ``metadata``, ``version`` 1 and ``saved_at``.
* Steps: ``<dir>/step_<n>/host_<k>.ckpt`` with a ``COMMIT`` marker
  written last, so a step without it is never restored; the newest
  ``keep`` steps and every ``keep_period``-th are retained.

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
* DTensors (a tree placed on a mesh, one process a device): saving
  gathers every leaf on every rank (``full_tensor``, a collective), rank 0
  writes and commits the reference's file, and every rank waits at a
  barrier; restoring places each leaf with the placements and the mesh of
  ``like``'s leaf, whatever mesh wrote it (elastic resharding).
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
import struct
import tempfile
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.sharding.rules import full_value, is_dtensor

try:  # zstd preferred; zlib is the always-available fallback
    import zstandard
except ImportError:  # pragma: no cover - environment-dependent
    zstandard = None

__all__ = ["save_pytree", "restore_pytree", "CheckpointManager",
           "compress_bytes", "decompress_bytes", "encode_leaf", "decode_leaf",
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


# --------------------------------------------------------------------------
# pytrees
# --------------------------------------------------------------------------
def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree: Any, leaves: List[Any]) -> str:
    """Append ``tree``'s leaves to ``leaves`` in ``jax.tree.flatten``'s
    order; returns a description of the structure."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        keys = sorted(tree)
        return "{" + ", ".join(f"{k!r}: {_flatten(tree[k], leaves)}"
                               for k in keys) + "}"
    if _is_namedtuple(tree):
        return type(tree).__name__ + "(" + ", ".join(
            f"{f}={_flatten(v, leaves)}"
            for f, v in zip(tree._fields, tree)) + ")"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_flatten(v, leaves) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner},)"
    leaves.append(tree)
    return "*"


def _rebuild(like: Any, leaves) -> Any:
    """``like``'s structure with its leaves taken from the iterator
    ``leaves`` in flatten order."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(v, leaves) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves) for v in like)
    return _place(next(leaves), like)


def _place(x: Any, like: Any) -> Any:
    """A decoded leaf as ``like`` holds it: a tensor on ``like``'s device
    (with the checkpoint's dtype), distributed as ``like`` is when it is a
    DTensor; else the decoded value."""
    if isinstance(like, torch.Tensor):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.asarray(x))
        t = t.to(like.device)
        if is_dtensor(like):
            from torch.distributed.tensor import distribute_tensor

            return distribute_tensor(t, like.device_mesh, like.placements)
        return t
    return x


def _shape(x: Any) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


def save_pytree(path: str, tree: Any, metadata: Optional[Dict] = None) -> None:
    """Atomically save a pytree (tensors, arrays and scalars) to ``path``."""
    leaves: List[Any] = []
    treedef = _flatten(tree, leaves)
    payload = {
        "treedef": f"PyTreeDef({treedef})",
        "leaves": [encode_leaf(l) for l in leaves],
        "metadata": metadata or {},
        "version": 1,
        "saved_at": time.time(),
    }
    atomic_write_bytes(path, compress_bytes(packb(payload)))


def restore_pytree(path: str, like: Any = None) -> Tuple[Any, Dict]:
    """Restore a pytree.  With ``like``, validate the leaf count and shapes
    and return the leaves in ``like``'s structure, each tensor on the
    device of ``like``'s leaf (safe resume); without it, the leaf list."""
    with open(path, "rb") as f:
        payload = unpackb(decompress_bytes(f.read()))
    leaves = [decode_leaf(l) for l in payload["leaves"]]
    if like is None:
        return leaves, payload["metadata"]
    like_leaves: List[Any] = []
    _flatten(like, like_leaves)
    if len(like_leaves) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, expected {len(like_leaves)}")
    for i, (a, b) in enumerate(zip(leaves, like_leaves)):
        if hasattr(b, "shape") and _shape(a) != _shape(b):
            raise ValueError(
                f"leaf {i}: checkpoint shape {_shape(a)} != expected "
                f"{_shape(b)}")
    return _rebuild(like, iter(leaves)), payload["metadata"]


_STEP_RE = re.compile(r"^step_(\d+)$")


@dataclasses.dataclass
class CheckpointManager:
    """Step-indexed checkpoint directory with retention + commit markers."""

    directory: str
    keep: int = 3
    keep_period: Optional[int] = None  # additionally keep every k-th step
    host_id: int = 0

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)

    # -- paths ---------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def _ckpt_path(self, step: int) -> str:
        return os.path.join(self._step_dir(step), f"host_{self.host_id}.ckpt")

    def _commit_path(self, step: int) -> str:
        return os.path.join(self._step_dir(step), "COMMIT")

    # -- api -----------------------------------------------------------------
    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.exists(self._commit_path(int(m.group(1)))):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any,
             metadata: Optional[Dict] = None) -> str:
        """Save ``tree`` as ``step``.  A tree of DTensors is gathered on
        every rank, written by rank 0, and every rank returns after the
        commit (a barrier)."""
        path = self._ckpt_path(step)
        meta = dict(metadata or {})
        meta["step"] = step
        import torch.distributed as dist

        leaves: List[Any] = []
        _flatten(tree, leaves)
        placed = any(is_dtensor(l) for l in leaves)
        tree = full_value(tree)
        if not placed or dist.get_rank() == 0:
            save_pytree(path, tree, meta)
            # Commit marker written last: a step dir without it is ignored.
            with open(self._commit_path(step), "w") as f:
                f.write(str(time.time()))
            self._gc()
        if placed:
            dist.barrier()
        return path

    def restore(self, like: Any,
                step: Optional[int] = None) -> Tuple[int, Any, Dict]:
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no committed checkpoints in {self.directory}")
        tree, meta = restore_pytree(self._ckpt_path(step), like)
        return step, tree, meta

    def restore_or_init(self, like: Any) -> Tuple[int, Any]:
        """Resume from the latest checkpoint or fall back to ``like`` at
        step 0."""
        step = self.latest_step()
        if step is None:
            return 0, like
        _, tree, _ = self.restore(like, step)
        return step, tree

    def _gc(self) -> None:
        steps = self.all_steps()
        protect = set(steps[-self.keep:]) if self.keep else set()
        if self.keep_period:
            protect |= {s for s in steps if s % self.keep_period == 0}
        for s in steps:
            if s not in protect:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)
