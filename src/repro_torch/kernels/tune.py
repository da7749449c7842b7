"""Block-size tuner for the hand-written kernels (shape-keyed, device-keyed,
disk-cached).

The counterpart of :mod:`repro.kernels.tune`.  Each tuned kernel has a few
compiled blockings that compute the same bits (its dots are sums mod 2^32 in
any order, its epilogues per element), and no one blocking suits every batch
the serving ladder sends, from 1 row to 65536.  This module picks one per
*problem shape bucket*:

* **Key** — the reference's format letter for letter but for the device
  part: ``kind|MbxKxN|w<bits>|<device>`` for the matmuls, ``model-<kind>|
  Mb|d<dims>|w<bits>|<device>`` for the whole-model megakernels and
  ``fleet-<kind>|E<e>|u<0/1>|Mb|d<dims>|w<bits>|<device>`` for the fleet
  kernels, M rounded up to its power of two (the serving layer's bucket
  ladder) and the device ``cuda:<name>`` (:func:`device_key`, e.g.
  ``cuda:NVIDIA_H100_80GB_HBM3``).  Values are three positive ints, as in
  the reference: ``(bm, bn, bk)``, ``(bm, 1, 1)`` or ``(be, bm, 1)``.
* **Candidates** — the kernel's compiled instances that apply to the shape
  (:func:`candidates`), today's blocking first and always among them:

  - ``qmatmul`` and ``layer``'s wide route (``csrc/fxp_tile.cuh``): tiles of
    32, 64 (today) or 128 rows by 64 columns, k ``128 / P`` a stage:
    ``(bm, 64, 128 // P)``;
  - ``layer``'s narrow route (N <= 32, ``csrc/fxp_layer_narrow.cuh``): the
    persistent grid, today's ``narrow_blocks`` rule, one and two blocks an
    SM, and every slot the card holds: ``(rows a group, grid, 128)``;
  - ``model-mlp``/``fleet-mlp`` at 8 and 16 bits: 1, 2 or 3 warp groups a
    block that ``mlp_plan`` lays out (today: as many as fit), ``bm = 16 x
    groups``; at 32 bits blocks of 16, 32 (today) or 64 rows, an instance
    each, filtered by the routing count ``mlp_smem_bytes`` at that ``bm``;
  - ``model-svm-*``/``fleet-svm-*``: clusters of 16, 32 (today) or 64 rows,
    an instance each, filtered by ``svm_smem_bytes`` at that ``bm``.

  A fleet's ``be`` is always 1: the fleet kernels run one member a block
  along ``y``, so a block over several members would be another kernel.
* **Selection** — with a ``runner`` (the ``cuda`` route's wrappers in
  :mod:`.ops` give one: CUDA-event time, best of 3 after one warm launch, on
  zero operands of the bucketed shape and the real weights) every candidate
  is timed and the fastest wins; a candidate whose launch raises is skipped,
  and if every one raises the lookup raises the last error.  Without a
  runner the lookup returns today's blocking.  The reference's off-TPU cost
  model (``_model_cost``, ``_choose``) ranks padded Pallas tiles; the CUDA
  kernels pad nothing, so it has no counterpart here.
* **Cache** — two layers: a process-wide dict under an ``RLock``, and a JSON
  file (``$REPRO_TORCH_TUNE_CACHE`` or ``~/.cache/repro_torch/
  tune_cache.json``; not the reference's file, whose ``cpu:cpu`` keys name
  Pallas tiles).  A warm lookup never takes the file lock; a sweep runs
  outside ``_lock``; a new entry is written atomically (a ``.tmp.<pid>``
  file, then ``os.replace``) after re-reading and merging the file under a
  sidecar ``flock``, so processes sharing the file union their entries.  A
  corrupt or absent file means "tune from scratch", a read-only one "not
  persisted".  ``CompiledArtifact.pretune`` fills it ahead of traffic.

Sweep launches are counted in :data:`sweep_launches` (their wall time in
:data:`sweep_seconds`), never in a launcher's ``launches`` or in
``ops.count_dispatches()``.

Not tuned, as in the reference: ``pwl_activation`` (the reference's
``pwl_blocks`` only sizes a Pallas grid; ``csrc/pwl_activation.cu`` sizes its
grid to the input), ``tree_ensemble`` (the reference only buckets the batch)
and ``flash_attention`` (the reference runs fixed ``bq``/``bk``).
"""

from __future__ import annotations

import contextlib
import functools
import json
import operator
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .fxp_layer import NARROW_K_CHUNK, narrow_grid, narrow_plan

__all__ = ["pow2ceil", "batch_bucket", "device_key", "cache_path",
           "clear_memory_cache", "cache_snapshot", "candidates",
           "model_candidates", "matmul_blocks", "model_block_m",
           "fleet_blocks", "check_matmul_blocks", "check_model_bm",
           "check_fleet_blocks", "MODEL_BLOCK_M", "SMEM_PER_BLOCK",
           "TILE_BMS", "MODEL_BMS", "sweep_launches", "sweep_seconds"]

Blocks = Tuple[int, int, int]
Runner = Callable[[Blocks], float]

# fxp_mlp_model's 32-bit body and fxp_svm_model: today's batch rows per
# block, and the routing count's bm (mlp_fits_smem, svm_fits_smem).
MODEL_BLOCK_M = 32
# Shared memory one Hopper block may use (227 KB, opt-in above 48 KB).
SMEM_PER_BLOCK = 232_448
# csrc/fxp_tile.cuh: the tile heights (kTileBM = 64 today), its width and
# the bytes of an A row a stage.
TILE_BMS = (32, 64, 128)
TILE_BM, TILE_BN, TILE_ROW_BYTES = 64, 64, 128
# csrc/fxp_mlp_body.cuh: a warp group's rows (kMmaBM) and the most groups.
MMA_BM, MLP_MAX_GROUPS = 16, 3
# The 32-bit MLP body's and the SVM cluster body's instances (rows a block).
MODEL_BMS = (16, 32, 64)

# Kernel launches made by sweeps, and the seconds the sweeps took.
sweep_launches = 0
sweep_seconds = 0.0

_lock = threading.RLock()
_memory: Dict[str, Blocks] = {}
_disk_loaded_from: Optional[str] = None


# --------------------------------------------------------------------------
# shape bucketing
# --------------------------------------------------------------------------
def pow2ceil(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(0, (int(n) - 1).bit_length())


def batch_bucket(b: int, cap: int = 256) -> int:
    """Round a batch up to its power-of-two bucket, capped (the serving
    layer's bucket ladder)."""
    return min(int(cap), pow2ceil(max(1, int(b))))


@functools.lru_cache(maxsize=None)
def _cuda_key(index: int) -> str:
    return f"cuda:{torch.cuda.get_device_name(index)}".replace(" ", "_")


def device_key(device=None) -> str:
    """Cache-key component naming the hardware: ``cuda:<device name>`` for a
    CUDA device (the current one when ``device`` is None and a card is
    present), ``cpu:cpu`` otherwise.  Block timings transfer between cards
    of one kind, not across kinds."""
    if device is None:
        device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    device = torch.device(device)
    if device.type == "cuda":
        return _cuda_key(device.index if device.index is not None
                         else torch.cuda.current_device())
    return f"{device.type}:{device.type}"


# --------------------------------------------------------------------------
# disk cache
# --------------------------------------------------------------------------
def cache_path() -> str:
    return os.environ.get(
        "REPRO_TORCH_TUNE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                     "tune_cache.json"))


def _merge_disk_into_memory(path: str) -> None:
    """Fold valid on-disk entries into memory (in-memory entries win)."""
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, ValueError):
        return  # absent or corrupt cache: tune from scratch
    if not isinstance(raw, dict):
        return
    for key, val in raw.items():
        if (isinstance(val, list) and len(val) == 3
                and all(isinstance(v, int) and not isinstance(v, bool)
                        and v > 0 for v in val)):
            _memory.setdefault(key, tuple(val))


def _load_disk() -> None:
    """Merge the on-disk cache into memory (once per distinct path)."""
    global _disk_loaded_from
    path = cache_path()
    if _disk_loaded_from == path:
        return
    _disk_loaded_from = path
    _merge_disk_into_memory(path)


@contextlib.contextmanager
def _save_lock(path: str):
    """Advisory cross-process lock over the read-merge-replace cycle: a
    sibling's entries landing between our read and our replace would
    otherwise be clobbered.  POSIX ``flock`` on a sidecar file; without
    ``fcntl`` the save is best-effort."""
    try:
        import fcntl
    except ImportError:
        yield
        return
    with open(f"{path}.lock", "a+") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)


def _save_disk() -> None:
    """Atomic rewrite of the disk cache from memory, unioned with what the
    file holds now.  Called WITHOUT ``_lock`` held: the flock may wait on a
    sibling's I/O, and warm lookups must not wait behind it."""
    path = cache_path()
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with _save_lock(path):
            with _lock:
                _merge_disk_into_memory(path)
                snapshot = dict(_memory)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({k: list(v) for k, v in sorted(snapshot.items())},
                          f, indent=0)
            os.replace(tmp, path)
    except OSError:
        pass  # read-only filesystem etc.: tuned, just not persisted


def clear_memory_cache() -> None:
    """Drop the in-process cache (the next lookup reloads the file)."""
    global _disk_loaded_from
    with _lock:
        _memory.clear()
        _disk_loaded_from = None


def cache_snapshot() -> Dict[str, Blocks]:
    with _lock:
        return dict(_memory)


def _lookup(key: str) -> Optional[Blocks]:
    with _lock:
        hit = _memory.get(key)
        if hit is None:
            _load_disk()
            hit = _memory.get(key)
        return hit


def _store(key: str, value: Blocks) -> Blocks:
    """Keep the first value stored under ``key`` (a racing sweep of the same
    key agrees with it), persist, and return it."""
    with _lock:
        got = _memory.setdefault(key, tuple(int(v) for v in value))
    _save_disk()  # outside _lock: the cross-process flock must not stall hits
    return got


def _sweep(cands: Sequence, runner: Optional[Callable]):
    """The fastest candidate under ``runner``, today's (the first) without
    one.  A candidate whose run raises is skipped; if all raise, the last
    error propagates."""
    global sweep_seconds
    if runner is None:
        return cands[0]
    best, best_t, error = None, float("inf"), None
    t0 = time.perf_counter()
    try:
        for cand in cands:
            try:
                t = runner(cand)
            except Exception as e:  # the launch refused this candidate
                error = e
                continue
            if t < best_t:
                best, best_t = cand, t
    finally:
        with _lock:
            sweep_seconds += time.perf_counter() - t0
    if best is None:
        raise error
    return best


# --------------------------------------------------------------------------
# candidates
# --------------------------------------------------------------------------
def _tile(bm: int, bits: int) -> Blocks:
    return (bm, TILE_BN, TILE_ROW_BYTES // (int(bits) // 8))


def _check_bits(bits: int) -> int:
    if int(bits) not in (8, 16, 32):
        raise ValueError(f"container width must be 8, 16 or 32, got {bits}")
    return int(bits)


def candidates(kind: str, m: int, k: int, n: int, bits: int,
               occupancy: Optional[Tuple[int, int]] = None) -> List[Blocks]:
    """The compiled blockings of a ``kind`` (``qmatmul`` or ``layer``) matmul
    of M x K x N in a ``bits`` container, today's first.

    A ``layer`` that takes the narrow route (:func:`narrow_plan`) tunes its
    persistent grid, which needs the card's ``occupancy`` = (SMs, blocks of
    the instance the card holds at once); the other routes need nothing of
    the card."""
    bits = _check_bits(bits)
    if kind not in ("qmatmul", "layer"):
        raise KeyError(f"kind must be 'qmatmul' or 'layer', got {kind!r}")
    plan = narrow_plan(int(k), int(n)) if kind == "layer" else None
    if plan is None:
        return [_tile(TILE_BM, bits)] + [_tile(bm, bits) for bm in TILE_BMS
                                         if bm != TILE_BM]
    if occupancy is None:
        raise ValueError("the narrow route's grid candidates need the card's "
                         "occupancy (SMs, slots)")
    sms, slots = (int(v) for v in occupancy)
    rows = plan[1]
    grids = [narrow_grid(-(-int(m) // rows), sms, slots), sms, 2 * sms, slots]
    out: List[Blocks] = []
    for g in grids:
        if g >= 1 and (rows, g, NARROW_K_CHUNK) not in out:
            out.append((rows, g, NARROW_K_CHUNK))
    return out


def _model_fit(kind: str, dims: Sequence[int], bits: int):
    """The kernel's own shared-memory count per ``bm`` and its budget."""
    # fxp_model imports this module for MODEL_BLOCK_M and SMEM_PER_BLOCK
    from . import fxp_model

    if kind == "mlp" and bits in (8, 16):
        return (lambda bm: fxp_model.mlp_mma_smem_bytes(dims, bits,
                                                        bm // MMA_BM),
                SMEM_PER_BLOCK)
    if kind == "mlp":
        return (lambda bm: fxp_model.mlp_smem_bytes(dims, bits, bm),
                fxp_model.smem_budget())
    return (lambda bm: fxp_model.svm_smem_bytes(dims[1], bm),
            fxp_model.smem_budget())


def model_candidates(kind: str, dims: Sequence[int], bits: int,
                     smem_bytes: Optional[Callable[[int], float]] = None,
                     budget: Optional[int] = None) -> List[int]:
    """The batch blocks ``bm`` of a whole-model kernel (``kind`` ``mlp`` or
    ``svm-poly``/``svm-rbf``; ``dims`` the MLP's widths or the SVM's (F, S,
    C)) that fit ``smem_bytes(bm) <= budget`` (default: the kernel's own
    count), today's first and always kept.  At 8 and 16 bits the MLP's
    ``bm`` is 16 x its warp groups, today's the most that fit."""
    bits = _check_bits(bits)
    if not (kind == "mlp" or kind.startswith("svm-")):
        raise KeyError(f"kind must be 'mlp' or 'svm-<kernel>', got {kind!r}")
    own, own_budget = _model_fit(kind, tuple(int(d) for d in dims), bits)
    fit = smem_bytes or own
    limit = own_budget if budget is None else budget
    if kind == "mlp" and bits in (8, 16):
        bms = [MMA_BM * g for g in range(1, MLP_MAX_GROUPS + 1)]
        today = max([b for b in bms if own(b) <= SMEM_PER_BLOCK] or [MMA_BM])
    else:
        bms, today = list(MODEL_BMS), MODEL_BLOCK_M
    return [today] + [b for b in bms if b != today and fit(b) <= limit]


# --------------------------------------------------------------------------
# overrides
# --------------------------------------------------------------------------
def check_matmul_blocks(kind: str, k: int, n: int, bits: int,
                        blocks) -> Blocks:
    """``blocks`` as a tuple, or ValueError unless it names a compiled
    instance of the kernel for this K x N (the narrow route: its rows a
    group, a grid >= 1 and its K chunk)."""
    bits = _check_bits(bits)
    try:
        blk = tuple(int(v) for v in blocks)
    except (TypeError, ValueError):
        raise ValueError(f"{kind} has no compiled blocking {blocks!r}: "
                         f"three ints")
    plan = narrow_plan(int(k), int(n)) if kind == "layer" else None
    if plan is not None:
        ok = len(blk) == 3 and blk[0] == plan[1] and blk[1] >= 1 and \
            blk[2] == NARROW_K_CHUNK
        want = f"({plan[1]}, grid >= 1, {NARROW_K_CHUNK})"
    else:
        ok = blk in [_tile(bm, bits) for bm in TILE_BMS]
        want = f"one of {[_tile(bm, bits) for bm in TILE_BMS]}"
    if not ok:
        raise ValueError(f"{kind} {k}x{n} at {bits} bits has no compiled "
                         f"blocking {blocks!r}: {want}")
    return blk


def check_model_bm(kind: str, dims: Sequence[int], bits: int, bm) -> int:
    """``bm`` as an int, or ValueError unless it is an instance of the
    whole-model kernel (at 8 and 16 bits: warp groups that ``mlp_plan``
    lays out for these widths)."""
    bits = _check_bits(bits)
    if kind == "mlp" and bits in (8, 16):
        valid = model_candidates(kind, dims, bits)
    else:
        valid = list(MODEL_BMS)
    try:
        ok = not isinstance(bm, bool) and operator.index(bm) in valid
    except TypeError:
        ok = False
    if not ok:
        raise ValueError(f"model-{kind} {tuple(dims)} at {bits} bits has no "
                         f"compiled block of {bm!r} rows: one of "
                         f"{sorted(valid)}")
    return operator.index(bm)


def check_fleet_blocks(kind: str, dims: Sequence[int], bits: int, be,
                       bm) -> None:
    """ValueError unless ``be`` is None or 1 (a block runs one member) and
    ``bm`` None or an instance (:func:`check_model_bm`)."""
    if be is not None and (isinstance(be, bool) or be != 1):
        raise ValueError(f"fleet-{kind}: the fleet kernels run one member a "
                         f"block (be = 1), got be={be!r}")
    if bm is not None:
        check_model_bm(kind, dims, bits, bm)


# --------------------------------------------------------------------------
# public lookups
# --------------------------------------------------------------------------
def matmul_blocks(kind: str, m: int, k: int, n: int, bits: int,
                  runner: Optional[Runner] = None,
                  occupancy: Optional[Tuple[int, int]] = None,
                  device=None) -> Blocks:
    """Tuned blocking of a ``kind`` (``qmatmul``, ``layer``) matmul of
    logical shape M x K x N: ``(bm, 64, 128 // P)`` on the integer tile,
    ``(rows a group, grid, 128)`` on ``layer``'s narrow route.

    M is bucketed to its power of two before keying; the first lookup of a
    key sweeps the candidates with ``runner`` (today's blocking without one)
    and persists the choice, later lookups are a dict hit, across processes
    through the JSON file.  ``occupancy`` (SMs, slots) is needed on the
    narrow route's first lookup; ``device`` names the card the runner times
    on (default: the current one)."""
    mb = batch_bucket(m, cap=1 << 30)
    key = f"{kind}|{mb}x{int(k)}x{int(n)}|w{int(bits)}|{device_key(device)}"
    hit = _lookup(key)
    if hit is not None:
        return hit
    # the sweep runs outside the lock: a concurrent miss on the same key
    # sweeps twice and keeps the first value stored
    blocks = _sweep(candidates(kind, mb, k, n, bits, occupancy), runner)
    return _store(key, blocks)


def model_block_m(kind: str, m: int, dims: Sequence[int], bits: int,
                  smem_bytes: Optional[Callable[[int], float]] = None,
                  budget: Optional[int] = None,
                  runner: Optional[Callable[[int], float]] = None,
                  device=None) -> int:
    """Tuned batch block ``bm`` of a whole-model kernel dispatch (``kind``
    ``mlp`` or ``svm-<kernel>``), keyed like the reference's and stored as
    ``(bm, 1, 1)``; candidates from :func:`model_candidates`."""
    mb = batch_bucket(m, cap=1 << 30)
    sig = "x".join(str(int(d)) for d in dims)
    key = f"model-{kind}|{mb}|d{sig}|w{int(bits)}|{device_key(device)}"
    hit = _lookup(key)
    if hit is not None:
        return int(hit[0])
    bm = _sweep(model_candidates(kind, dims, bits, smem_bytes, budget),
                runner)
    return int(_store(key, (bm, 1, 1))[0])


def fleet_blocks(kind: str, n_models: int, m: int, dims: Sequence[int],
                 bits: int, uniform: bool = True,
                 smem_bytes: Optional[Callable[[int], float]] = None,
                 budget: Optional[int] = None,
                 runner: Optional[Callable[[Tuple[int, int]], float]] = None,
                 device=None) -> Tuple[int, int]:
    """Tuned ``(be, bm)`` of a fleet dispatch, keyed like the reference's
    (fleet size, uniformity, bucketed batch, member dims, width, device) and
    stored as ``(be, bm, 1)``.  ``be`` is always 1: the port's fleet kernels
    run one member a block; ``bm`` sweeps the single model's candidates,
    the runner timing ``(1, bm)``."""
    e = max(1, int(n_models))
    mb = batch_bucket(m, cap=1 << 30)
    sig = "x".join(str(int(d)) for d in dims)
    key = (f"fleet-{kind}|E{e}|u{int(bool(uniform))}|{mb}|d{sig}"
           f"|w{int(bits)}|{device_key(device)}")
    hit = _lookup(key)
    if hit is not None:
        return int(hit[0]), int(hit[1])
    cands = [(1, bm) for bm in model_candidates(kind, dims, bits, smem_bytes,
                                                budget)]
    be, bm = _sweep(cands, runner)
    got = _store(key, (be, bm, 1))
    return int(got[0]), int(got[1])
