"""Whole fixed-point models in one launch: the MLP and kernel-SVM megakernels.

Replaces the Pallas kernels of ``repro/kernels/fxp_model.py``:
``fxp_mlp_model_pallas`` (body ``_mlp_kernel``), ``fxp_svm_model_pallas``
(body ``_svm_kernel`` via ``_svm_forward``), and their fleet forms
``fxp_mlp_fleet_pallas`` and ``fxp_svm_fleet_pallas``, which run E stacked
models in one launch.

* :func:`fxp_mlp_model_cuda` launches ``csrc/fxp_mlp_model.cu``: every
  layer's int32 accumulate-and-wrap plus the shared epilogue, one launch for
  the whole model, the activations in shared memory.  8- and 16-bit
  containers run on the int8 tensor cores (``mma.sync`` m16n8k32; a 16-bit
  operand splits into a signed high and an unsigned low byte, and four
  int8 products recombine exactly mod 2^32) in persistent blocks that stage
  the weights once and walk 16-row tiles, up to three warp groups a block;
  the 32-bit container runs on the CUDA cores, one block per 16, 32 or 64
  rows.  ``bm`` picks the block (the tuner's choice, :mod:`.tune`: 16 x the
  warp groups at 8 and 16 bits, the rows at 32; None today's: as many
  groups as fit, ``MODEL_BLOCK_M`` rows).  It counts its launches in
  ``fxp_mlp_model_cuda.launches``.
* :func:`fxp_svm_model_cuda` launches ``csrc/fxp_svm_model.cu``: a thread
  block cluster per ``bm`` batch rows (16, 32 or 64, the tuner's choice;
  ``MODEL_BLOCK_M`` by default), its blocks splitting the
  support vectors in chunks of 64.  Each block computes x . sv^T for its
  vectors with 4x4 register micro-tiles, the poly or rbf algebra into a
  tile of kernel values in shared memory, and a uint32 partial of
  ``k . dual``; the cluster sums the
  partials (mod 2^32, so exactly) through distributed shared memory and
  applies the shared epilogue.  It counts its launches in
  ``fxp_svm_model_cuda.launches``.
* :func:`fxp_mlp_fleet_cuda` and :func:`fxp_svm_fleet_cuda` launch
  ``csrc/fxp_mlp_fleet.cu`` and ``csrc/fxp_svm_fleet.cu``: a grid of
  (batch blocks, E models) whose blocks run exactly the single-model bodies
  (``csrc/fxp_mlp_body.cuh``; the SVM's cluster body,
  ``csrc/fxp_svm_body.cuh``, in clusters along the batch axis) on their
  model's slices, so slot e equals model e's own launch bit for bit.  Each model's
  schedule or SVM parameters are a row of a small int64 table in device
  memory (:func:`mlp_fleet_table`, :func:`svm_fleet_table`, built once per
  fleet and device and cached), so per-model schedules cost nothing.  They
  take ``bm`` as their single-model kernels do.
* Every launcher takes ``count=False`` for a tuner's sweep launch, which
  leaves its ``launches`` alone (the sweep counts its own).
* :func:`fxp_mlp_model_plain`, :func:`fxp_svm_model_plain` and the fleet
  ``*_plain`` functions are the same functions in PyTorch ops.

:func:`mlp_fits_smem` and :func:`svm_fits_smem` are the routing predicates
that replace ``mlp_fits_vmem`` and ``svm_fits_vmem``: each counts what the
first version of its kernel kept in shared memory (the MLP's two activation
buffers; the SVM's kernel-value tile, squared norms and operand tiles)
against one block's 227 KB, and the redesigned kernels take every model
those counts admit, at their ``bm`` of ``MODEL_BLOCK_M`` whatever block the
tuner picks.  ``REPRO_MEGAKERNEL_VMEM`` overrides the budget under the reference
package's name; ``0`` forces the per-layer route in both packages.
:func:`mlp_mma_smem_bytes` mirrors the tensor-core body's own layout
(``mlp_plan``), from which the tuner reads how many warp groups fit.
:func:`mlp_fleet_fits_smem` and :func:`svm_fleet_fits_smem` replace the
fleet predicates: one block runs one model, so a fleet fits whenever one of
its models does, whatever E.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import fixedpoint as fxp
from repro_torch.core.fixedpoint import FxpFormat

from . import build
from .fxp_layer import (LAYER_ACTIVATIONS, _check_cuda, epilogue_params,
                        epilogue_plain, fxp_layer_plain)
from .ref import svm_kernel_values
from .tune import MODEL_BLOCK_M, SMEM_PER_BLOCK

__all__ = ["fxp_mlp_model_plain", "fxp_mlp_model_cuda", "LayerSchedule",
           "LAYER_ACTIVATIONS", "MAX_LAYERS", "smem_budget", "mlp_smem_bytes",
           "mlp_mma_smem_bytes", "mlp_fits_smem", "REPLACES", "SVM_KERNELS", "fxp_svm_model_plain",
           "fxp_svm_model_cuda", "svm_smem_bytes", "svm_fits_smem",
           "SVM_REPLACES", "FleetSchedules", "SvmFleetParams", "MAX_MODELS",
           "mlp_fleet_fits_smem", "mlp_fleet_table", "fxp_mlp_fleet_plain",
           "fxp_mlp_fleet_cuda", "MLP_FLEET_REPLACES", "svm_fleet_fits_smem",
           "svm_fleet_table", "fxp_svm_fleet_plain", "fxp_svm_fleet_cuda",
           "SVM_FLEET_REPLACES", "SVM_ROUTING_OPERAND_TILE"]

# One entry per layer: (requantization shift, output format, activation).
LayerSchedule = Tuple[Tuple[int, FxpFormat, str], ...]

MAX_LAYERS = 8  # kMaxLayers in csrc/fxp_mlp_model.cu
REPLACES = "src/repro/kernels/fxp_model.py:211"  # fxp_mlp_model_pallas
SVM_REPLACES = "src/repro/kernels/fxp_model.py:307"  # fxp_svm_model_pallas
SVM_KERNELS = ("poly", "rbf")


def smem_budget() -> int:
    """Shared-memory bytes the megakernel may use per block;
    ``REPRO_MEGAKERNEL_VMEM`` overrides (``0`` disables the megakernel)."""
    env = os.environ.get("REPRO_MEGAKERNEL_VMEM")
    if env is not None:
        try:
            return max(0, int(env))
        except ValueError:
            pass
    return SMEM_PER_BLOCK


def mlp_smem_bytes(widths: Sequence[int], bits: int,
                   bm: int = MODEL_BLOCK_M) -> int:
    """The routing count of the megakernel's shared memory: two ``bm x
    max(widths)`` activation buffers in the container type (what the 32-bit
    CUDA-core body holds).  The tensor-core body of the 8- and 16-bit
    containers lays out its own (``mlp_plan`` in ``csrc/fxp_mlp_body.cuh``:
    16-row tiles, the weights staged or streamed) and fits every model this
    count admits."""
    return 2 * bm * max(int(w) for w in widths) * (int(bits) // 8)


# csrc/fxp_mlp_body.cuh: sizeof(fxp::Epilogue), a tile's rows and a
# chunk's columns
_EPILOGUE_BYTES, _MMA_BM, _MMA_NC = 136, 16, 64


def _round_up(v: int, m: int) -> int:
    return -(-int(v) // m) * m


def _odd16(row_bytes: int) -> int:
    s = _round_up(row_bytes, 16)
    return s if (s // 16) & 1 else s + 16


def mlp_mma_smem_bytes(widths: Sequence[int], bits: int, groups: int) -> int:
    """Shared memory of the 8- and 16-bit tensor-core body's layout with
    every layer's weights resident and ``groups`` warp groups a block, as
    ``mlp_plan`` in ``csrc/fxp_mlp_body.cuh`` lays it out: the epilogues,
    the weights, and per group the two activation buffers (byte planes),
    the raw input tile, the partial-sum scratch and the bias chunk.  The
    plan runs the most groups (up to 3) whose count fits one block, else
    one group streaming the weights."""
    nb = int(bits) // 8
    dims = [int(w) for w in widths]
    wide = [1, 1]  # the widest input of even and of odd layers
    resident = 0
    for l, (k, n) in enumerate(zip(dims, dims[1:])):
        wide[l & 1] = max(wide[l & 1], k)
        rows = _round_up(k, 32) if nb == 2 else _round_up(n, 8)
        stride = (_odd16(_round_up(n, 8) * 2) if nb == 2
                  else _odd16(_round_up(k, 32)))
        resident += rows * stride
    group = sum(nb * _MMA_BM * _odd16(_round_up(w, 32)) for w in wide)
    group += _round_up(_MMA_BM * dims[0] * nb + 15 + 32 * nb + 8, 16)
    group += _MMA_BM * _MMA_NC * 4 + _MMA_NC * 4
    w_base = _round_up(MAX_LAYERS * _EPILOGUE_BYTES, 16)
    return w_base + resident + int(groups) * group


def mlp_fits_smem(widths: Sequence[int], bits: int,
                  bm: int = MODEL_BLOCK_M) -> bool:
    """Whether the megakernel takes this MLP (``widths`` = [n_features,
    hidden..., n_classes])."""
    return (len(widths) - 1 <= MAX_LAYERS
            and mlp_smem_bytes(widths, bits, bm) <= smem_budget())


def _check_schedule(weights, biases, schedule) -> None:
    if not (len(weights) == len(biases) == len(schedule) >= 1):
        raise ValueError("weights/biases/schedule must align, >= 1 layer")
    for _, _, activation in schedule:
        if activation not in LAYER_ACTIVATIONS:
            raise KeyError(f"activation must be one of {LAYER_ACTIVATIONS}")


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` (contiguous) starting on a 16-byte boundary: the MLP kernels
    copy input tiles with 16-byte ``cp.async`` from the boundary at or
    below each tile, which must not lie before the tensor."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def fxp_mlp_model_plain(x: torch.Tensor, weights, biases,
                        schedule: LayerSchedule) -> torch.Tensor:
    """The megakernel's function in PyTorch ops: the plain fused layer (int32
    accumulator with wrap) per schedule entry; the output is in the last
    layer's format."""
    _check_schedule(weights, biases, schedule)
    h = x
    for (shift, fmt, activation), w, b in zip(schedule, weights, biases):
        h = fxp_layer_plain(h, w, b, fmt, activation, shift)
    return h


@functools.lru_cache(maxsize=64)
def _schedule_params(schedule: LayerSchedule) -> np.ndarray:
    """The schedule's epilogue rows, stacked (cached, read-only)."""
    out = np.stack([epilogue_params(s, f, a) for s, f, a in schedule])
    out.flags.writeable = False
    return out


def _lib():
    fn = build.load("fxp_mlp_model").fxp_mlp_model_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fxp_mlp_model_cuda(x: torch.Tensor, weights, biases,
                       schedule: LayerSchedule, bm: Optional[int] = None,
                       count: bool = True) -> torch.Tensor:
    """Launch the CUDA megakernel.  x (M, K0); weights[i] (K_i, K_{i+1});
    biases[i] (K_{i+1},); every tensor on one CUDA device in one container
    width (the schedule's); returns (M, K_L) in that container.  ``bm``: the
    block (None: today's); a block the kernel does not have raises."""
    if x.device.type != "cuda":
        raise ValueError(f"fxp_mlp_model_cuda needs CUDA tensors, got {x.device}")
    _check_schedule(weights, biases, schedule)
    bits = schedule[0][1].total_bits
    if any(fmt.total_bits != bits for _, fmt, _ in schedule):
        raise ValueError("the megakernel runs one container width per model")
    if len(schedule) > MAX_LAYERS:
        raise ValueError(f"the megakernel runs at most {MAX_LAYERS} layers")
    dtype = schedule[0][1].dtype
    dev = x.device
    x = _aligned16(_check_cuda("x", x, dtype, dev))
    weights = [_check_cuda(f"weights[{i}]", w, dtype, dev)
               for i, w in enumerate(weights)]
    biases = [_check_cuda(f"biases[{i}]", b, dtype, dev)
              for i, b in enumerate(biases)]
    dims = [int(x.shape[1])]
    for i, (w, b) in enumerate(zip(weights, biases)):
        if w.shape[0] != dims[-1] or b.shape != (w.shape[1],):
            raise ValueError(f"layer {i}: weight {tuple(w.shape)} / bias "
                             f"{tuple(b.shape)} do not follow width {dims[-1]}")
        dims.append(int(w.shape[1]))
    if mlp_smem_bytes(dims, bits) > SMEM_PER_BLOCK:
        raise ValueError(f"widths {dims} exceed one block's shared memory; "
                         f"route this model per layer")
    m = int(x.shape[0])
    out = torch.empty((m, dims[-1]), dtype=dtype, device=dev)
    if m == 0:
        return out
    epis = _schedule_params(tuple(schedule))
    n = len(schedule)
    c_dims = (ctypes.c_int * (n + 1))(*dims)
    c_ws = (ctypes.c_void_p * n)(*[w.data_ptr() for w in weights])
    c_bs = (ctypes.c_void_p * n)(*[b.data_ptr() for b in biases])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib()(x.data_ptr(), out.data_ptr(), m, n, c_dims, c_ws, c_bs,
                     epis.ctypes.data, bits, int(bm or 0), stream)
    if err != 0:
        raise RuntimeError(f"fxp_mlp_model kernel launch failed: CUDA error "
                           f"{err}")
    if count:
        fxp_mlp_model_cuda.launches += 1
    return out


fxp_mlp_model_cuda.launches = 0


# --------------------------------------------------------------------------
# kernel-SVM megakernel
# --------------------------------------------------------------------------
# The side of the first SVM body's two square int32 operand tiles (32 x 33
# with padding), frozen into the routing count below: no kernel runs this
# tile now, and the count keeps the models the predicates admit.
SVM_ROUTING_OPERAND_TILE = 32


def svm_smem_bytes(n_sv: int, bm: int = MODEL_BLOCK_M) -> int:
    """The SVM megakernels' routing count: what the first, single-block
    SVM body held in one block's shared memory — the (bm, S) int32
    kernel-value tile, the S + bm int32 squared norms and two 32 x 33 int32
    operand tiles (:data:`SVM_ROUTING_OPERAND_TILE`).  Both kernels now run the cluster body
    (``csrc/fxp_svm_body.cuh``), which splits the support vectors over a
    cluster of up to 8 blocks and needs less per block (``svm_plan``: at
    most 61 KB at S = 1696); the predicates keep this count, so the
    megakernel and the fleet take exactly the models they took before."""
    t = SVM_ROUTING_OPERAND_TILE
    return 4 * (bm * int(n_sv) + int(n_sv) + bm) + 2 * 4 * t * (t + 1)


def svm_fits_smem(n_sv: int, bm: int = MODEL_BLOCK_M) -> bool:
    """Whether the SVM megakernel takes a model of ``n_sv`` support vectors
    (at every container width: the tiles are int32): S <= 1696 at the
    default budget (:func:`svm_smem_bytes`)."""
    return svm_smem_bytes(n_sv, bm) <= smem_budget()


def _check_svm(kind: str, degree: int) -> None:
    if kind not in SVM_KERNELS:
        raise KeyError(f"kind must be one of {SVM_KERNELS}, got {kind!r}")
    if degree < 0:
        raise ValueError("degree must be a non-negative integer")


def fxp_svm_model_plain(qx: torch.Tensor, sv: torch.Tensor, dual: torch.Tensor,
                        icept: torch.Tensor, kind: str, fmt: FxpFormat,
                        out_fmt: FxpFormat, qgamma: int, qcoef0: int,
                        degree: int, dec_shift: int) -> torch.Tensor:
    """The megakernel's function in PyTorch ops: x . sv^T with an int32
    accumulator that wraps, requantized into ``fmt``; the kernel algebra;
    the decision ``k . dual`` with an int32 accumulator, requantized by
    ``dec_shift`` into ``out_fmt`` plus the saturating intercept."""
    _check_svm(kind, degree)
    dot = fxp.rshift_round_saturate(fxp.imatmul(qx, sv.T, torch.int32), fmt)
    k = svm_kernel_values(dot, qx, sv, kind, fmt, qgamma, qcoef0, degree)
    acc = fxp.imatmul(k, dual, torch.int32)
    return epilogue_plain(acc, icept[None, :], out_fmt, "none", dec_shift)


def _svm_lib():
    fn = build.load("fxp_svm_model").fxp_svm_model_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def fxp_svm_model_cuda(qx: torch.Tensor, sv: torch.Tensor, dual: torch.Tensor,
                       icept: torch.Tensor, kind: str, fmt: FxpFormat,
                       out_fmt: FxpFormat, qgamma: int, qcoef0: int,
                       degree: int, dec_shift: int, bm: Optional[int] = None,
                       count: bool = True) -> torch.Tensor:
    """Launch the CUDA megakernel.  qx (M, F), sv (S, F), dual (S, C),
    icept (C,), all in one container width on one CUDA device; returns
    (M, C) in ``out_fmt``'s container.  ``bm``: the cluster's rows (None:
    today's)."""
    if qx.device.type != "cuda":
        raise ValueError(f"fxp_svm_model_cuda needs CUDA tensors, got "
                         f"{qx.device}")
    _check_svm(kind, degree)
    if fmt.total_bits != out_fmt.total_bits:
        raise ValueError("the megakernel runs one container width per model")
    dtype, dev = fmt.dtype, qx.device
    qx = _check_cuda("qx", qx, dtype, dev)
    sv = _check_cuda("sv", sv, dtype, dev)
    dual = _check_cuda("dual", dual, dtype, dev)
    icept = _check_cuda("icept", icept, dtype, dev)
    (m, f), (s, c) = qx.shape, dual.shape
    if sv.shape != (s, f) or icept.shape != (c,):
        raise ValueError(f"shape mismatch: qx {tuple(qx.shape)}, sv "
                         f"{tuple(sv.shape)}, dual {tuple(dual.shape)}, "
                         f"icept {tuple(icept.shape)}")
    if min(f, s, c) == 0:
        raise ValueError("the SVM megakernel needs F, S and C >= 1")
    if svm_smem_bytes(s) > SMEM_PER_BLOCK:
        raise ValueError(f"{s} support vectors exceed one block's shared "
                         f"memory; route this model per layer")
    out = torch.empty((m, c), dtype=dtype, device=dev)
    if m == 0:
        return out
    epi_k = epilogue_params(fmt.frac_bits, fmt, "none")
    epi_out = epilogue_params(dec_shift, out_fmt, "none")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _svm_lib()(qx.data_ptr(), sv.data_ptr(), dual.data_ptr(),
                         icept.data_ptr(), out.data_ptr(), m, f, s, c,
                         fmt.total_bits, epi_k.ctypes.data, epi_out.ctypes.data,
                         SVM_KERNELS.index(kind), int(qgamma), int(qcoef0),
                         int(degree), int(bm or 0), stream)
    if err != 0:
        raise RuntimeError(f"fxp_svm_model kernel launch failed: CUDA error "
                           f"{err}")
    if count:
        fxp_svm_model_cuda.launches += 1
    return out


fxp_svm_model_cuda.launches = 0


# --------------------------------------------------------------------------
# fleet kernels: E stacked models, one launch
# --------------------------------------------------------------------------
# Model e's static layer plan at index e.
FleetSchedules = Tuple[LayerSchedule, ...]
# Model e's (fmt, out_fmt, qgamma, qcoef0, degree, dec_shift) at index e.
SvmFleetParams = Tuple[Tuple[FxpFormat, FxpFormat, int, int, int, int], ...]

MAX_MODELS = 65535  # kMaxModels in csrc/fxp_{mlp,svm}_fleet.cu (gridDim.y)
MLP_FLEET_REPLACES = "src/repro/kernels/fxp_model.py:448"  # fxp_mlp_fleet_pallas
SVM_FLEET_REPLACES = "src/repro/kernels/fxp_model.py:563"  # fxp_svm_fleet_pallas


def mlp_fleet_fits_smem(n_models: int, widths: Sequence[int], bits: int,
                        bm: int = MODEL_BLOCK_M) -> bool:
    """Whether the fleet kernel takes ``n_models`` stacked MLPs of
    ``widths``: one block runs one model, so its shared memory is the single
    model's (:func:`mlp_fits_smem`) whatever ``n_models`` is, up to the
    grid's model axis."""
    return 1 <= int(n_models) <= MAX_MODELS and mlp_fits_smem(widths, bits, bm)


def svm_fleet_fits_smem(n_models: int, n_sv: int,
                        bm: int = MODEL_BLOCK_M) -> bool:
    """Whether the fleet kernel takes ``n_models`` stacked kernel SVMs of
    ``n_sv`` support vectors: a cluster runs rows of one model with the
    single model's shared memory, so a fleet fits whenever one of its
    models does (:func:`svm_fits_smem`), up to the grid's model axis."""
    return 1 <= int(n_models) <= MAX_MODELS and svm_fits_smem(n_sv, bm)


def _check_fleet_schedules(weights, biases, schedules) -> int:
    """Validate per-model schedules; returns the shared container width."""
    if not schedules:
        raise ValueError("a fleet needs at least one model")
    n = len(schedules[0])
    if not (len(weights) == len(biases) == n >= 1):
        raise ValueError("weights/biases/schedules must align, >= 1 layer")
    bits = schedules[0][0][1].total_bits
    for sched in schedules:
        if len(sched) != n:
            raise ValueError("stacked models must share the layer count")
        _check_schedule(weights, biases, sched)
        if any(fmt.total_bits != bits for _, fmt, _ in sched):
            raise ValueError("stacked models must share the container")
    return bits


def fxp_mlp_fleet_plain(x: torch.Tensor, weights, biases,
                        schedules: FleetSchedules) -> torch.Tensor:
    """The fleet kernel's function in PyTorch ops: slot e is
    :func:`fxp_mlp_model_plain` of model e on ``x[e]``.  x (E, M, K0),
    weights[i] (E, K_i, K_{i+1}), biases[i] (E, K_{i+1}) -> (E, M, C)."""
    _check_fleet_schedules(weights, biases, schedules)
    if x.shape[0] != len(schedules):
        raise ValueError(f"{len(schedules)} schedules for {x.shape[0]} "
                         f"stacked models")
    return torch.stack([
        fxp_mlp_model_plain(x[e], [w[e] for w in weights],
                            [b[e] for b in biases], sched)
        for e, sched in enumerate(schedules)])


def _device_table(rows: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(rows, np.int64)).to(device)


@functools.lru_cache(maxsize=64)
def _mlp_fleet_table(schedules: FleetSchedules, device: str) -> torch.Tensor:
    return _device_table(np.stack([_schedule_params(s) for s in schedules]),
                         torch.device(device))


def mlp_fleet_table(schedules: FleetSchedules,
                    device: torch.device) -> torch.Tensor:
    """The (E, L, kEpilogueFields) int64 epilogue table of a fleet on
    ``device``: model e's schedule at row e.  Built once per (schedules,
    device) and cached, so a launch copies nothing to the card (the copy
    that builds it synchronizes; :func:`repro_torch.compile.stack_fleet`
    builds it ahead of traffic)."""
    return _mlp_fleet_table(tuple(tuple(s) for s in schedules), str(device))


def _mlp_fleet_lib():
    fn = build.load("fxp_mlp_fleet").fxp_mlp_fleet_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fxp_mlp_fleet_cuda(x: torch.Tensor, weights, biases,
                       schedules: FleetSchedules, bm: Optional[int] = None,
                       count: bool = True) -> torch.Tensor:
    """Launch the CUDA fleet kernel.  x (E, M, K0); weights[i] (E, K_i,
    K_{i+1}); biases[i] (E, K_{i+1}); every tensor on one CUDA device in the
    fleet's one container width; ``schedules[e]`` is model e's plan.
    Returns (E, M, K_L).  ``bm`` as for :func:`fxp_mlp_model_cuda`.  Does
    not synchronize."""
    if x.device.type != "cuda":
        raise ValueError(f"fxp_mlp_fleet_cuda needs CUDA tensors, got "
                         f"{x.device}")
    schedules = tuple(schedules)
    bits = _check_fleet_schedules(weights, biases, schedules)
    n = len(schedules[0])
    if n > MAX_LAYERS:
        raise ValueError(f"the megakernel runs at most {MAX_LAYERS} layers")
    dtype, dev = schedules[0][0][1].dtype, x.device
    x = _aligned16(_check_cuda("x", x, dtype, dev))
    weights = [_check_cuda(f"weights[{i}]", w, dtype, dev)
               for i, w in enumerate(weights)]
    biases = [_check_cuda(f"biases[{i}]", b, dtype, dev)
              for i, b in enumerate(biases)]
    e, m = int(x.shape[0]), int(x.shape[1])
    if e != len(schedules):
        raise ValueError(f"{len(schedules)} schedules for {e} stacked models")
    dims = [int(x.shape[2])]
    for i, (w, b) in enumerate(zip(weights, biases)):
        if w.shape[:2] != (e, dims[-1]) or b.shape != (e, w.shape[2]):
            raise ValueError(f"layer {i}: weight {tuple(w.shape)} / bias "
                             f"{tuple(b.shape)} do not follow ({e}, "
                             f"{dims[-1]}, .)")
        dims.append(int(w.shape[2]))
    if mlp_smem_bytes(dims, bits) > SMEM_PER_BLOCK or e > MAX_MODELS:
        raise ValueError(f"a fleet of {e} models of widths {dims} does not "
                         f"fit the kernel")
    out = torch.empty((e, m, dims[-1]), dtype=dtype, device=dev)
    if m == 0:
        return out
    table = mlp_fleet_table(schedules, dev)
    c_dims = (ctypes.c_int * (n + 1))(*dims)
    c_ws = (ctypes.c_void_p * n)(*[w.data_ptr() for w in weights])
    c_bs = (ctypes.c_void_p * n)(*[b.data_ptr() for b in biases])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _mlp_fleet_lib()(x.data_ptr(), out.data_ptr(), m, e, n, c_dims,
                               c_ws, c_bs, table.data_ptr(), bits,
                               int(bm or 0), stream)
    if err != 0:
        raise RuntimeError(f"fxp_mlp_fleet kernel launch failed: CUDA error "
                           f"{err}")
    if count:
        fxp_mlp_fleet_cuda.launches += 1
    return out


fxp_mlp_fleet_cuda.launches = 0


def _check_svm_fleet(kind: str, params) -> int:
    """Validate per-model SVM params; returns the shared container width."""
    if kind not in SVM_KERNELS:
        raise KeyError(f"kind must be one of {SVM_KERNELS}, got {kind!r}")
    if not params:
        raise ValueError("a fleet needs at least one model")
    bits = params[0][0].total_bits
    for fmt, out_fmt, _, _, degree, _ in params:
        _check_svm(kind, degree)
        if fmt.total_bits != bits or out_fmt.total_bits != bits:
            raise ValueError("stacked models must share the container")
    return bits


def fxp_svm_fleet_plain(qx: torch.Tensor, sv: torch.Tensor,
                        dual: torch.Tensor, icept: torch.Tensor, kind: str,
                        params: SvmFleetParams) -> torch.Tensor:
    """The fleet kernel's function in PyTorch ops: slot e is
    :func:`fxp_svm_model_plain` of model e on ``qx[e]``.  qx (E, M, F),
    sv (E, S, F), dual (E, S, C), icept (E, C) -> (E, M, C)."""
    _check_svm_fleet(kind, params)
    if qx.shape[0] != len(params):
        raise ValueError(f"{len(params)} param tuples for {qx.shape[0]} "
                         f"stacked models")
    return torch.stack([
        fxp_svm_model_plain(qx[e], sv[e], dual[e], icept[e], kind, *p)
        for e, p in enumerate(params)])


@functools.lru_cache(maxsize=64)
def _svm_fleet_table(params: SvmFleetParams, device: str) -> torch.Tensor:
    rows = [np.concatenate([epilogue_params(fmt.frac_bits, fmt, "none"),
                            epilogue_params(dec_shift, out_fmt, "none"),
                            np.asarray([degree, qgamma, qcoef0], np.int64)])
            for fmt, out_fmt, qgamma, qcoef0, degree, dec_shift in params]
    return _device_table(np.stack(rows), torch.device(device))


def svm_fleet_table(params: SvmFleetParams,
                    device: torch.device) -> torch.Tensor:
    """The (E, 2 * 21 + 3) int64 parameter table of an SVM fleet
    on ``device`` (``fxp::svm_params_from``): model e's kernel-domain and
    decision epilogues, degree, q(gamma) and q(coef0) at row e.  Cached per
    (params, device), like :func:`mlp_fleet_table`."""
    params = tuple((p[0], p[1], int(p[2]), int(p[3]), int(p[4]), int(p[5]))
                   for p in params)
    return _svm_fleet_table(params, str(device))


def _svm_fleet_lib():
    fn = build.load("fxp_svm_fleet").fxp_svm_fleet_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def fxp_svm_fleet_cuda(qx: torch.Tensor, sv: torch.Tensor, dual: torch.Tensor,
                       icept: torch.Tensor, kind: str,
                       params: SvmFleetParams, bm: Optional[int] = None,
                       count: bool = True) -> torch.Tensor:
    """Launch the CUDA fleet kernel.  qx (E, M, F), sv (E, S, F), dual
    (E, S, C), icept (E, C), all in the fleet's one container width on one
    CUDA device; ``params[e]`` is model e's (fmt, out_fmt, qgamma, qcoef0,
    degree, dec_shift).  Returns (E, M, C).  ``bm`` as for
    :func:`fxp_svm_model_cuda`.  Does not synchronize."""
    if qx.device.type != "cuda":
        raise ValueError(f"fxp_svm_fleet_cuda needs CUDA tensors, got "
                         f"{qx.device}")
    params = tuple(tuple(p) for p in params)
    bits = _check_svm_fleet(kind, params)
    dtype, dev = params[0][0].dtype, qx.device
    qx = _check_cuda("qx", qx, dtype, dev)
    sv = _check_cuda("sv", sv, dtype, dev)
    dual = _check_cuda("dual", dual, dtype, dev)
    icept = _check_cuda("icept", icept, dtype, dev)
    (e, m, f), (s, c) = qx.shape, dual.shape[1:]
    if (len(params) != e or sv.shape != (e, s, f) or dual.shape != (e, s, c)
            or icept.shape != (e, c)):
        raise ValueError(f"shape mismatch for {len(params)} models: qx "
                         f"{tuple(qx.shape)}, sv {tuple(sv.shape)}, dual "
                         f"{tuple(dual.shape)}, icept {tuple(icept.shape)}")
    if min(f, s, c) == 0:
        raise ValueError("the SVM fleet kernel needs F, S and C >= 1")
    if svm_smem_bytes(s) > SMEM_PER_BLOCK or e > MAX_MODELS:
        raise ValueError(f"a fleet of {e} models of {s} support vectors does "
                         f"not fit the kernel")
    out = torch.empty((e, m, c), dtype=dtype, device=dev)
    if m == 0:
        return out
    table = svm_fleet_table(params, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _svm_fleet_lib()(qx.data_ptr(), sv.data_ptr(), dual.data_ptr(),
                               icept.data_ptr(), out.data_ptr(), m, f, s, c,
                               e, bits, SVM_KERNELS.index(kind),
                               table.data_ptr(), int(bm or 0), stream)
    if err != 0:
        raise RuntimeError(f"fxp_svm_fleet kernel launch failed: CUDA error "
                           f"{err}")
    if count:
        fxp_svm_fleet_cuda.launches += 1
    return out


fxp_svm_fleet_cuda.launches = 0
